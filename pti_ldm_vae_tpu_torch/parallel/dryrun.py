"""The port's counterpart of ``__graft_entry__.dryrun_multichip``: the full
training step over a ``data x model`` mesh of ``n`` ranks, once with image
height on the model axis and once with channels, then the LDM stage data
parallel.

    python -m pti_ldm_vae_tpu_torch.parallel.dryrun N [--device cuda|cpu]

starts ``n`` ranks (processes) on this host: gloo on the CPU; on CUDA, NCCL
with a card per rank where there are ``n`` cards, else gloo with every rank
on the first card (the collectives of ``parallel/`` are all-reduces, which
gloo runs on CUDA tensors). As in the JAX function the model axis is 2 where
``n`` is even and at least 4, else 1 (data parallel only). Each rank:

1. dp x sp: the toy VAE (``channels (8, 16)``, ``attention_levels (False,
   True)``, ``s2d_stem "encoder"``) with a PatchGAN (8 channels, 2 layers),
   LPIPS, the adversarial terms and the AR-VAE term, one train step on a
   global batch of ``2n`` seeded 32² images, height sharded;
2. dp x tp: the same weights and batch, channels sharded, the same step; its
   total loss is held to stage 1's at rtol 2e-4 / atol 1e-5
   (``__graft_entry__.py:180``);
3. the LDM stage with no model axis: one diffusion train step (eps-MSE),
   4 DDIM steps on each rank's rows of 8 samples and the batched PTI on one
   image a rank.

Rank 0 prints one line per stage. Exit code 0 when every rank finished.
"""

from __future__ import annotations

import argparse
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["dryrun_multichip", "main"]

HW = 32
TOY = dict(in_channels=1, out_channels=1, latent_channels=4, channels=(8, 16), num_res_blocks=1,
           norm_num_groups=4, attention_levels=(False, True), with_encoder_nonlocal_attn=True,
           with_decoder_nonlocal_attn=True, s2d_stem="encoder")
RTOL, ATOL = 2e-4, 1e-5


def _models(device: torch.device):
    """The toy VAE and PatchGAN, from the same seeds on every rank."""
    from ..models.autoencoder_kl import AutoencoderKL
    from ..models.discriminator import PatchDiscriminator

    torch.manual_seed(0)
    model = AutoencoderKL(**TOY).to(device=device, memory_format=torch.channels_last)
    disc = PatchDiscriminator(channels=8, num_layers_d=2,
                              generator=torch.Generator().manual_seed(2)).to(device)
    return model, disc


def _gan_step(kind: str | None, model_par: int, device: torch.device, batch: dict) -> float:
    """One adversarial train step (VAE-GAN + LPIPS + AR-VAE, both Adams) on
    this rank's rows under a mesh of ``kind``; the global total loss."""
    from ..losses.ar_vae import make_ar_vae_spec
    from ..models.lpips import init_lpips_params
    from .mesh import data_rank, data_size, make_mesh, set_mesh
    from .spatial import shard_batch_spatial
    from .tensor import tensor_parallel_params
    from ..train.state import create_train_state
    from ..train.steps import LossConfig, make_train_step

    if kind is not None:
        make_mesh(kind, model_par)
    try:
        model, disc = _models(device)
        if kind == "tensor":
            tensor_parallel_params(model)
            tensor_parallel_params(disc)
        state = create_train_state(model, lr=1e-4, world_size=data_size(), model_d=disc)
        spec = make_ar_vae_spec({"height_0": {"latent_channel": 0, "delta": 1.0}},
                                pairwise_mode="all")
        lcfg = LossConfig(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0,
                          adv_weight=0.5, ar_gamma=0.5, ar_vae_enabled=True, ar_spec=spec)
        rows = slice(data_rank(), None, data_size())
        local = {"image": batch["image"][rows], "mask": batch["mask"][rows]}
        if kind == "spatial":
            local = shard_batch_spatial(local)
        step = make_train_step(model, disc, lcfg, adv_active=True)
        _, metrics = step(state, torch.from_numpy(local["image"]).to(device),
                          torch.from_numpy(local["mask"]).to(device),
                          {"height_0": torch.from_numpy(batch["height_0"][rows]).to(device)},
                          init_lpips_params(0, device), generator=torch.Generator(
                              device=device).manual_seed(3))
        total = float(metrics["train/loss_total"])
    finally:
        set_mesh(None)
    if not np.isfinite(total):
        raise RuntimeError(f"dryrun ({kind}): loss {total}")
    return total


def _ldm_stage(device: torch.device, n: int) -> tuple[float, bool]:
    """The diffusion train step, DDIM and batched PTI, data parallel."""
    from ..models.unet import DiffusionUNet
    from ..train.diffusion import (
        NoiseSchedule,
        ddim_sample,
        make_diffusion_train_step,
        make_pivotal_tuning_inversion_batched,
    )
    from ..train.state import create_train_state
    from .mesh import own_rows, world_size

    torch.manual_seed(5)
    unet = DiffusionUNet(in_channels=4, out_channels=4, channels=(8, 16),
                         attention_levels=(False, True), num_head_channels=(0, 8),
                         num_res_blocks=1, norm_num_groups=4, with_conditioning=False,
                         cross_attention_dim=None).to(device)
    schedule = NoiseSchedule.linear_beta().to(device)
    rng = np.random.default_rng(1)
    latents = torch.from_numpy(rng.normal(size=(2 * n, HW // 2, HW // 2, 4)).astype(np.float32))
    gen = torch.Generator(device=device).manual_seed(6)
    step = make_diffusion_train_step(unet, schedule, create_train_state(unet, lr=1e-4,
                                                                        world_size=world_size()))
    rows = own_rows(2 * n)
    loss = float(step(latents[rows].to(device), generator=gen))
    noise = torch.from_numpy(rng.normal(size=(8, HW // 2, HW // 2, 4)).astype(np.float32))
    with torch.no_grad():
        samples = ddim_sample(lambda x, t, c: unet(x, t, c), schedule,
                              noise[own_rows(8)].to(device), num_inference_steps=4)
    model, _ = _models(device)
    targets = torch.from_numpy(rng.uniform(0.1, 1.0, size=(n, HW, HW, 1)).astype(np.float32))
    mine = targets[own_rows(n)].to(device)
    with torch.no_grad():
        z_init = model.encode_deterministic(mine)
    _, _, losses = make_pivotal_tuning_inversion_batched(model, latent_steps=2, tune_steps=1)(
        mine, z_init)
    finite = bool(torch.isfinite(samples).all()) and bool(torch.isfinite(losses["latent"]).all())
    return loss, finite


def _rank(rank: int, n: int, port: int, device_kind: str) -> None:
    nccl = device_kind == "cuda" and torch.cuda.device_count() >= n
    device = torch.device("cuda", rank if nccl else 0) if device_kind == "cuda" else torch.device(
        "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if nccl else "gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    try:
        model_par = 2 if n % 2 == 0 and n >= 4 else 1
        rng = np.random.default_rng(0)
        batch = {"image": rng.uniform(0.1, 1.0, size=(2 * n, HW, HW, 1)).astype(np.float32),
                 "mask": np.ones((2 * n,), np.float32),
                 "height_0": rng.normal(size=(2 * n,)).astype(np.float32)}
        total = _gan_step("spatial" if model_par > 1 else None, model_par, device, batch)
        if rank == 0:
            print(f"dryrun_multichip({n}): ok, dp x sp ({n // model_par} x {model_par}), "
                  f"loss={total:.6f}", flush=True)
        tp_total = _gan_step("tensor" if model_par > 1 else None, model_par, device, batch)
        np.testing.assert_allclose(tp_total, total, rtol=RTOL, atol=ATOL)
        if rank == 0:
            print(f"dryrun_multichip({n}): tensor-parallel stage ok, loss={tp_total:.6f}",
                  flush=True)
        diff_loss, finite = _ldm_stage(device, n)
        if not (np.isfinite(diff_loss) and finite):
            raise RuntimeError(f"LDM stage: diffusion loss {diff_loss}, DDIM / PTI finite {finite}")
        if rank == 0:
            print(f"dryrun_multichip({n}): LDM stage ok (diffusion loss={diff_loss:.4f}, "
                  f"ddim+pti finite)", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cuda") -> None:
    """Run the three stages on ``n`` ranks of this host (module docstring);
    raises if any rank fails."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun on cuda: no CUDA device")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.start_processes(_rank, args=(n, port, device), nprocs=n, join=True, start_method="spawn")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, help="ranks (processes) to start")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                        help="cuda (the default) or cpu: no silent CPU run")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
