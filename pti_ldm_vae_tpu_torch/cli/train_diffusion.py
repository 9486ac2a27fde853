"""Latent-diffusion training CLI (counterpart of
``pti_ldm_vae_tpu/cli/train_diffusion.py``). Runs on CUDA unless ``--device
cpu`` is given.

Pipeline per batch: the frozen VAE encodes the images once (no gradient):
the latents are ``z_mu + z_sigma * eps`` (``encode_stage_2_inputs``) and,
with conditioning, ``z_mu`` (``encode_deterministic``) is projected to the
cross-attention context; the UNet learns epsilon prediction on the latents
(masked mean of the per-sample MSE), then one Adam update of the UNet and
projector (``optax.adam`` defaults: b1 0.9, b2 0.999, eps 1e-8; fused on
CUDA). The encoder noise, the timesteps and the noise come from one seeded
``torch.Generator`` on the device. After every epoch
``<run_dir>/trained_weights/diffusion_last.pth`` is written atomically: the
MONAI-keyed ``unet`` state dict and the ``projector`` state dict, which
``sample_diffusion`` reads.

    python -m pti_ldm_vae_tpu_torch.cli.train_diffusion -c config/ldm_dente.json \\
        --input-dir data/ [--f32] [--device cpu]

Data parallel under torchrun (``torchrun --nproc_per_node N -m
pti_ldm_vae_tpu_torch.cli.train_diffusion ...``): each rank takes its
``rank::world`` share of the images, ``batch_size`` rows per step (the
global batch is N x ``batch_size``), draws its rows of the global batch's
encoder noise, timesteps and noise, and the gradients are summed before the
update. The LR is not scaled, as the JAX CLI's ``optax.adam(lr)`` over its
global batch is not. Rank 0 writes the checkpoint and the metrics.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch
from torch import nn

from ..checkpoint.manager import _cpu, save_atomic
from ..config import load_config
from ..data.datasets import list_tif_paths
from ..data.loader import ShardedDataLoader
from ..parallel.mesh import barrier_sync, broadcast_module
from ..train.diffusion import make_diffusion_train_step
from ..train.state import create_train_state
from ..utils.cli_common import (
    init_device_and_seed,
    join_process_group,
    load_ldm_models,
    resolve_device,
)
from ..utils.logging import MetricLogger

__all__ = ["main"]

CHECKPOINT_NAME = "diffusion_last.pth"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train a latent diffusion UNet (PyTorch/CUDA).")
    parser.add_argument("-c", "--config-file", required=True, help="LDM config JSON")
    parser.add_argument("--input-dir", required=True, help="Training image directory")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num-samples", type=int, default=None)
    parser.add_argument("--remat", action="store_true",
                        help="Activation checkpointing on the UNet (same as top-level "
                             "\"remat\": true): its ResBlocks and transformers are "
                             "recomputed in the backward instead of kept")
    parser.add_argument("--f32", action="store_true",
                        help="f32 compute with TF32 off (parity runs)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent CPU fallback")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    rank, world = join_process_group(device)
    cfg = load_config(args.config_file)
    gen = init_device_and_seed(args.seed, device)
    run_dir = Path(cfg.get("run_dir", "./runs/ldm"))
    weights_dir = run_dir / "trained_weights"
    if rank == 0:
        weights_dir.mkdir(parents=True, exist_ok=True)

    m = load_ldm_models(cfg, device=device, exact=args.f32, remat=args.remat)
    train_cfg = cfg["diffusion_train"]
    batch_size = args.batch_size or int(train_cfg["batch_size"])
    max_epochs = args.max_epochs or int(train_cfg["max_epochs"])
    patch_size = tuple(m.vae_config.autoencoder_train["patch_size"])

    paths = list_tif_paths(args.input_dir, data_source="both")[:args.num_samples]
    # the DistributedSampler schedule: every rank the same number of batches
    loader = ShardedDataLoader(paths, patch_size, batch_size, rank=rank, world=world,
                               num_workers=args.num_workers)
    if rank == 0:
        print(f"[INFO] {len(paths)} training images")

    trainable = nn.ModuleDict({"unet": m.unet})
    if m.projector is not None:
        trainable["projector"] = m.projector
    broadcast_module(trainable)
    state = create_train_state(trainable, lr=float(train_cfg["lr"]))
    step = make_diffusion_train_step(m.unet, m.schedule, state, projector=m.projector)

    logger = MetricLogger(str(run_dir), rank=rank, wandb_cfg=cfg.get("wandb", {"enabled": False}))
    total_step, mean_loss = 0, 0.0
    try:
        for epoch in range(max_epochs):
            loader.set_epoch(epoch)
            # the loss sums on the device: one host read per epoch, none per step
            epoch_loss, n = None, 0
            for batch in loader:
                images = torch.from_numpy(batch["image"]).to(device, non_blocking=True)
                mask = torch.from_numpy(batch["mask"]).to(device, non_blocking=True)
                with torch.no_grad():
                    z_mu, z_sigma = m.vae.encode(images)
                    latents = m.vae.sampling(z_mu, z_sigma, generator=gen)
                loss = step(latents, z_mu if m.projector is not None else None, mask, generator=gen)
                epoch_loss = loss if epoch_loss is None else epoch_loss + loss
                n += 1
                total_step += 1
            mean_loss = float(epoch_loss) / max(n, 1) if epoch_loss is not None else 0.0
            logger.log({"train/eps_mse": mean_loss, "epoch": epoch}, step=total_step)
            if rank == 0:
                print(f"Epoch {epoch}: eps-MSE {mean_loss:.5f}")
                save_atomic({"unet": _cpu(m.unet.state_dict()),
                             "projector": _cpu(m.projector.state_dict())
                             if m.projector is not None else None},
                            str(weights_dir / CHECKPOINT_NAME))
            barrier_sync("checkpoint")
    finally:
        loader.close()
        logger.finish()
    return {"final_loss": mean_loss, "weights_dir": str(weights_dir), "total_step": total_step,
            "checkpoint": str(weights_dir / CHECKPOINT_NAME)}


if __name__ == "__main__":
    main()
