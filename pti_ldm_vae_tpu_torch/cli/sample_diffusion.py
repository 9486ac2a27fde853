"""DDIM sampling CLI: trained UNet -> latents -> frozen VAE decode -> images
(counterpart of ``pti_ldm_vae_tpu/cli/sample_diffusion.py``). Runs on CUDA
unless ``--device cpu`` is given.

With conditioning, the first ``--num-images`` images of ``--condition-dir``
(zero-padded to ``--num-images``, as the JAX loader pads) are encoded to
``z_mu`` by the frozen VAE and projected to the cross-attention context;
otherwise sampling is unconditional. The initial noise comes from a
``torch.Generator`` seeded with ``--seed``. The UNet and projector weights
are the ``.pth`` that ``train_diffusion`` writes, or that
``tools/export_jax_checkpoint.py diffusion`` writes beside an orbax directory
of the JAX package (``--checkpoint`` may name either path). Writes ``sample_XXX.tif`` (float) and
``sample_XXX.png`` (display-normalized).

Under torchrun (``torchrun --nproc_per_node N -m
pti_ldm_vae_tpu_torch.cli.sample_diffusion ...``) the samples are split over
the ranks as the JAX CLI splits them over its mesh: every rank draws the
whole ``[num_images, ...]`` initial noise (and, with ``eta`` > 0, each step's
noise) from the seeded generator, keeps rows ``rank::world`` with their
conditions, denoises and decodes them, and writes them under their global
index, so N ranks write the files one rank writes. The ranks do not talk.

    python -m pti_ldm_vae_tpu_torch.cli.sample_diffusion -c config/ldm_dente.json \\
        --checkpoint runs/ldm_dente/trained_weights/diffusion_last.pth \\
        --condition-dir data/ [--f32] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..checkpoint.unet_convert import load_diffusion_checkpoint
from ..config import load_config
from ..data.factory import create_vae_inference_dataloader
from ..data.io import write_png, write_tif
from ..models.unet import project_latent_condition
from ..parallel.mesh import own_rows, process_rank
from ..train.diffusion import ddim_sample
from ..utils.cli_common import (
    init_device_and_seed,
    join_process_group,
    load_ldm_models,
    resolve_device,
)
from ..utils.visualization import normalize_batch_for_display

__all__ = ["main"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Sample images with DDIM (PyTorch/CUDA).")
    parser.add_argument("-c", "--config-file", required=True, help="LDM config JSON")
    parser.add_argument("--checkpoint", required=True,
                        help="Diffusion checkpoint (.pth written by train_diffusion, or "
                             "PATH where PATH.pth exists)")
    parser.add_argument("--output-dir", default="ddim_samples")
    parser.add_argument("--num-images", type=int, default=8)
    parser.add_argument("--num-inference-steps", type=int, default=None)
    parser.add_argument("--condition-dir", default=None,
                        help="Images whose latents condition the sampler")
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--f32", action="store_true",
                        help="f32 compute with TF32 off (parity runs)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent CPU fallback")
    return parser.parse_args(argv)


def main(argv=None) -> Path:
    args = parse_args(argv)
    device = resolve_device(args.device)
    join_process_group(device)
    cfg = load_config(args.config_file)
    gen = init_device_and_seed(args.seed, device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    unet_sd, projector_sd = load_diffusion_checkpoint(args.checkpoint)
    m = load_ldm_models(cfg, device=device, exact=args.f32)
    if m.vae.spatial_dims != 2:
        # the condition images and the dump are 2-D (``[i, :, :, 0]``): volumes are refused
        raise NotImplementedError(
            f"sample_diffusion supports spatial_dims=2 VAEs only (got spatial_dims="
            f"{m.vae.spatial_dims})")
    m.unet.load_state_dict(unet_sd, strict=True)
    m.unet.requires_grad_(False).eval()
    sampling = cfg.get("sampling", {})
    steps = args.num_inference_steps or int(sampling.get("num_inference_steps", 50))
    eta = float(sampling.get("eta", 0.0))

    n = args.num_images
    rows = own_rows(n)
    if not rows:
        raise ValueError(f"--num-images {n} leaves rank {process_rank()} "
                         "no sample: launch at most that many ranks")
    context = None
    if m.projector is not None:
        if args.condition_dir is None:
            raise ValueError("with_conditioning=true requires --condition-dir")
        if projector_sd is None:
            raise KeyError(f"{args.checkpoint}: the config conditions the UNet but the "
                           "checkpoint holds no projector")
        m.projector.load_state_dict(projector_sd, strict=True)
        m.projector.requires_grad_(False)
        loader, _ = create_vae_inference_dataloader(
            args.condition_dir, tuple(m.vae_config.autoencoder_train["patch_size"]),
            args.num_images, num_samples=args.num_images, num_workers=args.num_workers)
        try:
            batch = next(iter(loader))
        finally:
            loader.close()
        with torch.no_grad():
            cond = m.vae.encode_deterministic(torch.from_numpy(batch["image"][rows]).to(device))
            context = project_latent_condition(m.projector, cond)

    # the draws of all n rows, in the order one process makes them: the initial
    # noise, then (eta > 0) one [n, ...] draw per step; this rank keeps its rows
    noise = torch.randn((n, *m.latent_shape), generator=gen, dtype=torch.float32, device=device)
    step_noise = [torch.randn(noise.shape, generator=gen, dtype=torch.float32, device=device)[rows]
                  for _ in range(steps)] if eta > 0 else None
    with torch.no_grad():
        latents = ddim_sample(m.unet, m.schedule, noise[rows], num_inference_steps=steps,
                              context=context, eta=eta, step_noise=step_noise)
        images = m.vae.decode_stage_2_outputs(latents).cpu().numpy()
    disp = normalize_batch_for_display(images)
    for k, i in enumerate(rows):
        write_tif(str(out_dir / f"sample_{i:03d}.tif"), images[k, :, :, 0])
        write_png(str(out_dir / f"sample_{i:03d}.png"), (disp[k, :, :, 0] * 255).astype(np.uint8))
    print(f"Wrote {len(rows)} samples to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
