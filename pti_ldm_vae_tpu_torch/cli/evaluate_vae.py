"""VAE evaluation CLI: stochastic forward + full metric suite -> metrics.json.

Counterpart of ``pti_ldm_vae_tpu/cli/evaluate_vae.py`` (workload parity with
``vae_scripts/evaluate_vae.py``): per batch — stochastic forward,
recon/KL/perceptual losses; per sample — PSNR/SSIM/MSE/MAE on [0,1]-clamped
images; aggregate mean/std written to ``metrics.json``. The reference composes
``loss_total`` without ``kl_weight`` here (KL at weight 1.0,
``evaluate_vae.py:100``); reproduced for parity. Runs on CUDA unless
``--device cpu`` is given.

    python -m pti_ldm_vae_tpu_torch.cli.evaluate_vae -c config/vae_dente_no_adv.json \\
        --checkpoint vae.pth --input-dir data/ --output-dir evals/ [--f32] [--conv-kernel] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..models.lpips import (
    load_lpips_params,
    lpips_distance_per_sample,
    lpips_distance_per_sample_3d,
    lpips_is_pretrained,
)
from ..utils.cli_common import (
    add_shared_io_args,
    build_inference_dataloader,
    init_device_and_seed,
    load_config_and_model,
    resolve_device,
    resolve_eval_output_dir,
    serialize_args,
)
from ..utils.eval_metrics import compute_mae, compute_mse, compute_psnr, compute_ssim

__all__ = ["main", "evaluate"]

_BATCH_METRICS = ("recon_loss", "kl_loss", "perceptual_loss", "loss_total")
_SAMPLE_METRICS = ("psnr", "ssim", "mse", "mae")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Evaluate a trained VAE on a test set (PyTorch/CUDA).")
    add_shared_io_args(
        parser, output_help="Output directory for metrics (default: evals/<config_name>/)"
    )
    parser.add_argument("--f32", action="store_true",
                        help="Exact f32 numerics (f32 compute, TF32 off) — the "
                             "numerics reference-parity is measured under")
    parser.add_argument("--conv-kernel", action="store_true",
                        help="3x3 stride-1 convolutions through the hand-written "
                             "convolution kernels instead of cuDNN")
    return parser.parse_args(argv)


def _masked_mean(per_sample: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(per_sample * mask) / torch.clamp(mask.sum(), min=1.0)


def evaluate_batch(model, images: torch.Tensor, mask: torch.Tensor, *, recon_kind: str,
                   perceptual_weight: float, lpips_params, eps: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """One batch's metrics: the four loss terms as masked means (zero-padded
    rows never contaminate them), PSNR/SSIM/MSE/MAE per sample."""
    with torch.no_grad():
        recon, z_mu, z_sigma = model(images, eps, generator)
        recon_c, images_c = recon.clamp(0.0, 1.0), images.clamp(0.0, 1.0)
        diff = recon.float() - images.float()
        per = diff.abs() if recon_kind != "l2" else diff.square()
        intensity = _masked_mean(per.mean(dim=tuple(range(1, per.dim()))), mask)
        sec = z_sigma.float()
        # the reference objective: sigma in the log-variance slot
        kl_ps = -0.5 * torch.sum(1.0 + sec - z_mu.float().square() - torch.exp(sec),
                                 dim=tuple(range(1, sec.dim())))
        kl = _masked_mean(kl_ps, mask)
        # 5-D (NDHWC) reconstructions take the fake-3D slicing path
        lpips_fn = lpips_distance_per_sample_3d if recon.dim() == 5 else lpips_distance_per_sample
        perc = _masked_mean(lpips_fn(lpips_params, recon, images), mask)
        return {
            "recon_loss": intensity,
            "kl_loss": kl,
            "perceptual_loss": perc,
            "loss_total": intensity + kl + perceptual_weight * perc,  # no kl_weight (parity)
            "psnr": compute_psnr(recon_c, images_c),
            "ssim": compute_ssim(recon_c, images_c),
            "mse": compute_mse(recon_c, images_c),
            "mae": compute_mae(recon_c, images_c),
        }


def evaluate(model, dataloader, *, recon_kind: str, perceptual_weight: float, lpips_params,
             generator: torch.Generator | None = None, eps=None) -> dict[str, float]:
    """Mean and std of every metric over ``dataloader``: the loss terms over
    batches, the image metrics over valid samples. The posterior noise of
    each batch is the next item of ``eps`` when given, else drawn from
    ``generator``."""
    device = next(model.parameters()).device
    metrics: dict[str, list[float]] = {k: [] for k in _BATCH_METRICS + _SAMPLE_METRICS}
    noise = iter(eps) if eps is not None else None
    for batch in dataloader:
        images = torch.from_numpy(batch["image"]).to(device)
        mask = torch.from_numpy(batch["mask"]).to(device)
        out = evaluate_batch(model, images, mask, recon_kind=recon_kind,
                             perceptual_weight=perceptual_weight, lpips_params=lpips_params,
                             eps=next(noise).to(device) if noise is not None else None,
                             generator=generator)
        valid = int(batch["mask"].sum())
        for name in _BATCH_METRICS:
            metrics[name].append(float(out[name]))
        for name in _SAMPLE_METRICS:
            metrics[name].extend(out[name][:valid].cpu().tolist())

    summary: dict[str, float] = {}
    for name, values in metrics.items():
        if values:
            summary[f"{name}_mean"] = float(np.mean(values))
            summary[f"{name}_std"] = float(np.std(values))
    return summary


def main(argv=None) -> dict[str, float]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    generator = init_device_and_seed(args.seed, device)
    config, model = load_config_and_model(
        args.config_file, args.checkpoint, device=device, exact=args.f32,
        conv_kernel=args.conv_kernel,
    )
    output_dir = resolve_eval_output_dir(args.config_file, args.output_dir)
    dataloader, image_paths = build_inference_dataloader(
        input_dir=args.input_dir, config=config, batch_size=args.batch_size,
        num_samples=args.num_samples, num_workers=args.num_workers,
    )
    print(f"[INFO] Found {len(image_paths)} images in {args.input_dir}")
    lpips_params = load_lpips_params(device=device)
    try:
        summary = evaluate(
            model, dataloader,
            recon_kind=config.autoencoder_train.get("recon_loss", "l1"),
            perceptual_weight=config.autoencoder_train["perceptual_weight"],
            lpips_params=lpips_params, generator=generator,
        )
    finally:
        dataloader.close()
    payload = {
        "args": serialize_args(args),
        "metrics": summary,
        "perceptual_pretrained": lpips_is_pretrained(lpips_params),
        "files": image_paths,
    }
    with open(Path(output_dir) / "metrics.json", "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2)
    print("\n=== Evaluation Summary ===")
    for name, value in summary.items():
        print(f"{name}: {value:.4f}")
    print(f"\nMetrics saved to {Path(output_dir) / 'metrics.json'}")
    return summary


if __name__ == "__main__":
    main()
