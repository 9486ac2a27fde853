"""VAE inference CLI: deterministic encode->decode, TIF + PNG dumps.

Counterpart of ``pti_ldm_vae_tpu/cli/inference_vae.py`` (workload parity with
the reference ``vae_scripts/inference_vae.py``): each input image is
reconstructed from ``z_mu`` (no sampling) and saved as an ``[original |
reconstruction]`` float TIF plus a percentile-normalized PNG. Runs on CUDA
unless ``--device cpu`` is given.

    python -m pti_ldm_vae_tpu_torch.cli.inference_vae -c config/vae_dente_no_adv.json \\
        --checkpoint vae.pth --input-dir data/ --output-dir out/ [--f32] [--conv-kernel] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.io import write_png, write_tif
from ..train.steps import make_inference_fn
from ..utils.cli_common import (
    add_shared_io_args,
    build_inference_dataloader,
    init_device_and_seed,
    load_config_and_model,
    resolve_device,
    resolve_inference_output_dirs,
)
from ..utils.visualization import normalize_batch_for_display

__all__ = ["main", "run_inference", "save_results"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="VAE Inference Script (PyTorch/CUDA)")
    add_shared_io_args(
        parser, output_help="Output directory (default: inference_<checkpoint_name>)"
    )
    parser.add_argument("--f32", action="store_true",
                        help="Exact f32 numerics (f32 compute, TF32 off) — the "
                             "numerics reference-parity is measured under")
    parser.add_argument("--conv-kernel", action="store_true",
                        help="3x3 stride-1 convolutions through the hand-written "
                             "convolution kernels instead of cuDNN")
    return parser.parse_args(argv)


def save_results(idx: int, input_img: np.ndarray, recon_img: np.ndarray,
                 out_tif: Path, out_png: Path) -> None:
    """[orig | recon] TIF + display-normalized PNG
    (reference ``inference_vae.py:35-58``). Inputs are [H, W]."""
    concat_tif = np.concatenate([input_img, recon_img], axis=1)
    write_tif(str(out_tif / f"image{idx:04d}.tif"), concat_tif)

    input_disp = normalize_batch_for_display(input_img[None, :, :, None])[0, :, :, 0]
    recon_disp = normalize_batch_for_display(recon_img[None, :, :, None])[0, :, :, 0]
    concat_png = np.concatenate([input_disp, recon_disp], axis=1)
    write_png(str(out_png / f"image{idx:04d}.png"), (concat_png * 255).astype(np.uint8))


def run_inference(model, dataloader, out_tif: Path, out_png: Path) -> int:
    reconstruct = make_inference_fn(model)
    img_idx = 0
    for batch in dataloader:
        recon = reconstruct(batch["image"]).cpu().numpy()
        images = batch["image"]
        for i in range(images.shape[0]):
            if batch["mask"][i] == 0:
                continue
            save_results(img_idx, images[i, :, :, 0], recon[i, :, :, 0], out_tif, out_png)
            img_idx += 1
    return img_idx


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    init_device_and_seed(args.seed, device)
    config, model = load_config_and_model(
        args.config_file, args.checkpoint, device=device, exact=args.f32,
        conv_kernel=args.conv_kernel,
    )
    print(f"[INFO] Loaded config from {args.config_file}")

    output_dir, out_tif, out_png = resolve_inference_output_dirs(args.checkpoint, args.output_dir)
    dataloader, image_paths = build_inference_dataloader(
        input_dir=args.input_dir, config=config, batch_size=args.batch_size,
        num_samples=args.num_samples, num_workers=args.num_workers,
    )
    print(f"[INFO] Found {len(image_paths)} images in {args.input_dir}")
    try:
        n = run_inference(model, dataloader, out_tif, out_png)
    finally:
        dataloader.close()
    print(f"Inference complete ({n} images). Results saved in: {output_dir}")
    return n


if __name__ == "__main__":
    main()
