"""Pivotal-tuning-inversion CLI: per-image latent inversion and decoder
fine-tune on a trained VAE (counterpart of ``pti_ldm_vae_tpu/cli/run_pti.py``).

For each input image stage 1 optimizes a pivot latent through the frozen
decoder from the image's ``encode_deterministic`` latent, and stage 2
fine-tunes the decoder around that pivot. Outputs per image in
``--output-dir``: ``{name}_pivot.npz`` (``latent``, ``latent_loss``,
``tune_loss``), the reconstruction of the pivot through the tuned decoder as
``{name}_pti.tif`` and ``{name}_pti.png``, and with ``--save-tuned``
``{name}_decoder.pth``: the whole autoencoder's state dict (MONAI keys) with
the tuned decoder, which ``inference_vae --checkpoint`` loads. (The JAX CLI
writes the tuned tree as an orbax directory; the port reads and writes
``.pth`` only.)

``--batch-size 1`` runs each image on its own; above 1 a batch is inverted
in one pass and tuned image by image (``make_pivotal_tuning_inversion_batched``,
built once); padded rows of the last batch are optimized but not written.
Runs on CUDA unless ``--device cpu`` is given; bf16 compute there unless
``--f32``.

    python -m pti_ldm_vae_tpu_torch.cli.run_pti -c config/vae_dente_no_adv.json \\
        --checkpoint vae.pth --input-dir data/ --output-dir pti_out/ [--batch-size 8] \\
        [--latent-steps 200 --tune-steps 100] [--save-tuned] [--f32] [--conv-kernel] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.io import write_png, write_tif
from ..ops.space_to_depth import s2d_auto_mode
from ..train.diffusion import (
    make_pivotal_tuning_inversion_batched,
    pivotal_tuning_inversion,
    swapped_decoder,
)
from ..utils.cli_common import (
    add_shared_io_args,
    build_inference_dataloader,
    init_device_and_seed,
    load_config_and_model,
    resolve_device,
)
from ..utils.visualization import normalize_batch_for_display

__all__ = ["main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Pivotal tuning inversion (PyTorch/CUDA).")
    add_shared_io_args(parser, output_help="Output directory (default: pti_out)")
    parser.add_argument("--latent-steps", type=int, default=200)
    parser.add_argument("--latent-lr", type=float, default=1e-1)
    parser.add_argument("--tune-steps", type=int, default=100)
    parser.add_argument("--tune-lr", type=float, default=1e-4)
    parser.add_argument("--save-tuned", action="store_true",
                        help="Save each image's autoencoder with its tuned decoder (.pth)")
    parser.add_argument("--tune-formulation", choices=("scan", "vmap"), default="scan",
                        help="Batched tune stage: 'scan' tunes one image's decoder at a time; "
                             "'vmap' (per-image copies as grouped convolutions) is not ported")
    parser.add_argument("--f32", action="store_true",
                        help="Exact f32 numerics (f32 compute, TF32 off)")
    parser.add_argument("--conv-kernel", action="store_true",
                        help="3x3 stride-1 convolutions through the hand-written "
                             "convolution kernels instead of cuDNN")
    # 1: the sequential per-image path; > 1: one batched inversion per batch
    parser.set_defaults(batch_size=1)
    return parser.parse_args(argv)


def main(argv=None) -> Path:
    args = parse_args(argv)
    device = resolve_device(args.device)
    init_device_and_seed(args.seed, device)
    # PTI differentiates through the decoder, so the inference-profile s2d "auto"
    # does not apply: the train profile decides, at the batch PTI runs
    config, model = load_config_and_model(
        args.config_file, args.checkpoint, device=device, exact=args.f32,
        conv_kernel=args.conv_kernel, s2d_stem=s2d_auto_mode("train", max(args.batch_size, 1)))
    spatial_dims = config.autoencoder_def.get("spatial_dims", 2)
    if spatial_dims != 2:
        # the TIF/PNG dump slices [0, :, :, 0] (2-D NHWC)
        raise NotImplementedError(
            f"run_pti supports spatial_dims=2 checkpoints only (got spatial_dims={spatial_dims})")
    hyper = dict(latent_steps=args.latent_steps, latent_lr=args.latent_lr,
                 tune_steps=args.tune_steps, tune_lr=args.tune_lr)
    batched = args.batch_size > 1
    # built once, before any work: the vmap form raises here
    program = (make_pivotal_tuning_inversion_batched(
        model, tune_formulation=args.tune_formulation, **hyper) if batched else None)
    out_dir = Path(args.output_dir or "pti_out")
    out_dir.mkdir(parents=True, exist_ok=True)
    loader, paths = build_inference_dataloader(args.input_dir, config, max(args.batch_size, 1),
                                               args.num_samples, args.num_workers)

    def save_one(name: str, pivot: torch.Tensor, tuned: dict[str, torch.Tensor],
                 latent_loss: torch.Tensor, tune_loss: torch.Tensor) -> None:
        with swapped_decoder(model, tuned), torch.no_grad():
            recon = model.decode(pivot).cpu().numpy()
            if args.save_tuned:
                torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                           out_dir / f"{name}_decoder.pth")
        latent_loss, tune_loss = latent_loss.cpu().numpy(), tune_loss.cpu().numpy()
        np.savez(out_dir / f"{name}_pivot.npz", latent=pivot.cpu().numpy(),
                 latent_loss=latent_loss, tune_loss=tune_loss)
        write_tif(str(out_dir / f"{name}_pti.tif"), recon[0, :, :, 0])
        disp = normalize_batch_for_display(recon)
        write_png(str(out_dir / f"{name}_pti.png"), (disp[0, :, :, 0] * 255).astype(np.uint8))
        print(f"{name}: inversion L2 {float(latent_loss[-1]):.5f} -> "
              f"tuned {float(tune_loss[-1]):.5f}")

    img_idx = 0
    try:
        for batch in loader:
            valid = batch["mask"] > 0
            if not valid.any():
                continue
            images = torch.from_numpy(batch["image"]).to(device)
            with torch.no_grad():
                z_init = model.encode_deterministic(images)
            if batched:
                pivots, tuned_all, losses = program(images, z_init)
                for row in np.nonzero(valid)[0]:
                    r = int(row)
                    save_one(Path(paths[img_idx + r]).stem, pivots[r:r + 1],
                             {k: v[r] for k, v in tuned_all.items()},
                             losses["latent"][r], losses["tune"][r])
            else:
                pivot, tuned, losses = pivotal_tuning_inversion(model, images[:1], z_init[:1],
                                                                **hyper)
                save_one(Path(paths[img_idx]).stem, pivot, tuned, losses["latent"],
                         losses["tune"])
            img_idx += int(valid.sum())
    finally:
        loader.close()
    print(f"PTI complete ({img_idx} images) -> {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
