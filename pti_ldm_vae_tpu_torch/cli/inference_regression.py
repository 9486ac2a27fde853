"""Regression inference CLI (counterpart of
``pti_ldm_vae_tpu/cli/inference_regression.py``; reference
``reg_scripts/inference_regression.py``): the head's predictions for every
image of ``--input-dir`` -> ``<run_dir>/inference/predictions.json``,
de-normalized with the run's ``target_norm_stats.json`` where it has one.
f32 encode, TF32 off; CUDA unless ``--device cpu``.

    python -m pti_ldm_vae_tpu_torch.cli.inference_regression -c config/reg_edente_from_dente.json \\
        --checkpoint runs/reg_edente_from_dente/trained_weights/head_best.pth \\
        --input-dir data/test/dente [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data.factory import create_regression_inference_dataloader
from ..utils.cli_common import (
    enable_parity_numerics,
    init_device_and_seed,
    load_json_config,
    resolve_device,
    resolve_run_dir,
)
from ..utils.regression_utils import (
    extract_regression_data_config,
    extract_regression_train_config,
    load_optional_normalizer,
    load_trained_regression_model,
)

__all__ = ["main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Run regression head inference (PyTorch/CUDA).")
    parser.add_argument("-c", "--config-file", required=True)
    parser.add_argument("--checkpoint", required=True, help="Head checkpoint (.pth)")
    parser.add_argument("--input-dir", required=True)
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument("--num-samples", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--num-workers", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent CPU fallback")
    parser.add_argument("--conv-kernel", action="store_true",
                        help="3x3 stride-1 convolutions of the encoder through the "
                             "hand-written convolution kernels instead of cuDNN")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = load_json_config(args.config_file)
    data_cfg = extract_regression_data_config(config)
    train_cfg = extract_regression_train_config(config)
    if args.batch_size is not None:
        train_cfg["batch_size"] = args.batch_size
    if args.num_workers is not None:
        data_cfg["num_workers"] = args.num_workers
    run_dir = resolve_run_dir(config, args.config_file)
    enable_parity_numerics()
    init_device_and_seed(args.seed, device)

    targets: list[str] = config["targets"]
    model = load_trained_regression_model(config, targets, args.checkpoint, device=device,
                                          conv_kernel=args.conv_kernel).eval()
    dataloader, image_paths = create_regression_inference_dataloader(
        input_dir=args.input_dir,
        patch_size=tuple(data_cfg["patch_size"]),
        batch_size=train_cfg["batch_size"],
        num_samples=args.num_samples,
        num_workers=data_cfg.get("num_workers", 4),
    )
    normalizer = load_optional_normalizer(run_dir, targets)

    preds_all = []
    try:
        with torch.no_grad():
            for batch in dataloader:
                preds = model(torch.from_numpy(batch["image"]).to(device)).cpu().numpy()
                if normalizer is not None:
                    preds = normalizer.denormalize(preds)
                preds_all.append(preds[: int(batch["mask"].sum())])
    finally:
        dataloader.close()
    stacked = np.concatenate(preds_all, axis=0)

    output_dir = Path(args.output_dir) if args.output_dir else run_dir / "inference"
    output_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "targets": targets,
        "predictions": [
            {"file": path, **{t: float(v) for t, v in zip(targets, row)}}
            for path, row in zip(image_paths, stacked)
        ],
    }
    (output_dir / "predictions.json").write_text(json.dumps(payload, indent=2), encoding="utf-8")
    print(f"Inference complete. Predictions written to {output_dir / 'predictions.json'}")
    return payload


if __name__ == "__main__":
    main()
