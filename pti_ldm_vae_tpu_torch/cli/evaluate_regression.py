"""Regression evaluation CLI (counterpart of
``pti_ldm_vae_tpu/cli/evaluate_regression.py``; reference
``reg_scripts/evaluate_regression.py``): reload the frozen VAE and a head
checkpoint (``.pth``), MAE/MSE per target and aggregate over a directory ->
``<run_dir>/eval/metrics.json`` (``args`` / ``metrics`` / ``files``).
Predictions are de-normalized with the run's ``target_norm_stats.json``
where it has one. f32 encode, TF32 off; CUDA unless ``--device cpu``.

    python -m pti_ldm_vae_tpu_torch.cli.evaluate_regression -c config/reg_edente_from_dente.json \\
        --checkpoint runs/reg_edente_from_dente/trained_weights/head_best.pth [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data.factory import create_regression_eval_dataloader
from ..utils.cli_common import (
    enable_parity_numerics,
    init_device_and_seed,
    load_json_config,
    resolve_device,
    resolve_run_dir,
    serialize_args,
)
from ..utils.regression_utils import (
    extract_regression_data_config,
    extract_regression_eval_config,
    extract_regression_train_config,
    load_optional_normalizer,
    load_trained_regression_model,
    make_regression_steps,
    validate_one_epoch,
)

__all__ = ["main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Evaluate a trained regression head (PyTorch/CUDA).")
    parser.add_argument("-c", "--config-file", required=True)
    parser.add_argument("--checkpoint", required=True, help="Head checkpoint (.pth)")
    parser.add_argument("--input-dir", type=str, default=None)
    parser.add_argument("--attributes-path", type=str, default=None)
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
    eval_cfg = extract_regression_eval_config(config, data_cfg)
    if args.batch_size is not None:
        train_cfg["batch_size"] = args.batch_size
    if args.num_workers is not None:
        eval_cfg["num_workers"] = args.num_workers
    if args.attributes_path is not None:
        eval_cfg["attributes_path"] = args.attributes_path
    run_dir = resolve_run_dir(config, args.config_file)
    enable_parity_numerics()
    init_device_and_seed(args.seed, device)

    targets: list[str] = config["targets"]
    model = load_trained_regression_model(config, targets, args.checkpoint, device=device,
                                          conv_kernel=args.conv_kernel)
    input_dir = args.input_dir or eval_cfg["data_base_dir"]
    dataloader, image_paths = create_regression_eval_dataloader(
        input_dir,
        eval_cfg["attributes_path"],
        targets,
        batch_size=train_cfg["batch_size"],
        patch_size=tuple(eval_cfg["patch_size"]),
        num_workers=eval_cfg.get("num_workers", 4),
        num_samples=args.num_samples,
        data_source=eval_cfg.get("data_source", "edente"),
        normalize_attributes=eval_cfg.get("normalize_attributes"),
    )
    normalizer = load_optional_normalizer(run_dir, targets)
    _, eval_step = make_regression_steps(model, train_cfg.get("loss", "mse"), None, normalizer)
    try:
        val_loss, metrics = validate_one_epoch(eval_step, dataloader, targets, device)
    finally:
        dataloader.close()

    output_dir = Path(args.output_dir) if args.output_dir else run_dir / "eval"
    output_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "args": serialize_args(args),
        "metrics": {"val_loss": val_loss, **metrics},
        "files": image_paths,
    }
    (output_dir / "metrics.json").write_text(json.dumps(payload, indent=2), encoding="utf-8")
    print(f"Evaluation complete. Metrics written to {output_dir / 'metrics.json'}")
    return payload["metrics"]


if __name__ == "__main__":
    main()
