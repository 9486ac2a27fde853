"""Regression head training CLI (counterpart of
``pti_ldm_vae_tpu/cli/train_regression.py``; reference
``reg_scripts/train_regression.py``): frozen-VAE encode -> flatten -> MLP
head, head-only Adam (AdamW with ``weight_decay``), optional standard target
normalization with persisted stats, best/last head checkpoints
(``trained_weights/head_{best,last}.pth``) and ``metrics.jsonl``.

The VAE encodes in f32 with TF32 off, as the JAX CLI loads it; ``vae.checkpoint``
must be a MONAI-keyed ``.pth``. Runs on CUDA unless ``--device cpu`` is given.
``main`` returns the best validation loss, the weights directory and the
trained model (frozen VAE + head).

    python -m pti_ldm_vae_tpu_torch.cli.train_regression -c config/reg_edente_from_dente.json \\
        [--max-epochs N] [--conv-kernel] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..data.factory import create_regression_dataloaders
from ..utils.cli_common import (
    enable_parity_numerics,
    init_device_and_seed,
    load_json_config,
    resolve_device,
    resolve_run_dir,
)
from ..utils.logging import MetricLogger
from ..utils.regression_utils import (
    NORM_STATS_FILENAME,
    build_optimizer,
    build_regression_model_from_config,
    compute_target_normalizer,
    extract_regression_data_config,
    extract_regression_train_config,
    extract_regressor_def_config,
    load_regression_checkpoint,
    make_regression_steps,
    maybe_save_best_regression_checkpoint,
    regression_loss_key,
    save_last_regression_checkpoint,
    save_target_normalizer,
    train_one_epoch,
    validate_one_epoch,
)

__all__ = ["main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train a regression head on frozen VAE latents (PyTorch/CUDA).")
    parser.add_argument("-c", "--config-file", required=True, help="Path to regression config JSON.")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--num-workers", type=int, default=None)
    parser.add_argument("--cache-rate", type=float, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--subset-size", type=int, default=None)
    parser.add_argument("--resume-checkpoint", type=str, default=None,
                        help="Head checkpoint (.pth) to start from")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent CPU fallback")
    parser.add_argument("--conv-kernel", action="store_true",
                        help="3x3 stride-1 convolutions of the encoder through the "
                             "hand-written convolution kernels instead of cuDNN")
    return parser.parse_args(argv)


def apply_overrides(config, args):
    """CLI overrides into normalized config blocks (reference ``:53-90``)."""
    data_cfg = extract_regression_data_config(config)
    train_cfg = extract_regression_train_config(config)
    regressor_cfg = extract_regressor_def_config(config)
    for key, value in {
        "num_workers": args.num_workers, "cache_rate": args.cache_rate,
        "seed": args.seed, "subset_size": args.subset_size,
    }.items():
        if value is not None:
            data_cfg[key] = value
    for key, value in {
        "batch_size": args.batch_size, "lr": args.lr, "max_epochs": args.max_epochs,
    }.items():
        if value is not None:
            train_cfg[key] = value
    config["data"] = data_cfg
    config["regression_train"] = train_cfg
    config["regressor_def"] = regressor_cfg
    return data_cfg, train_cfg, regressor_cfg


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = load_json_config(args.config_file)
    data_cfg, train_cfg, _ = apply_overrides(config, args)
    run_dir = resolve_run_dir(config, args.config_file)
    weights_dir = run_dir / "trained_weights"
    weights_dir.mkdir(parents=True, exist_ok=True)

    seed = data_cfg.get("seed")
    enable_parity_numerics()
    dropout_gen = init_device_and_seed(seed, device)

    targets: list[str] = config["targets"]
    model, latent_dim = build_regression_model_from_config(
        config, targets, device=device, conv_kernel=args.conv_kernel,
        generator=torch.Generator().manual_seed(0 if seed is None else seed))
    print(f"Flattened latent dim: {latent_dim} | targets: {targets}")
    if args.resume_checkpoint is not None:
        state, _ = load_regression_checkpoint(Path(args.resume_checkpoint), targets)
        model.regressor.load_state_dict(state, strict=True)

    train_loader, val_loader, train_paths, val_paths = create_regression_dataloaders(
        data_base_dir=data_cfg["data_base_dir"],
        attributes_path=data_cfg["attributes_path"],
        targets=targets,
        batch_size=train_cfg["batch_size"],
        patch_size=tuple(data_cfg["patch_size"]),
        train_split=float(data_cfg.get("train_split", 0.9)),
        num_workers=int(data_cfg.get("num_workers", 4)),
        seed=seed,
        subset_size=data_cfg.get("subset_size"),
        val_dir=data_cfg.get("val_dir"),
        cache_rate=float(data_cfg.get("cache_rate", 0.0)),
        data_source=data_cfg.get("data_source", "edente"),
        normalize_attributes=data_cfg.get("normalize_attributes"),
    )

    normalizer = None
    if str(train_cfg.get("target_norm", "none")).lower() == "standard":
        normalizer = compute_target_normalizer(train_loader.stacked_targets())
        save_target_normalizer(weights_dir / NORM_STATS_FILENAME, normalizer, targets)

    loss_key = regression_loss_key(train_cfg)
    optimizer = build_optimizer(model.regressor.parameters(), train_cfg["lr"],
                                float(train_cfg.get("weight_decay", 0.0)))
    train_step, eval_step = make_regression_steps(model, train_cfg.get("loss", "mse"), optimizer,
                                                  normalizer)
    logger = MetricLogger(str(run_dir), wandb_cfg=config.get("wandb", {"enabled": False}))

    max_epochs = train_cfg["max_epochs"]
    val_interval = train_cfg.get("val_interval", 1)
    best_val = float("inf")
    try:
        for epoch in range(1, max_epochs + 1):
            train_loader.set_epoch(epoch)
            train_loss = train_one_epoch(train_step, train_loader, dropout_gen, device)
            if epoch % val_interval == 0 or epoch == max_epochs:
                val_loss, metrics = validate_one_epoch(eval_step, val_loader, targets, device)
                best_val, _ = maybe_save_best_regression_checkpoint(
                    weights_dir, model.regressor, targets, epoch, val_loss, best_val, latent_dim)
                print(f"[Epoch {epoch:03d}/{max_epochs:03d}] train_{loss_key}={train_loss:.4f} "
                      f"val_{loss_key}={val_loss:.4f} metrics={metrics}")
                logger.log({
                    "epoch": epoch, f"train/{loss_key}": train_loss,
                    f"val/{loss_key}": val_loss, f"best/val_{loss_key}": best_val,
                    **{f"val/{k}": v for k, v in metrics.items()},
                })
            else:
                print(f"[Epoch {epoch:03d}/{max_epochs:03d}] train_{loss_key}={train_loss:.4f}")
                logger.log({
                    "epoch": epoch, f"train/{loss_key}": train_loss,
                    f"best/val_{loss_key}": best_val,
                })
            save_last_regression_checkpoint(weights_dir, model.regressor, targets, epoch,
                                            latent_dim)
    finally:
        logger.finish()
        train_loader.close()
        val_loader.close()
    print(f"Training complete. Trained on {len(train_paths)}, validated on {len(val_paths)}.")
    return {"best_val": best_val, "weights_dir": str(weights_dir), "model": model}


if __name__ == "__main__":
    main()
