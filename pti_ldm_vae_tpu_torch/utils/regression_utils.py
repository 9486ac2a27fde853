"""Regression training utilities (counterpart of
``pti_ldm_vae_tpu/utils/regression_utils.py``): config schema normalization
across legacy/new layouts, target normalization with persisted stats (numpy),
the losses, the train / eval steps and epoch loops, head checkpoints with
target-order validation, and the frozen-VAE + MLP model from a config.

The train step runs the frozen encode (no autograd), the head with dropout
from an explicit generator, a per-sample loss (mean over targets, masked mean
over the batch's real rows: the loader pads the last batch) and Adam, or
AdamW with decoupled weight decay when ``weight_decay`` > 0, on the head's
parameters alone. Head checkpoints are the reference's ``.pth``:
``{"regressor_state_dict", "targets", "epoch", "latent_dim"}``, which the
JAX package's ``load_regression_checkpoint`` also reads. Every checkpoint
path goes through ``checkpoint/paths.py:resolve_checkpoint``: ``head_best``
finds ``head_best.pth``, and an orbax directory is refused unless
``tools/export_jax_checkpoint.py`` wrote the ``.pth`` beside it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..checkpoint.manager import save_atomic
from ..checkpoint.paths import resolve_checkpoint
from ..models.regressor import LatentRegressor, VAELatentRegressor, infer_flat_dim_from_patch
from .metrics import compute_regression_metrics
from .vae_loader import load_vae_config, load_vae_model

__all__ = [
    "extract_regression_data_config",
    "extract_regression_train_config",
    "extract_regression_eval_config",
    "extract_regressor_def_config",
    "regression_loss_key",
    "TargetNormalizer",
    "compute_target_normalizer",
    "save_target_normalizer",
    "load_target_normalizer",
    "load_optional_normalizer",
    "build_loss_fn",
    "build_optimizer",
    "make_regression_steps",
    "train_one_epoch",
    "validate_one_epoch",
    "save_regression_checkpoint",
    "load_regression_checkpoint",
    "save_last_regression_checkpoint",
    "maybe_save_best_regression_checkpoint",
    "build_regression_model_from_config",
    "load_trained_regression_model",
    "NORM_STATS_FILENAME",
]

NORM_STATS_FILENAME = "target_norm_stats.json"


# ---------------------------------------------------------------- config ----
def extract_regression_data_config(config: dict[str, Any]) -> dict[str, Any]:
    """Normalize data config across schemas (reference ``:17-48``)."""
    data_cfg = dict(config.get("data", {}))
    legacy = config.get("train", {})
    data_cfg.setdefault("data_base_dir", config.get("data_base_dir"))
    data_cfg.setdefault("attributes_path", config.get("attributes_path"))
    data_cfg.setdefault("data_source", config.get("data_source", "edente"))
    data_cfg.setdefault("train_split", config.get("train_split", 0.9))
    data_cfg.setdefault("val_dir", config.get("val_dir"))
    data_cfg.setdefault("patch_size", config.get("patch_size"))
    data_cfg.setdefault("cache_rate", config.get("cache_rate", legacy.get("cache_rate", 0.0)))
    data_cfg.setdefault("num_workers", config.get("num_workers", legacy.get("num_workers", 4)))
    data_cfg.setdefault("seed", config.get("seed", legacy.get("seed")))
    data_cfg.setdefault("subset_size", config.get("subset_size", legacy.get("subset_size")))
    data_cfg.setdefault("normalize_attributes", config.get("normalize_attributes"))
    required = ["data_base_dir", "attributes_path", "patch_size"]
    missing = [f for f in required if data_cfg.get(f) is None]
    if missing:
        raise KeyError(f"Missing required data config fields: {missing}")
    return data_cfg


def extract_regression_train_config(config: dict[str, Any]) -> dict[str, Any]:
    """Reference ``:51-73``."""
    train_cfg = dict(config.get("regression_train") or config.get("train") or {})
    required = ["batch_size", "lr", "max_epochs"]
    missing = [f for f in required if train_cfg.get(f) is None]
    if missing:
        raise KeyError(f"Missing required training config fields: {missing}")
    train_cfg.setdefault("val_interval", 1)
    train_cfg.setdefault("target_norm", "none")
    train_cfg.setdefault("loss", "mse")
    train_cfg.setdefault("weight_decay", 0.0)
    return train_cfg


def extract_regression_eval_config(
    config: dict[str, Any], data_cfg: dict[str, Any] | None = None
) -> dict[str, Any]:
    """Reference ``:76-104``."""
    base = data_cfg or extract_regression_data_config(config)
    eval_cfg = dict(config.get("evaluation", {}))
    eval_cfg.setdefault("data_base_dir", base.get("data_base_dir"))
    eval_cfg.setdefault("attributes_path", base.get("attributes_path"))
    eval_cfg.setdefault("data_source", base.get("data_source", "edente"))
    eval_cfg.setdefault("patch_size", base.get("patch_size"))
    eval_cfg.setdefault("num_workers", base.get("num_workers", 4))
    eval_cfg.setdefault("normalize_attributes", base.get("normalize_attributes"))
    required = ["data_base_dir", "attributes_path", "patch_size"]
    missing = [f for f in required if eval_cfg.get(f) is None]
    if missing:
        raise KeyError(f"Missing required evaluation config fields: {missing}")
    return eval_cfg


def extract_regressor_def_config(config: dict[str, Any]) -> dict[str, Any]:
    """Reference ``:107-120``."""
    reg_cfg = dict(config.get("regressor_def") or config.get("regressor") or {})
    reg_cfg.setdefault("hidden_dims", [])
    reg_cfg.setdefault("dropout", 0.0)
    reg_cfg.setdefault("activation", "relu")
    return reg_cfg


def regression_loss_key(train_cfg: dict[str, Any]) -> str:
    loss_name = str(train_cfg.get("loss", "mse")).lower()
    return "loss_huber" if loss_name in {"smooth_l1", "huber"} else "loss_mse"


# ------------------------------------------------------------ normalizer ----
class TargetNormalizer:
    """Standard scaling of target vectors (reference ``:239-291``)."""

    def __init__(self, mean: np.ndarray, std: np.ndarray):
        mean = np.asarray(mean, dtype=np.float32)
        std = np.asarray(std, dtype=np.float32)
        if mean.shape != std.shape:
            raise ValueError("Mean and std must share the same shape.")
        self.mean = mean
        self.std = np.where(std == 0, 1.0, std)

    def normalize(self, targets):
        return (targets - self.mean) / self.std

    def denormalize(self, values):
        return values * self.std + self.mean

    def to_dict(self, target_names: list[str]) -> dict[str, Any]:
        return {
            "target_names": target_names,
            "mean": self.mean.tolist(),
            "std": self.std.tolist(),
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any], target_names: list[str]) -> "TargetNormalizer":
        stored = data.get("target_names", [])
        if stored and list(stored) != list(target_names):
            raise ValueError(f"Target order mismatch: expected {target_names}, found {stored}")
        return cls(np.asarray(data["mean"]), np.asarray(data["std"]))


def compute_target_normalizer(targets: np.ndarray) -> TargetNormalizer:
    """Population statistics (``np.std``, ddof 0) of an [N, T] target matrix."""
    targets = np.asarray(targets, dtype=np.float32)
    return TargetNormalizer(targets.mean(axis=0), targets.std(axis=0))


def save_target_normalizer(path: Path, normalizer: TargetNormalizer, target_names: list[str]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(normalizer.to_dict(target_names), indent=2), encoding="utf-8")


def load_target_normalizer(path: Path, target_names: list[str]) -> TargetNormalizer:
    return TargetNormalizer.from_dict(
        json.loads(Path(path).read_text(encoding="utf-8")), target_names
    )


def load_optional_normalizer(run_dir: Path, target_names: list[str]) -> TargetNormalizer | None:
    """The run's ``trained_weights/target_norm_stats.json``, where training wrote one."""
    path = Path(run_dir) / "trained_weights" / NORM_STATS_FILENAME
    return load_target_normalizer(path, target_names) if path.exists() else None


# ------------------------------------------------------------------ loss ----
def _squared_error(diff: torch.Tensor) -> torch.Tensor:
    return diff.square()


def _smooth_l1(diff: torch.Tensor) -> torch.Tensor:
    ad = diff.abs()
    return torch.where(ad < 1.0, 0.5 * ad.square(), ad - 0.5)


def _elementwise_loss(loss_name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The per-element criterion of a loss name, as a function of pred - target."""
    name = loss_name.lower()
    if name in {"mse", "mse_loss"}:
        return _squared_error
    if name in {"smooth_l1", "huber"}:
        return _smooth_l1
    raise ValueError(f"Unsupported loss '{loss_name}'. Use 'mse' or 'smooth_l1'.")


def build_loss_fn(loss_name: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """MSE or SmoothL1/Huber with torch defaults (beta=1.0), mean over all
    elements (reference ``:309-315``)."""
    elementwise = _elementwise_loss(loss_name)
    return lambda pred, tgt: elementwise(pred - tgt).mean()


def build_optimizer(params, lr: float, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """optax ``adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square root), or
    ``adamw`` with decoupled weight decay when ``weight_decay`` > 0 (the JAX
    CLI's choice); PyTorch's fused update on CUDA."""
    params = list(params)
    fused = params[0].is_cuda
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay, fused=fused)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=fused)


# ----------------------------------------------------------------- steps ----
def make_regression_steps(
    model: VAELatentRegressor,
    loss_name: str,
    optimizer: torch.optim.Optimizer | None,
    normalizer: TargetNormalizer | None,
):
    """(train_step, eval_step) of ``model``'s head. ``train_step(images,
    targets, mask, generator)`` updates the head with ``optimizer`` and
    returns the masked loss (a device scalar); ``eval_step(images, targets,
    mask)`` returns the masked loss and the de-normalized predictions. Targets
    are normalized with ``normalizer`` where one is given."""
    elementwise = _elementwise_loss(loss_name)
    device = next(model.regressor.parameters()).device
    if normalizer is not None:
        norm_mean = torch.as_tensor(normalizer.mean, device=device)
        norm_std = torch.as_tensor(normalizer.std, device=device)

    def _norm(t):
        return (t - norm_mean) / norm_std if normalizer is not None else t

    def _denorm(t):
        return t * norm_std + norm_mean if normalizer is not None else t

    def _masked_loss(preds, tgt, mask):
        per_sample = elementwise(preds - tgt).mean(dim=1)
        return (per_sample * mask).sum() / mask.sum().clamp_min(1.0)

    def train_step(images, targets, mask, generator=None):
        model.train()
        preds = model.regressor(model.encode_flat(images), generator)
        loss = _masked_loss(preds, _norm(targets), mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(images, targets, mask):
        model.eval()
        preds = model(images)
        return _masked_loss(preds, _norm(targets), mask), _denorm(preds)

    return train_step, eval_step


def _device_batch(batch: dict[str, Any], device: torch.device):
    return tuple(torch.from_numpy(batch[k]).to(device) for k in ("image", "target", "mask"))


def train_one_epoch(train_step, loader, generator: torch.Generator | None,
                    device: torch.device) -> float:
    """Reference ``train_one_epoch`` (``:318-347``): the mean of the
    per-batch losses (summed on the device, read once)."""
    total, n = None, 0
    for batch in loader:
        loss = train_step(*_device_batch(batch, device), generator)
        total = loss if total is None else total + loss
        n += 1
    if n == 0:
        raise RuntimeError("Training dataloader produced zero batches.")
    return float(total) / n


def validate_one_epoch(eval_step, loader, target_names: list[str],
                       device: torch.device) -> tuple[float, dict[str, float]]:
    """Reference ``validate_one_epoch`` (``:350-388``): (loss, metrics dict);
    predictions are cut to each batch's real rows."""
    total, n = None, 0
    preds_all, targets_all = [], []
    for batch in loader:
        loss, preds = eval_step(*_device_batch(batch, device))
        total = loss if total is None else total + loss
        n += 1
        valid = int(batch["mask"].sum())
        preds_all.append(preds.cpu().numpy()[:valid])
        targets_all.append(np.asarray(batch["target"])[:valid])
    if n == 0:
        raise RuntimeError("Validation dataloader produced zero batches.")
    metrics = compute_regression_metrics(
        np.concatenate(preds_all), np.concatenate(targets_all), target_names
    )
    return float(total) / n, metrics


# ------------------------------------------------------------ checkpoints ----
def save_regression_checkpoint(
    path: Path, regressor: LatentRegressor, targets: list[str],
    epoch: int | None = None, latent_dim: int | None = None,
) -> None:
    """Head weights + metadata in one ``.pth`` (reference ``:391-407``)."""
    state = {k: v.detach().cpu() for k, v in regressor.state_dict().items()}
    save_atomic({"regressor_state_dict": state, "targets": list(targets), "epoch": epoch,
                 "latent_dim": latent_dim}, str(path))


def load_regression_checkpoint(
    path: Path, expected_targets: list[str]
) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """(head state dict, metadata) of a ``.pth`` head checkpoint; validates
    the target order (reference ``:410-431``)."""
    ckpt = torch.load(resolve_checkpoint(path, "head"), map_location="cpu", weights_only=True)
    stored = ckpt.get("targets")
    if stored and list(stored) != list(expected_targets):
        raise ValueError(f"Target mismatch: expected {expected_targets}, found {stored}.")
    return ckpt["regressor_state_dict"], {k: v for k, v in ckpt.items()
                                          if k != "regressor_state_dict"}


def save_last_regression_checkpoint(weights_dir: Path, regressor, targets, epoch,
                                    latent_dim: int | None = None) -> Path:
    path = Path(weights_dir) / "head_last.pth"
    save_regression_checkpoint(path, regressor, targets, epoch, latent_dim)
    return path


def maybe_save_best_regression_checkpoint(
    weights_dir: Path, regressor, targets, epoch, val_loss, best_val_loss,
    latent_dim: int | None = None,
) -> tuple[float, Path]:
    path = Path(weights_dir) / "head_best.pth"
    if val_loss < best_val_loss:
        save_regression_checkpoint(path, regressor, targets, epoch, latent_dim)
        return val_loss, path
    return best_val_loss, path


# ----------------------------------------------------------------- model ----
def build_regression_model_from_config(
    config: dict[str, Any], targets: list[str], *, device: torch.device | str,
    compute_dtype: torch.dtype = torch.float32, conv_kernel: bool = False,
    generator: torch.Generator | None = None,
) -> tuple[VAELatentRegressor, int]:
    """Frozen VAE + head from config (reference ``:480-515``), on ``device``.
    The VAE encodes in ``compute_dtype`` (f32 unless asked, as the JAX CLIs
    load it); the head is f32, initialized from ``generator`` (a CPU
    generator). ``vae.checkpoint`` is found by ``resolve_checkpoint`` (first,
    before the VAE's config is read): the shipped configs'
    ``.../autoencoder_last`` loads ``autoencoder_last.pth``."""
    vae_ckpt = resolve_checkpoint(config["vae"]["checkpoint"], "vae")
    vae = load_vae_model(load_vae_config(config["vae"]["config_file"]), vae_ckpt,
                         device=device, compute_dtype=compute_dtype, conv_kernel=conv_kernel)
    data_cfg = extract_regression_data_config(config)
    reg_cfg = extract_regressor_def_config(config)
    latent_dim = infer_flat_dim_from_patch(vae, tuple(data_cfg["patch_size"]))
    regressor = LatentRegressor(
        latent_dim,
        hidden_dims=tuple(reg_cfg.get("hidden_dims", [])),
        output_dim=len(targets),
        dropout=float(reg_cfg.get("dropout", 0.0)),
        activation=reg_cfg.get("activation", "relu"),
        generator=generator,
    )
    model = VAELatentRegressor(vae, regressor.to(device), latent_dim=latent_dim)
    return model, latent_dim


def load_trained_regression_model(
    config: dict[str, Any], targets: list[str], checkpoint: str, *, device: torch.device | str,
    compute_dtype: torch.dtype = torch.float32, conv_kernel: bool = False,
) -> VAELatentRegressor:
    """``build_regression_model_from_config`` with the head of a ``.pth``
    head checkpoint (its target order checked, its keys loaded strictly)."""
    model, _ = build_regression_model_from_config(config, targets, device=device,
                                                  compute_dtype=compute_dtype,
                                                  conv_kernel=conv_kernel)
    state, _ = load_regression_checkpoint(Path(checkpoint), targets)
    model.regressor.load_state_dict(state, strict=True)
    return model
