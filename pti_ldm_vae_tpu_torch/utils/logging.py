"""Metric logging: local JSONL sink + optional W&B (counterpart of
``pti_ldm_vae_tpu/utils/logging.py``), matching the reference's metric
contract: per-step train scalars keyed on ``train/step``, per-epoch val
scalars keyed on ``epoch``, image triplets. The primary sink is a run-local
``metrics.jsonl`` (one JSON object per log call); ``wandb`` is imported only
when a run enables it, and the same payloads are mirrored to it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np

__all__ = ["MetricLogger", "init_wandb_config", "load_dotenv"]


def load_dotenv(path: str = ".env") -> None:
    """Minimal ``.env`` loader (the reference uses python-dotenv for
    WANDB_PROJECT/WANDB_ENTITY). Existing environment variables win."""
    if not os.path.exists(path):
        return
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            os.environ.setdefault(key.strip(), value.strip().strip("'\""))


def init_wandb_config(args_cfg: dict[str, Any]) -> dict[str, Any]:
    """The run-config payload the reference sends to wandb.init
    (``train_vae.py:145-166``)."""
    ae_def = args_cfg.get("autoencoder_def", {})
    train = args_cfg.get("autoencoder_train", {})
    return {
        "architecture": "VAE",
        "spatial_dims": args_cfg.get("spatial_dims"),
        "latent_channels": args_cfg.get("latent_channels"),
        "channels": ae_def.get("channels"),
        "num_res_blocks": ae_def.get("num_res_blocks"),
        "batch_size": train.get("batch_size"),
        "lr": train.get("lr"),
        "max_epochs": train.get("max_epochs"),
        "kl_weight": train.get("kl_weight"),
        "perceptual_weight": train.get("perceptual_weight"),
        "recon_loss": train.get("recon_loss"),
        "adv_weight": train.get("adv_weight"),
        "data_source": args_cfg.get("data_source"),
    }


class MetricLogger:
    """Rank-0 metric sink: JSONL file (always) + W&B (when enabled and installed)."""

    def __init__(self, run_dir: str, *, rank: int = 0, wandb_cfg: dict[str, Any] | None = None,
                 run_config: dict[str, Any] | None = None):
        self.rank = rank
        self.active = rank == 0
        self.run = None
        self._wandb = None
        self._fh = None
        if not self.active:
            return
        os.makedirs(run_dir, exist_ok=True)
        self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a", encoding="utf-8")
        if run_config:
            # durable record of the run config (incl. perceptual_pretrained)
            with open(os.path.join(run_dir, "run_config.json"), "w", encoding="utf-8") as fh:
                json.dump(run_config, fh, indent=2, default=str)
        if wandb_cfg and wandb_cfg.get("enabled", True):
            try:
                import wandb
            except ImportError:
                return
            self._wandb = wandb
            project = os.getenv("WANDB_PROJECT", wandb_cfg.get("project", "pti-ldm-vae"))
            entity = wandb_cfg.get("entity") or os.getenv("WANDB_ENTITY")
            name = wandb_cfg.get("name") or os.path.basename(os.path.normpath(run_dir))
            self.run = wandb.init(
                project=project, entity=entity, name=name,
                tags=wandb_cfg.get("tags", []), notes=wandb_cfg.get("notes", ""),
                config=run_config or {},
            )
            wandb.define_metric("train/*", step_metric="train/step")
            wandb.define_metric("val/*", step_metric="epoch")
            wandb.define_metric("epoch")
            wandb.define_metric("time_per_epoch", step_metric="epoch")

    def log(self, payload: dict[str, Any], step: int | None = None) -> None:
        if not self.active:
            return
        clean = {
            k: (float(v) if isinstance(v, (int, float, np.floating)) or hasattr(v, "item") else v)
            for k, v in payload.items()
        }
        record = {"_time": time.time(), **clean}
        if step is not None:
            record["_step"] = int(step)
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self.run is not None:
            self.run.log(clean, step=step)

    def log_images(self, key: str, images: list[np.ndarray], step: int | None = None) -> None:
        """Mirror of wandb.Image triplet panels; JSONL records the count only."""
        if not self.active:
            return
        self.log({f"{key}/count": len(images)}, step=step)
        if self.run is not None:
            self.run.log({key: [self._wandb.Image(img) for img in images]}, step=step)

    def finish(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self.run is not None:
            self.run.finish()
            self.run = None
