"""Config + model loading (counterpart of ``pti_ldm_vae_tpu/utils/vae_loader.py``).

Checkpoints are the reference's torch ``.pt/.pth`` files (raw MONAI state
dict or ``{"autoencoder_state_dict": ...}``). Orbax checkpoint directories
of the JAX package need JAX to read and are refused with a clear error.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Any

import torch

from ..checkpoint.torch_convert import monai_state_dict
from ..config import load_config_namespace
from ..models.autoencoder_kl import AutoencoderKL, autoencoder_from_config
from ..ops.norm import DEFAULT_NORM_STATS

__all__ = ["load_vae_config", "load_vae_model", "load_autoencoder_state_dict"]


def load_vae_config(config_file: str) -> SimpleNamespace:
    """Parity with reference ``load_vae_config`` (``vae_loader.py:11-24``)."""
    return load_config_namespace(config_file)


def load_autoencoder_state_dict(checkpoint_path: str) -> dict[str, torch.Tensor]:
    """MONAI-keyed state dict from a torch ``.pth`` file."""
    path = str(checkpoint_path)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?); the "
            "PyTorch port loads torch .pth files only — export the weights to a "
            "MONAI-keyed .pth first"
        )
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return monai_state_dict(payload)


def _top_level(config: Any, key: str, default: Any) -> Any:
    if isinstance(config, dict):
        return config.get(key, default)
    return getattr(config, key, default)


def load_vae_model(
    config: Any, checkpoint_path: str, *, device: torch.device | str,
    compute_dtype: torch.dtype = torch.float32, s2d_stem: bool | str | None = None,
    conv_kernel: bool = False,
) -> AutoencoderKL:
    """The autoencoder of ``config`` with the checkpoint's weights, in eval
    mode on ``device`` (reference ``vae_loader.py:27-43``).

    Top-level extension keys as in the JAX package: ``remat`` (inert at
    inference), ``norm_stats`` and ``s2d_stem`` (default ``"auto"``, which
    takes the standard path here). The ``s2d_stem`` keyword overrides the
    config. ``conv_kernel`` is the model field of that name."""
    ae_def = _top_level(config, "autoencoder_def", None)
    remat = bool(_top_level(config, "remat", False))
    norm_stats = str(_top_level(config, "norm_stats", DEFAULT_NORM_STATS))
    if s2d_stem is None:
        s2d_stem = _top_level(config, "s2d_stem", "auto")
    if s2d_stem not in ("auto", "encoder", "decoder"):
        s2d_stem = bool(s2d_stem)
    model = autoencoder_from_config(
        ae_def, norm_stats=norm_stats, remat=remat, s2d_stem=s2d_stem,
        compute_dtype=compute_dtype, conv_kernel=conv_kernel,
    )
    model.load_state_dict(load_autoencoder_state_dict(checkpoint_path), strict=True)
    model.requires_grad_(False)
    return model.to(device=device, memory_format=torch.channels_last).eval()
