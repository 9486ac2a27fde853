"""Config + model loading (counterpart of ``pti_ldm_vae_tpu/utils/vae_loader.py``).

Checkpoints are the reference's torch ``.pt/.pth`` files (raw MONAI state
dict or ``{"autoencoder_state_dict": ...}``) and the MONAI-keyed ``.npz``
that ``tools/convert_torch_checkpoint.py to-torch`` writes. The path goes
through ``checkpoint/paths.py:resolve_checkpoint``: a config's
``.../autoencoder_last`` finds ``autoencoder_last.pth``, and an orbax
directory of the JAX package is refused unless exported beside it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from ..checkpoint.paths import resolve_checkpoint
from ..checkpoint.torch_convert import monai_state_dict
from ..config import load_config_namespace
from ..models.autoencoder_kl import AutoencoderKL, autoencoder_from_config, channels_last_format
from ..ops.norm import DEFAULT_NORM_STATS

__all__ = ["load_vae_config", "load_vae_model", "load_autoencoder_state_dict"]


def load_vae_config(config_file: str) -> SimpleNamespace:
    """Parity with reference ``load_vae_config`` (``vae_loader.py:11-24``)."""
    return load_config_namespace(config_file)


def load_autoencoder_state_dict(checkpoint_path: str) -> dict[str, torch.Tensor]:
    """MONAI-keyed state dict from a torch ``.pth`` file or a MONAI-keyed
    ``.npz`` (read without pickles), found by ``resolve_checkpoint``."""
    path = resolve_checkpoint(checkpoint_path, "vae")
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as raw:
            payload = {key: torch.from_numpy(np.ascontiguousarray(raw[key])) for key in raw.files}
    else:
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

    Top-level extension keys as in the JAX package: ``remat`` (inert on pure
    forwards; PTI differentiates the decoder through this model, where it
    recomputes the blocks' activations), ``norm_stats`` and ``s2d_stem``
    (default ``"auto"``, gated per side on the batch by the model). The
    ``s2d_stem`` keyword overrides the config. ``conv_kernel`` is the model
    field of that name."""
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
    return model.to(device=device, memory_format=channels_last_format(model.spatial_dims)).eval()
