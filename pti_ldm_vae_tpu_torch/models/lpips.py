"""LPIPS perceptual loss with a SqueezeNet-1.1 backbone (counterpart of
``pti_ldm_vae_tpu/models/lpips.py``; NHWC in, as everywhere in the port).

Equivalent of MONAI ``PerceptualLoss(spatial_dims=2, network_type="squeeze")``:

* input scaling ``(x - shift) / scale`` with the published LPIPS constants,
* SqueezeNet-1.1 ``features`` trunk with taps after each of the 7 LPIPS
  slices (channel widths 64/128/256/384/384/512/512),
* per tap: channel-unit-normalize both inputs, squared difference, learned
  1x1 "lin" weights, spatial mean; summed over taps.

Parameters are a plain nested dict of tensors with the JAX package's tree
keys (``conv0``, ``fire{i}/{squeeze,expand1,expand3}``, ``lin{i}``,
``_pretrained``); conv weights are held OIHW (``torch.nn.functional.conv2d``'s
layout), converted from the HWIO kernels of the shared ``.npz`` file by
``checkpoint/torch_convert.py``. The parameters are constants of the loss:
they carry no gradient.

Pretrained weights are not shipped; :func:`load_lpips_params` loads a
converted ``.npz`` when one exists, else :func:`init_lpips_params` gives a
deterministic random-feature perceptual metric (still a training signal, not
LPIPS-calibrated; parity runs must supply converted weights). The random
tree has the JAX package's distributions but not its values: the two
frameworks' generators differ.

The trunk's convolutions and pools are library calls (they were outside any
kernel in the JAX package too). The trunk runs in ``compute_dtype``; the
per-tap normalisation and the distance accumulate in f32.
"""

from __future__ import annotations

import logging
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..checkpoint.torch_convert import lpips_params_from_npz
from ..utils.losses import ensure_three_channels

__all__ = [
    "ensure_three_channels",
    "init_lpips_params",
    "load_lpips_params",
    "lpips_is_pretrained",
    "lpips_features",
    "lpips_distance",
    "lpips_distance_per_sample",
    "lpips_distance_per_sample_3d",
]

logger = logging.getLogger(__name__)

# LPIPS published scaling constants (RGB).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# SqueezeNet-1.1 `features` fire blocks: (squeeze, expand1x1, expand3x3).
_FIRE_CFG = [
    (16, 64, 64), (16, 64, 64), (32, 128, 128), (32, 128, 128),
    (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256),
]
LPIPS_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
MIN_SIDE = 17  # below it the trunk's third ceil-mode maxpool has no output


def _conv_params(gen: torch.Generator, in_ch: int, out_ch: int, k: int) -> dict[str, torch.Tensor]:
    w = torch.randn((out_ch, in_ch, k, k), generator=gen) * float(np.sqrt(2.0 / (in_ch * k * k)))
    return {"w": w, "b": torch.zeros(out_ch)}


def init_lpips_params(seed: int = 0, device: torch.device | str = "cpu") -> dict[str, Any]:
    """Deterministic random LPIPS parameters (He-normal convs, zero biases,
    ``lin`` weights uniform in [0, 2/C)) from a seeded ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    params: dict[str, Any] = {"conv0": _conv_params(gen, 3, 64, 3)}
    in_ch = 64
    for i, (s, e1, e3) in enumerate(_FIRE_CFG):
        params[f"fire{i}"] = {
            "squeeze": _conv_params(gen, in_ch, s, 1),
            "expand1": _conv_params(gen, s, e1, 1),
            "expand3": _conv_params(gen, s, e3, 3),
        }
        in_ch = e1 + e3
    for i, c in enumerate(LPIPS_CHANNELS):
        params[f"lin{i}"] = {"w": torch.rand(c, generator=gen) * (2.0 / c)}
    params["_pretrained"] = torch.zeros(())  # 0 = random init
    return _to_device(params, device)


def _to_device(tree: Any, device: torch.device | str) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def load_lpips_params(
    npz_path: str | None = None, seed: int = 0, device: torch.device | str = "cpu"
) -> dict[str, Any]:
    """Converted LPIPS weights from ``.npz`` (keys ``conv0/w`` etc., HWIO
    kernels: the file the JAX package reads), else :func:`init_lpips_params`.

    Search order: explicit path -> ``$PTI_LPIPS_WEIGHTS`` -> the packaged
    default ``weights/lpips_squeeze.npz``. ``$PTI_LPIPS_WEIGHTS=none`` skips
    every candidate but the explicit path and forces the random fallback."""
    env = os.environ.get("PTI_LPIPS_WEIGHTS")
    if env == "none":
        candidates = [npz_path]
    else:
        candidates = [
            npz_path,
            env,
            os.path.join(os.path.dirname(__file__), "..", "..", "weights", "lpips_squeeze.npz"),
        ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            params = lpips_params_from_npz(cand)
            logger.info("LPIPS: loaded pretrained squeeze weights from %s", cand)
            return _to_device(params, device)
    logger.warning(
        "LPIPS: no pretrained weights found (looked at %s); falling back to "
        "DETERMINISTIC RANDOM features. The perceptual loss is still a usable "
        "training signal but is NOT LPIPS — for reference parity convert real "
        "weights to the .npz layout and set $PTI_LPIPS_WEIGHTS or place "
        "weights/lpips_squeeze.npz.",
        [c for c in candidates if c],
    )
    return init_lpips_params(seed, device)


def lpips_is_pretrained(params: dict[str, Any]) -> bool:
    """True when ``params`` carry converted pretrained weights (the
    ``_pretrained`` flag written by :func:`load_lpips_params`)."""
    flag = params.get("_pretrained")
    return bool(flag is not None and float(flag) == 1.0)


def _conv(x: torch.Tensor, p: dict[str, torch.Tensor], stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride, padding=padding)


def _maxpool_ceil(x: torch.Tensor) -> torch.Tensor:
    """MaxPool(kernel 3, stride 2, ceil_mode=True) like torchvision SqueezeNet."""
    return F.max_pool2d(x, kernel_size=3, stride=2, ceil_mode=True)


def _fire(x: torch.Tensor, p: dict[str, Any]) -> torch.Tensor:
    s = F.relu(_conv(x, p["squeeze"]))
    return torch.cat([F.relu(_conv(s, p["expand1"])), F.relu(_conv(s, p["expand3"], padding=1))], dim=1)


def lpips_features(
    params: dict[str, Any], x: torch.Tensor, compute_dtype: torch.dtype = torch.float32
) -> list[torch.Tensor]:
    """The 7 LPIPS tap activations, NHWC, for an NHWC 3-channel input; the
    trunk runs in ``compute_dtype``."""
    shift = torch.tensor(_SHIFT, device=x.device, dtype=x.dtype)
    scale = torch.tensor(_SCALE, device=x.device, dtype=x.dtype)
    h = ((x - shift) / scale).to(compute_dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    taps = []
    h = F.relu(_conv(h, params["conv0"], stride=2))
    taps.append(h)
    h = _fire(_fire(_maxpool_ceil(h), params["fire0"]), params["fire1"])
    taps.append(h)
    h = _fire(_fire(_maxpool_ceil(h), params["fire2"]), params["fire3"])
    taps.append(h)
    h = _maxpool_ceil(h)
    for i in range(4, 8):
        h = _fire(h, params[f"fire{i}"])
        taps.append(h)
    return [t.permute(0, 2, 3, 1) for t in taps]


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(feat.square(), dim=-1, keepdim=True))
    return feat / (norm + eps)


def lpips_distance_per_sample(
    params: dict[str, Any], x: torch.Tensor, y: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-sample [B] LPIPS distances (for masked batch means), f32."""
    if min(x.shape[1], x.shape[2]) < MIN_SIDE:
        raise ValueError(
            f"LPIPS SqueezeNet trunk needs inputs >= {MIN_SIDE} px per side, got "
            f"{x.shape[1]}x{x.shape[2]}"
        )
    x = ensure_three_channels(x.float())
    y = ensure_three_channels(y.float())
    # one trunk pass over both inputs: half the launches of two passes
    feats = lpips_features(params, torch.cat([x, y], dim=0), compute_dtype)
    b = x.shape[0]
    total = torch.zeros(b, dtype=torch.float32, device=x.device)
    for i, feat in enumerate(feats):
        feat = _unit_normalize(feat.float())
        diff = (feat[:b] - feat[b:]).square()
        w = params[f"lin{i}"]["w"].float()
        total = total + torch.sum(diff * w, dim=-1).mean(dim=(1, 2))
    return total


def lpips_distance_per_sample_3d(
    params: dict[str, Any], x: torch.Tensor, y: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-sample [B] "fake-3D" LPIPS of NDHWC volumes (JAX
    ``lpips_distance_per_sample_3d``): the 2-D distance of every axis-aligned
    slice, averaged per slicing axis, the three axes summed (MONAI adds its
    sagittal, coronal and axial losses). All slices are used, so the result
    is deterministic: the JAX package's documented divergence from MONAI's
    random ``fake_3d_ratio``."""
    if x.dim() != 5:
        raise ValueError(f"expected NDHWC volume, got shape {tuple(x.shape)}")
    b = x.shape[0]
    total = torch.zeros(b, dtype=torch.float32, device=x.device)
    for axis in (1, 2, 3):
        # the slicing axis next to the batch, folded into it
        xs, ys = x.movedim(axis, 1), y.movedim(axis, 1)
        n = xs.shape[1]
        per_slice = lpips_distance_per_sample(params, xs.reshape(b * n, *xs.shape[2:]),
                                              ys.reshape(b * n, *ys.shape[2:]), compute_dtype)
        total = total + per_slice.reshape(b, n).mean(dim=1)
    return total


def lpips_distance(params: dict[str, Any], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Scalar LPIPS distance, mean over the batch (MONAI PerceptualLoss
    contract). Inputs: NHWC, 1 or 3 channels, any real range."""
    return lpips_distance_per_sample(params, x, y).mean()
