"""Space-to-depth reformulation of the VAE's full-resolution levels
(counterpart of ``pti_ldm_vae_tpu/ops/space_to_depth.py``; the port's own copy
of its layout, weight transforms and ``"auto"`` policy).

A stride-1 3x3 convolution at [H, W, C] is exactly a 3x3 convolution at
[H/2, W/2, 4C] -> [.., 4O] with a structured-zero kernel built from the
original weights; GroupNorm (same ``num_groups``, scale and bias repeated 4x),
SiLU and residual adds map one to one; the (0,1)-padded stride-2 downsample
becomes a (0,1)-padded 2x2 VALID convolution that leaves the domain. The
parameters keep their canonical shapes, so ``s2d_stem`` is an apply-time
knob: one state dict serves every form.

Phase layout (load-bearing): s2d channel ``c * 4 + (2a + b)`` holds source
pixel (2i+a, 2j+b) of channel ``c`` — channel-major, phase-minor — which is
exactly ``torch.nn.functional.pixel_unshuffle(., 2)`` on the NCHW view of a
channel-last tensor. GroupNorm groups of contiguous channels then stay groups
of contiguous s2d channels.

Weight transforms take and give OIHW weights (MONAI's layout). Each is one
differentiable gather of the weight's taps plus one zero entry, at a fixed
index built once per kernel form (``_s2d_index``), so the gradient reaches
the canonical parameter through the gather's backward. Derivation (1-D; H and
W factorize): ``out[2i+a] = sum_u W[u+1] x[2i+a+u]``, u in {-1, 0, 1}; with
``2i+a+u = 2(i+r) + p``, ``u = 2r + p - a``: the s2d entry at (tap r, input
phase p, output phase a) is ``W[u+1]`` where u lies in the support, else 0.
The downsample (pad (0,1), VALID, stride 2) keeps output phase 0 only:
``u = 2r + p`` over r in {0, 1}.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

__all__ = [
    "S2D_AUTO_INFER_DECODER_MAX_BATCH",
    "S2D_AUTO_INFER_ENCODER_MAX_BATCH",
    "S2D_AUTO_TRAIN_ENCODER_MAX_BATCH",
    "depth_to_space",
    "s2d_auto_mode",
    "s2d_conv1x1_kernel",
    "s2d_conv3x3_kernel",
    "s2d_downsample_kernel",
    "s2d_repeat_channels",
    "space_to_depth",
]

# The "auto" policy on an H100: the largest batch at which each form is taken.
# The JAX package's thresholds (64 / 64 / 32) were measured on a TPU v5e, where
# the 256² small-channel convolutions starve the MXU; they say nothing of an
# H100. Until an H100 A/B sets them (chip_smoke.py's s2d_path measures the
# forms; PERF.md), "auto" takes the standard path at every batch.
S2D_AUTO_TRAIN_ENCODER_MAX_BATCH = 0
S2D_AUTO_INFER_ENCODER_MAX_BATCH = 0
S2D_AUTO_INFER_DECODER_MAX_BATCH = 0


def s2d_auto_mode(workload: str, batch: int | None) -> bool | str:
    """Resolve ``s2d_stem="auto"`` to a concrete mode (the JAX function's
    rules on the H100 thresholds above). ``workload``: ``"train"`` (gradients
    flow through the model) or ``"inference"``; ``batch``: per-device batch,
    ``None`` if unknown (train: the standard path; inference: the encoder
    form where the encoder threshold admits any batch)."""
    if workload not in ("train", "inference"):
        raise ValueError(f"workload must be 'train' or 'inference', got {workload!r}")
    if workload == "train":
        if batch is not None and batch <= S2D_AUTO_TRAIN_ENCODER_MAX_BATCH:
            return "encoder"
        return False
    if batch is None:
        return "encoder" if S2D_AUTO_INFER_ENCODER_MAX_BATCH > 0 else False
    enc = batch <= S2D_AUTO_INFER_ENCODER_MAX_BATCH
    dec = batch <= S2D_AUTO_INFER_DECODER_MAX_BATCH
    if enc and dec:
        return True
    if enc:
        return "encoder"
    if dec:
        return "decoder"
    return False


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C], channel ``c*4 + 2a + b`` holding
    pixel (2i+a, 2j+b); contiguous channel-last, as the kernel wrappers take
    it."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs even H, W; got {(h, w)}")
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth` (same phase layout), contiguous."""
    if x.shape[-1] % 4:
        raise ValueError(f"depth_to_space needs channels % 4 == 0; got {x.shape[-1]}")
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()


def s2d_repeat_channels(x: torch.Tensor) -> torch.Tensor:
    """Nearest-2x upsampling expressed in the s2d domain: every pixel fills
    all four phases, i.e. each channel repeated 4x in place (``c*4 + p``)."""
    return x.repeat_interleave(4, dim=-1)


@functools.cache
def _s2d_index(kind: str, device: torch.device) -> torch.Tensor:
    """``_build_index(kind)`` on ``device``, built outside inference mode
    whatever the caller's mode: the cached index also serves later calls that
    autograd records."""
    with torch.inference_mode(False):
        return _build_index(kind).to(device)


def _build_index(kind: str) -> torch.Tensor:
    """Per s2d entry, the flat tap (``ky*k + kx``) of the original kernel it
    copies, or the tap count (the zero entry ``_gather`` appends) where it is
    a structural zero. Shapes: ``"3x3"`` [4 out phases, 4 in phases, 3, 3],
    ``"1x1"`` [4, 4, 1, 1], ``"down"`` [4 in phases, 2, 2]."""
    if kind == "3x3":
        idx = torch.full((2, 2, 2, 2, 3, 3), 9, dtype=torch.long)  # a, b, ph, pw, r+1, s+1
        for a in (0, 1):
            for b in (0, 1):
                for ph in (0, 1):
                    for pw in (0, 1):
                        for r in (-1, 0, 1):
                            for s in (-1, 0, 1):
                                u, v = 2 * r + ph - a, 2 * s + pw - b
                                if -1 <= u <= 1 and -1 <= v <= 1:
                                    idx[a, b, ph, pw, r + 1, s + 1] = (u + 1) * 3 + (v + 1)
        return idx.reshape(4, 4, 3, 3)
    if kind == "1x1":
        idx = torch.ones(4, 4, dtype=torch.long)
        idx.fill_diagonal_(0)
        return idx.reshape(4, 4, 1, 1)
    if kind == "down":
        idx = torch.full((2, 2, 2, 2), 9, dtype=torch.long)  # ph, pw, r, s
        for ph in (0, 1):
            for pw in (0, 1):
                for r in (0, 1):
                    for s in (0, 1):
                        u, v = 2 * r + ph, 2 * s + pw
                        if u <= 2 and v <= 2:
                            idx[ph, pw, r, s] = u * 3 + v
        return idx.reshape(4, 2, 2)
    raise ValueError(f"unknown s2d kernel form {kind!r}")


def _gather(w: torch.Tensor, kind: str) -> torch.Tensor:
    """``w [O, C, k, k]`` -> ``[O, C, *index shape]``: one gather of its taps
    and a zero entry, differentiable in ``w``."""
    o, c = w.shape[:2]
    taps = F.pad(w.reshape(o, c, -1), (0, 1))  # the last entry is the structural zero
    return taps[:, :, _s2d_index(kind, w.device)]


def s2d_conv3x3_kernel(w: torch.Tensor) -> torch.Tensor:
    """``[O, C, 3, 3]`` stride-1 padding-1 kernel -> ``[4O, 4C, 3, 3]``;
    applied with padding 1 on the s2d tensor, output in the s2d domain (its
    bias: ``bias.repeat_interleave(4)``)."""
    o, c, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {(kh, kw)}")
    g = _gather(w, "3x3")  # [O, C, 4 out phases, 4 in phases, 3, 3]
    return g.permute(0, 2, 1, 3, 4, 5).reshape(4 * o, 4 * c, 3, 3)


def s2d_conv1x1_kernel(w: torch.Tensor) -> torch.Tensor:
    """``[O, C, 1, 1]`` kernel -> ``[4O, 4C, 1, 1]``, phase-diagonal."""
    o, c, kh, kw = w.shape
    if (kh, kw) != (1, 1):
        raise ValueError(f"expected a 1x1 kernel, got {(kh, kw)}")
    g = _gather(w, "1x1")  # [O, C, 4, 4, 1, 1]
    return g.permute(0, 2, 1, 3, 4, 5).reshape(4 * o, 4 * c, 1, 1)


def s2d_downsample_kernel(w: torch.Tensor) -> torch.Tensor:
    """``[O, C, 3, 3]`` kernel of the (0,1)-padded stride-2 downsample ->
    ``[O, 4C, 2, 2]``: applied after the same (0,1) pad as a VALID stride-1
    convolution on the s2d tensor, its output leaves the domain (the next
    level's half-resolution tensor)."""
    o, c, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {(kh, kw)}")
    return _gather(w, "down").reshape(o, 4 * c, 2, 2)  # [O, C, 4 in phases, 2, 2]
