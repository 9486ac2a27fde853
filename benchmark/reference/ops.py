"""The reference's primitive operations: plain PyTorch in NCHW, float32 with
TF32 off, and the two things every forward threads through them.

* ``precision``: ``"f32"`` computes as written; ``"fp8"`` rounds wherever the
  program rounds to its bfloat16 compute type (every input, weight and
  output of a convolution, a linear layer and an attention product, every
  normalization's output, every residual sum) to float8 instead, as float8
  training does: e4m3 forward, e5m2 gradients, one scale per tensor. That
  is the step below the bfloat16 the configurations state: the control of
  ``correct``.
* ``record``: a :class:`CallLog` that counts, by shape, the calls the
  program's hand-written kernels make (GroupNorm+SiLU, attention, the 3x3
  stride-1 convolutions of the autoencoder), for the roofline arithmetic of
  ``benchmark/work``.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F


def _scaled_round(t: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    scale = largest / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Forward values to float8 e4m3, gradients to float8 e5m2, each under
    one per-tensor scale."""

    @staticmethod
    def forward(ctx, t):
        return _scaled_round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _scaled_round(grad, torch.float8_e5m2, 57344.0)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


@dataclass
class CallLog:
    """Kernel calls by shape. ``gn_silu``: (B, H, W, C, backward); ``attention``:
    (B, S, D, backward); ``conv3x3``: (B, H, W, Cin, Cout, input_gradient,
    filter_gradient)."""

    gn_silu: Counter = field(default_factory=Counter)
    attention: Counter = field(default_factory=Counter)
    conv3x3: Counter = field(default_factory=Counter)


@dataclass
class Ops:
    precision: str = "f32"
    record: CallLog | None = None

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return t
        if self.precision == "fp8":
            return fp8_round(t)
        raise ValueError(f"unknown precision {self.precision!r}")

    def conv(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *, stride: int = 1,
             padding: int = 0, hand_kernel: bool = False) -> torch.Tensor:
        """``F.conv2d``. ``hand_kernel``: a 3x3 stride-1 convolution that the
        program may send to its convolution kernels (logged when recording)."""
        if self.record is not None and hand_kernel:
            bsz, cin, h, wd = x.shape
            self.record.conv3x3[(bsz, h, wd, cin, w.shape[0], x.requires_grad,
                                 w.requires_grad)] += 1
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
        return self.q(F.linear(self.q(x), self.q(w), b))

    def group_norm_silu(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int,
                        eps: float) -> torch.Tensor:
        if self.record is not None:
            bsz, c, h, wd = x.shape
            self.record.gn_silu[(bsz, h, wd, c, x.requires_grad)] += 1
        return self.q(F.silu(F.group_norm(x, groups, w, b, eps)))

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Single-head softmax attention over [B, S, D]."""
        if self.record is not None:
            self.record.attention[(q.shape[0], q.shape[1], q.shape[2], q.requires_grad)] += 1
        scores = torch.bmm(self.q(q), self.q(k).transpose(1, 2)) / math.sqrt(q.shape[-1])
        return self.q(torch.bmm(self.q(torch.softmax(scores, dim=-1)), self.q(v)))
