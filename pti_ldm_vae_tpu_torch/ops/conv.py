"""3x3 convolution through the hand-written kernels (counterpart of
``pti_ldm_vae_tpu/ops/pallas/conv2d.py:conv3x3`` plus the bias its caller
adds outside).

The model keeps its convolution weights as MONAI does, ``[Cout, Cin, 3, 3]``
in f32. ``conv3x3`` repacks such a parameter to the tap-major matrix
``[9*Cin, Cout]`` the kernels take (row ``(ky*3+kx)*Cin + ci``) with plain
tensor ops under autograd, so the filter gradient the kernel returns reaches
the parameter in its own layout through the repacking's backward. The matrix
is rounded to the activation dtype inside the kernel wrapper, and the filter
gradient comes back in f32, unrounded.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .kernels import conv3x3 as conv3x3_kernel

__all__ = ["conv3x3", "conv3x3_supported", "pack_weight"]


def conv3x3_supported(x_shape: Sequence[int], w_shape: Sequence[int]) -> bool:
    """Whether ``conv3x3`` takes this input and ``[Cout, Cin, 3, 3]`` weight:
    a rank-4 NHWC input, a 3x3 filter, matching channels (stride 1 and SAME
    padding are the only form it computes). No size limit: the kernels tile
    the image."""
    return (len(x_shape) == 4 and len(w_shape) == 4 and tuple(w_shape[2:]) == (3, 3)
            and x_shape[-1] == w_shape[1])


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """``[Cout, Cin, 3, 3]`` -> the tap-major matrix ``[9*Cin, Cout]``."""
    cout, cin = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(9 * cin, cout)


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """3x3 stride-1 SAME convolution of NHWC ``x`` with an OIHW ``weight``,
    plus ``bias``, in ``x``'s dtype; raises on anything else."""
    if not conv3x3_supported(x.shape, weight.shape):
        raise ValueError(f"conv3x3 takes x [B, H, W, Cin] and weight [Cout, Cin, 3, 3]; got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    y = conv3x3_kernel(x, pack_weight(weight))
    return y if bias is None else y + bias.to(y.dtype)
