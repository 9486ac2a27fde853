"""Regression-head weights into the port: the JAX package's Flax head
``{"params": {"dense_0" ... "dense_{n-1}", "dense_out": {"kernel", "bias"}}}``
(numpy arrays) -> ``LatentRegressor.state_dict()`` (``mlp.{i}.weight`` /
``mlp.{i}.bias``). Kernels [in, out] become weights [out, in]; the Linear
layers of ``mlp`` take the dense layers in order (``dense_0`` first,
``dense_out`` last), wherever activations and dropout sit between them. The
JAX package's ``load_regression_checkpoint`` maps the other way the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["regressor_state_dict_from_flax", "linear_indices"]


def linear_indices(hidden_layers: int, dropout: bool) -> list[int]:
    """Indices in ``mlp`` of the Linear layers of a head with
    ``hidden_layers`` hidden layers: each hidden layer is Linear, activation
    and, with dropout, a dropout module; the output Linear comes last."""
    stride = 3 if dropout else 2
    return [stride * i for i in range(hidden_layers + 1)]


def regressor_state_dict_from_flax(params: Any, *, dropout: bool) -> dict[str, torch.Tensor]:
    """``mlp.{i}`` state dict of the Flax head tree ``params`` (with or
    without its ``"params"`` level); ``dropout`` says whether the port's head
    has dropout modules (rate > 0), which shifts the indices."""
    tree = params.get("params", params)
    hidden = sorted((k for k in tree if k.startswith("dense_") and k != "dense_out"),
                    key=lambda k: int(k.split("_")[1]))
    names = [*hidden, "dense_out"]
    out: dict[str, torch.Tensor] = {}
    for name, idx in zip(names, linear_indices(len(hidden), dropout)):
        kernel = np.asarray(tree[name]["kernel"], dtype=np.float32)
        out[f"mlp.{idx}.weight"] = torch.tensor(kernel.T)
        out[f"mlp.{idx}.bias"] = torch.tensor(np.asarray(tree[name]["bias"], dtype=np.float32))
    return out

