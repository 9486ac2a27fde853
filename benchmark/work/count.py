"""The work a cell's steps do, counted once on the plain reference at the
cell's shapes (on the ``meta`` device: shapes only, no data), so the count is
the same whatever implements a layer:

* model FLOPs: ``torch.utils.flop_counter`` over the convolutions and
  products of the forward and of what its backward needs (recomputation not
  counted), LPIPS and the discriminator included where the step runs them;
* the calls the program's hand-written kernels make, by shape, and the least
  time each could take on the card: max(operations / peak, bytes / HBM rate),
  each input byte read once and each output byte written once.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.nets import disc_logits, disc_spec, lpips_per_sample, lpips_spec
from ..reference.ops import CallLog, Ops
from ..reference.train import Objective, evaluate_batch, step_gradients
from ..reference.vae import VAE, param_spec
from .peaks import HBM_BYTES_PER_S, PEAK_FLOP_PER_S

META = torch.device("meta")


def _params(spec, grad: bool) -> dict[str, torch.Tensor]:
    return {name: torch.empty(shape, device=META, requires_grad=grad) for name, shape, _ in spec}


def _batch(vae: VAE, rows: int, patch: tuple[int, int], n_attrs: int) -> dict:
    h, w = patch
    return {"image": torch.empty((rows, h, w, 1), device=META),
            "mask": torch.ones(rows, device=META),
            "eps": torch.empty(vae.latent_shape(rows, h, w), device=META),
            "attrs": torch.empty((rows, max(n_attrs, 1)), device=META)}


def _counted(fn) -> tuple[float, CallLog]:
    log = CallLog()
    with FlopCounterMode(display=False) as counter:
        fn(Ops(record=log))
    return float(counter.get_total_flops()), log


def train_step(ae: dict, obj: Objective, rows: int, patch: tuple[int, int]):
    """One training step: the generator's forward and backward, and with
    ``adv_weight`` the discriminator's."""
    def fn(ops):
        vae = VAE(ae, ops)
        D = _params(disc_spec(), True) if obj.adv_weight is not None else None
        step_gradients(vae, obj, _params(param_spec(ae), True), D, _params(lpips_spec(), False),
                       _batch(vae, rows, patch, len(obj.ar_channels)), block_rows=rows)
    return _counted(fn)


def validation_step(ae: dict, obj: Objective, rows: int, patch: tuple[int, int]):
    """The trainer's evaluation step: the stochastic forward, LPIPS, and in
    the adversarial phase the discriminator on the reconstruction (generator
    term) and on both inputs (its own loss)."""
    def fn(ops):
        vae = VAE(ae, ops)
        b = _batch(vae, rows, patch, 0)
        with torch.no_grad():
            recon, _, _ = vae.forward(_params(param_spec(ae), False), b["image"], b["eps"])
            lpips_per_sample(ops, _params(lpips_spec(), False), recon, b["image"])
            if obj.adv_weight is not None:
                D = _params(disc_spec(), False)
                for x in (recon, recon, b["image"]):
                    disc_logits(ops, D, x)
    return _counted(fn)


def reconstruct(ae: dict, rows: int, patch: tuple[int, int]):
    """A deterministic reconstruction (decode of the posterior mean)."""
    def fn(ops):
        vae = VAE(ae, ops)
        P = _params(param_spec(ae), False)
        with torch.no_grad():
            vae.decode(P, vae.encode(P, torch.empty((rows, *patch, 1), device=META))[0])
    return _counted(fn)


def evaluation(ae: dict, rows: int, patch: tuple[int, int], perceptual_weight: float):
    """``evaluate_vae``'s batch: forward, loss terms, LPIPS, image metrics."""
    def fn(ops):
        vae = VAE(ae, ops)
        evaluate_batch(vae, _params(param_spec(ae), False), _params(lpips_spec(), False),
                       _batch(vae, rows, patch, 0), perceptual_weight, "l1", block_rows=rows)
    return _counted(fn)


def _least_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOP_PER_S[dtype], nbytes / HBM_BYTES_PER_S)


def gn_silu_bound_s(log: CallLog, dtype: str) -> float:
    """GroupNorm+SiLU: forward reads x and writes y; backward reads x and the
    output gradient and writes dx (bytes bound: a few operations an element)."""
    el = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    total = 0.0
    for (b, h, w, c, backward), calls in log.gn_silu.items():
        n = b * h * w * c
        total += calls * (2 * n + (3 * n if backward else 0)) * el / HBM_BYTES_PER_S
    return total


def attention_flops(batch: int, seq: int, channels: int) -> int:
    """FLOPs of one self-attention (scores + weighted sum)."""
    return 2 * 2 * batch * seq * seq * channels


def flash_bound_s(log: CallLog, dtype: str) -> float:
    """Attention: forward ``4 B S^2 D`` operations, reading q, k, v and writing
    o; backward 2.5 times the forward's operations, reading q, k, v, o, dO and
    writing dq, dk, dv."""
    el = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    total = 0.0
    for (b, s, d, backward), calls in log.attention.items():
        fwd = attention_flops(b, s, d)
        total += calls * _least_s(fwd, 4 * b * s * d * el, dtype)
        if backward:
            total += calls * _least_s(2.5 * fwd, 8 * b * s * d * el, dtype)
    return total


def conv3x3_bound_s(log: CallLog, dtype: str) -> float:
    """3x3 stride-1 convolutions: forward and input gradient ``2 B H W Cin Cout
    9`` operations each, reading the input (or output gradient) and the
    weights and writing the output (or input gradient); filter gradient the
    same operations, reading input and output gradient, writing a float32
    filter gradient."""
    el = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    total = 0.0
    for (b, h, w, cin, cout, dgrad, wgrad), calls in log.conv3x3.items():
        flops = 2 * b * h * w * cin * cout * 9
        x, y, k = b * h * w * cin, b * h * w * cout, cin * cout * 9
        total += calls * _least_s(flops, (x + y + k) * el, dtype)
        if dgrad:
            total += calls * _least_s(flops, (x + y + k) * el, dtype)
        if wgrad:
            total += calls * _least_s(flops, (x + y) * el + 4 * k, dtype)
    return total


def bounds(log: CallLog, dtype: str) -> dict[str, float]:
    return {"gn_silu_bound_s": gn_silu_bound_s(log, dtype),
            "flash_bound_s": flash_bound_s(log, dtype),
            "conv3x3_bound_s": conv3x3_bound_s(log, dtype)}


def scaled(parts: list[tuple[float, float, CallLog]], dtype: str,
           conv_kernel: bool) -> dict[str, float]:
    """Work of a window from (count, FLOPs, call log) of each kind of step it ran.
    The 3x3 convolutions count only where the program sends them to its kernels."""
    out = {"flops": 0.0, "gn_silu_bound_s": 0.0, "flash_bound_s": 0.0, "conv3x3_bound_s": 0.0}
    for count, flops, log in parts:
        out["flops"] += count * flops
        for key, value in bounds(log, dtype).items():
            if key != "conv3x3_bound_s" or conv_kernel:
                out[key] += count * value
    return {k: v for k, v in out.items() if not math.isclose(v, 0.0) or k == "flops"}
