"""Weights into the port: Flax parameter trees and MONAI ``.pth`` state dicts.

Counterpart of ``pti_ldm_vae_tpu/checkpoint/torch_convert.py``. The port's
``AutoencoderKL`` uses MONAI's parameter names, so:

* :func:`state_dict_from_flax` carries the JAX package's ``{"params": ...}``
  tree (numpy arrays) across: conv kernels HWIO -> OIHW, Dense kernels
  [in, out] -> [out, in], GroupNorm scale/bias -> weight/bias — the mapping of
  the JAX package's ``to_torch_state_dict``;
* :func:`monai_state_dict` takes a reference ``.pth`` payload, raw or wrapped
  in ``{"autoencoder_state_dict": ...}``, and splits MONAI's fused ``qkv``
  attention projection (``use_combined_linear``) into ``to_q/to_k/to_v``.

Both return a state dict that ``AutoencoderKL.load_state_dict(...,
strict=True)`` takes. :func:`disc_state_dict_from_flax` does the same for the
PatchGAN discriminator (:func:`disc_monai_layout` is its key layout). :func:`monai_layout` is the port's own copy of the key
layout (MONAI 1.5.1, documented in ``docs/MONAI_NOTES.md``).

:func:`lpips_params_from_jax` carries the JAX package's LPIPS parameter tree
across (HWIO conv kernels -> OIHW), and :func:`lpips_params_from_npz` reads
the ``.npz`` file of converted pretrained weights that both packages load.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["monai_layout", "state_dict_from_flax", "monai_state_dict", "disc_monai_layout",
           "disc_state_dict_from_flax", "lpips_params_from_jax", "lpips_params_from_npz"]


def _levels(config: dict) -> tuple[list[int], list[int], list[bool]]:
    channels = list(config["channels"])
    nrb = config.get("num_res_blocks", 2)
    num_res_blocks = [nrb] * len(channels) if isinstance(nrb, int) else list(nrb)
    attn = config.get("attention_levels")
    attention_levels = [False] * len(channels) if attn is None else list(attn)
    return channels, num_res_blocks, attention_levels


def monai_layout(config: dict) -> list[tuple[str, str, str]]:
    """Ordered [(flax_path, monai_prefix, kind)] for the whole model.

    kind: 'conv' (Convolution wrapper), 'norm' (GroupNorm), 'attn'
    (SpatialAttentionBlock projections). flax_path is the '/'-joined module
    path of the JAX package's model."""
    channels, num_res_blocks, attention_levels = _levels(config)
    n_levels = len(channels)
    enc_attn = config.get("with_encoder_nonlocal_attn", True)
    dec_attn = config.get("with_decoder_nonlocal_attn", True)
    out: list[tuple[str, str, str]] = []

    def res_entries(flax_base: str, monai_base: str, in_ch: int, out_ch: int):
        out.append((f"{flax_base}/norm1", f"{monai_base}.norm1", "norm"))
        out.append((f"{flax_base}/conv1", f"{monai_base}.conv1.conv", "conv"))
        out.append((f"{flax_base}/norm2", f"{monai_base}.norm2", "norm"))
        out.append((f"{flax_base}/conv2", f"{monai_base}.conv2.conv", "conv"))
        if in_ch != out_ch:
            out.append((f"{flax_base}/nin_shortcut", f"{monai_base}.nin_shortcut.conv", "conv"))

    def attn_entries(flax_base: str, monai_base: str):
        out.append((f"{flax_base}/norm", f"{monai_base}.norm", "norm"))
        out.append((flax_base, f"{monai_base}.attn", "attn"))

    # ----- encoder ------------------------------------------------------
    n = 0
    out.append(("encoder/conv_in", f"encoder.blocks.{n}.conv", "conv")); n += 1
    in_ch = channels[0]
    for level in range(n_levels):
        out_ch = channels[level]
        for block in range(num_res_blocks[level]):
            res_entries(f"encoder/down_{level}_res_{block}", f"encoder.blocks.{n}", in_ch, out_ch)
            n += 1
            in_ch = out_ch
            if attention_levels[level]:
                attn_entries(f"encoder/down_{level}_attn_{block}", f"encoder.blocks.{n}")
                n += 1
        if level != n_levels - 1:
            out.append(
                (f"encoder/down_{level}_downsample/conv", f"encoder.blocks.{n}.conv.conv", "conv")
            )
            n += 1
    if enc_attn:
        res_entries("encoder/mid_res_1", f"encoder.blocks.{n}", channels[-1], channels[-1]); n += 1
        attn_entries("encoder/mid_attn", f"encoder.blocks.{n}"); n += 1
        res_entries("encoder/mid_res_2", f"encoder.blocks.{n}", channels[-1], channels[-1]); n += 1
    out.append(("encoder/norm_out", f"encoder.blocks.{n}", "norm")); n += 1
    out.append(("encoder/conv_out", f"encoder.blocks.{n}.conv", "conv")); n += 1

    # ----- quant convs ----------------------------------------------------
    out.append(("quant_conv_mu", "quant_conv_mu.conv", "conv"))
    out.append(("quant_conv_log_sigma", "quant_conv_log_sigma.conv", "conv"))
    out.append(("post_quant_conv", "post_quant_conv.conv", "conv"))

    # ----- decoder --------------------------------------------------------
    rev_channels = list(reversed(channels))
    rev_blocks = list(reversed(num_res_blocks))
    rev_attn = list(reversed(attention_levels))
    n = 0
    out.append(("decoder/conv_in", f"decoder.blocks.{n}.conv", "conv")); n += 1
    if dec_attn:
        res_entries("decoder/mid_res_1", f"decoder.blocks.{n}", rev_channels[0], rev_channels[0]); n += 1
        attn_entries("decoder/mid_attn", f"decoder.blocks.{n}"); n += 1
        res_entries("decoder/mid_res_2", f"decoder.blocks.{n}", rev_channels[0], rev_channels[0]); n += 1
    in_ch = rev_channels[0]
    for level in range(n_levels):
        out_ch = rev_channels[level]
        for block in range(rev_blocks[level]):
            res_entries(f"decoder/up_{level}_res_{block}", f"decoder.blocks.{n}", in_ch, out_ch)
            n += 1
            in_ch = out_ch
            if rev_attn[level]:
                attn_entries(f"decoder/up_{level}_attn_{block}", f"decoder.blocks.{n}")
                n += 1
        if level != n_levels - 1:
            out.append(
                (f"decoder/up_{level}_upsample/conv", f"decoder.blocks.{n}.conv.conv", "conv")
            )
            n += 1
    out.append(("decoder/norm_out", f"decoder.blocks.{n}", "norm")); n += 1
    out.append(("decoder/conv_out", f"decoder.blocks.{n}.conv", "conv")); n += 1
    return out


def _get(tree: dict, path: str, leaf: str) -> np.ndarray:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node[leaf])


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def state_dict_from_flax(variables: dict, config: dict) -> dict[str, torch.Tensor]:
    """JAX ``{"params": ...}`` tree (numpy leaves) -> the port's MONAI-keyed
    state dict."""
    params = variables.get("params", variables)
    sd: dict[str, torch.Tensor] = {}
    for flax_path, monai_prefix, kind in monai_layout(config):
        if kind == "conv":
            k = _get(params, flax_path, "kernel")  # (*K, I, O) -> (O, I, *K)
            sd[f"{monai_prefix}.weight"] = _tensor(_oihw(k))
            sd[f"{monai_prefix}.bias"] = _tensor(_get(params, flax_path, "bias"))
        elif kind == "norm":
            sd[f"{monai_prefix}.weight"] = _tensor(_get(params, flax_path, "scale"))
            sd[f"{monai_prefix}.bias"] = _tensor(_get(params, flax_path, "bias"))
        else:  # attn
            for name in ("to_q", "to_k", "to_v"):
                sd[f"{monai_prefix}.{name}.weight"] = _tensor(_get(params, f"{flax_path}/{name}", "kernel").T)
                sd[f"{monai_prefix}.{name}.bias"] = _tensor(_get(params, f"{flax_path}/{name}", "bias"))
            sd[f"{monai_prefix}.out_proj.weight"] = _tensor(_get(params, f"{flax_path}/proj_attn", "kernel").T)
            sd[f"{monai_prefix}.out_proj.bias"] = _tensor(_get(params, f"{flax_path}/proj_attn", "bias"))
    return sd


def _oihw(kernel: np.ndarray) -> np.ndarray:
    """Flax conv kernel (*K, I, O) -> torch (O, I, *K)."""
    return np.transpose(kernel, (kernel.ndim - 1, kernel.ndim - 2, *range(kernel.ndim - 2)))


def disc_monai_layout(num_layers_d: int = 3) -> list[tuple[str, str, bool]]:
    """Ordered [(flax_module, monai_prefix, has_bias)] of the PatchDiscriminator.

    MONAI names its Sequential children ``initial_conv``, ``"0"`` ...
    ``str(num_layers_d-1)``, ``final_conv``; only the first and the last
    convolution carry a bias."""
    out = [("conv_0", "initial_conv.conv", True)]
    for layer in range(num_layers_d - 1):
        out.append((f"conv_{layer + 1}", f"{layer}.conv", False))
    out.append(("conv_penultimate", f"{num_layers_d - 1}.conv", False))
    out.append(("conv_final", "final_conv.conv", True))
    return out


def disc_state_dict_from_flax(variables: dict, num_layers_d: int = 3) -> dict[str, torch.Tensor]:
    """The JAX package's PatchDiscriminator ``{"params": ...}`` tree (numpy
    leaves) -> the port's MONAI-keyed state dict (kernels HWIO -> OIHW)."""
    params = variables.get("params", variables)
    sd: dict[str, torch.Tensor] = {}
    for flax_name, monai_prefix, has_bias in disc_monai_layout(num_layers_d):
        sd[f"{monai_prefix}.weight"] = _tensor(_oihw(np.asarray(params[flax_name]["kernel"])))
        if has_bias:
            sd[f"{monai_prefix}.bias"] = _tensor(np.asarray(params[flax_name]["bias"]))
    return sd


def monai_state_dict(payload: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Reference ``.pth`` payload (raw, or ``{"autoencoder_state_dict": ...}``)
    -> the port's state dict, with fused ``qkv`` projections split."""
    raw = payload.get("autoencoder_state_dict", payload)
    sd = {k: torch.as_tensor(v) for k, v in raw.items()}
    for key in [k for k in sd if k.endswith(".qkv.weight")]:
        prefix = key[: -len(".qkv.weight")]
        w = sd.pop(key)
        b = sd.pop(f"{prefix}.qkv.bias", torch.zeros(w.shape[0], dtype=w.dtype))
        c = w.shape[0] // 3
        for i, name in enumerate(("to_q", "to_k", "to_v")):
            sd[f"{prefix}.{name}.weight"] = w[i * c:(i + 1) * c].clone()
            sd[f"{prefix}.{name}.bias"] = b[i * c:(i + 1) * c].clone()
    return sd


def lpips_params_from_jax(tree: dict[str, Any]) -> dict[str, Any]:
    """The JAX package's LPIPS tree (numpy leaves; ``conv0``,
    ``fire{i}/{squeeze,expand1,expand3}`` with HWIO ``w`` and ``b``,
    ``lin{i}/w``, ``_pretrained``) -> the port's LPIPS parameters: the same
    nesting, f32 tensors, conv kernels OIHW."""
    out: dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = lpips_params_from_jax(value)
        else:
            a = np.asarray(value, dtype=np.float32)
            out[key] = _tensor(np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a)
    return out


def lpips_params_from_npz(path: str) -> dict[str, Any]:
    """LPIPS parameters from a converted-weights ``.npz`` (flat keys
    ``conv0/w``, ``fire0/squeeze/b``, ``lin0/w``, ...; HWIO kernels), marked
    pretrained."""
    tree: dict[str, Any] = {}
    with np.load(path) as raw:
        for key in raw.files:
            parts = key.split("/")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = raw[key]
    tree["_pretrained"] = np.ones((), dtype=np.float32)
    return lpips_params_from_jax(tree)
