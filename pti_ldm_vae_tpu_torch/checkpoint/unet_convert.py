"""MONAI ``DiffusionModelUNet`` key layout, weights carried across from the
JAX package's tree, and the port's diffusion checkpoint.

The port's own copy of ``unet_monai_layout``, ``unet_expected_torch_keys``,
``canonicalize_torch_key`` and the ``_ALTERNATES`` spellings of
``pti_ldm_vae_tpu/checkpoint/unet_convert.py`` (the port imports nothing of
the JAX package). ``models/unet.py`` names its submodules so that
``DiffusionUNet.state_dict()`` holds exactly ``unet_expected_torch_keys``.

* ``unet_state_dict_from_flax(variables, config)``: the JAX package's
  ``DiffusionUNet`` tree (numpy leaves) -> the port's MONAI-keyed state dict;
  ``projector_state_dict_from_flax``: its ``ConditionProjector`` -> the
  port's (``weight``, ``bias``).
* The diffusion checkpoint (``train_diffusion`` writes it,
  ``sample_diffusion`` reads it) is one ``.pth`` holding
  ``{"unet": MONAI-keyed state dict, "projector": state dict or None}``; the
  JAX package reads its ``"unet"`` entry through ``unet_from_torch_state_dict``.
  Orbax directories need JAX to read: ``tools/export_jax_checkpoint.py
  diffusion`` writes the ``.pth`` beside one.

Supported: ``with_conditioning=True`` configs, as in the JAX package (MONAI
uses other block classes without conditioning).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .paths import resolve_checkpoint
from .torch_convert import _oihw, _tensor

__all__ = [
    "canonicalize_torch_key",
    "load_diffusion_checkpoint",
    "projector_state_dict_from_flax",
    "unet_expected_torch_keys",
    "unet_monai_layout",
    "unet_state_dict_from_flax",
]

# Accepted alternate spellings for MONAI prefixes (torch key families whose
# names shifted between generative-models releases).
_ALTERNATES = {
    ".to_out.0": (".out_proj",),
    ".downsampler.op.conv": (".downsamplers.0.op.conv", ".downsampler.conv"),
    ".upsampler.conv.conv": (".upsamplers.0.conv.conv", ".upsampler.conv"),
}


def unet_monai_layout(config: dict) -> list[tuple[str, str, str]]:
    """Ordered [(flax_spec, monai_prefix, kind)].

    flax_spec: '/'-joined module path; a ``:prefix`` suffix addresses the
    inline ``{prefix}_scale``/``{prefix}_bias`` params the JAX modules carry
    for group norms. kind: 'conv' | 'linear' | 'linear_nb' | 'inorm' | 'lnorm'.
    """
    if not config.get("with_conditioning", True):
        raise NotImplementedError(
            "unet converter covers with_conditioning=True configs "
            "(MONAI uses different block classes without conditioning)"
        )
    channels = list(config["channels"])
    nrb = config.get("num_res_blocks", 2)
    attn = list(config["attention_levels"])
    out: list[tuple[str, str, str]] = [
        ("time_mlp_1", "time_embed.0", "linear"),
        ("time_mlp_2", "time_embed.2", "linear"),
        ("conv_in", "conv_in.conv", "conv"),
    ]

    def res(flax: str, monai: str, has_skip: bool):
        yield (f"{flax}:norm1", f"{monai}.norm1", "inorm")
        yield (f"{flax}/conv1", f"{monai}.conv1.conv", "conv")
        yield (f"{flax}/time_emb_proj", f"{monai}.time_emb_proj", "linear")
        yield (f"{flax}:norm2", f"{monai}.norm2", "inorm")
        yield (f"{flax}/conv2", f"{monai}.conv2.conv", "conv")
        if has_skip:
            yield (f"{flax}/skip", f"{monai}.skip_connection.conv", "conv")

    def attn_block(flax: str, monai: str):
        yield (f"{flax}:norm", f"{monai}.norm", "inorm")
        yield (f"{flax}/proj_in", f"{monai}.proj_in.conv", "conv")
        tb = f"{monai}.transformer_blocks.0"
        blk = f"{flax}/block"
        yield (f"{blk}/norm1", f"{tb}.norm1", "lnorm")
        for name in ("q", "k", "v"):
            yield (f"{blk}/attn1_{name}", f"{tb}.attn1.to_{name}", "linear_nb")
        yield (f"{blk}/attn1_out", f"{tb}.attn1.to_out.0", "linear")
        yield (f"{blk}/norm2", f"{tb}.norm2", "lnorm")
        for name in ("q", "k", "v"):
            yield (f"{blk}/attn2_{name}", f"{tb}.attn2.to_{name}", "linear_nb")
        yield (f"{blk}/attn2_out", f"{tb}.attn2.to_out.0", "linear")
        yield (f"{blk}/norm3", f"{tb}.norm3", "lnorm")
        yield (f"{blk}/ff_in", f"{tb}.ff.net.0.proj", "linear")
        yield (f"{blk}/ff_out", f"{tb}.ff.net.2", "linear")
        yield (f"{flax}/proj_out", f"{monai}.proj_out.conv", "conv")

    in_ch = channels[0]
    for i, ch in enumerate(channels):
        for j in range(nrb):
            out += list(res(f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}", in_ch != ch))
            in_ch = ch
            if attn[i]:
                out += list(attn_block(f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}"))
        if i != len(channels) - 1:
            out.append((f"down_{i}_downsample", f"down_blocks.{i}.downsampler.op.conv", "conv"))

    out += list(res("mid_res_1", "middle_block.resnet_1", False))
    out += list(attn_block("mid_attn", "middle_block.attention"))
    out += list(res("mid_res_2", "middle_block.resnet_2", False))

    for idx, level in enumerate(reversed(range(len(channels)))):
        ch = channels[level]
        for j in range(nrb + 1):
            # up-path resnets always see concatenated skip input -> 1x1 skip conv
            out += list(res(f"up_{level}_res_{j}", f"up_blocks.{idx}.resnets.{j}", True))
            if attn[level]:
                out += list(attn_block(f"up_{level}_attn_{j}", f"up_blocks.{idx}.attentions.{j}"))
        if level != 0:
            out.append((f"up_{level}_upsample", f"up_blocks.{idx}.upsampler.conv.conv", "conv"))

    out += [(":norm_out", "out.0", "inorm"), ("conv_out", "out.2.conv", "conv")]
    return out


def unet_expected_torch_keys(config: dict) -> list[str]:
    """The torch key set of the layout (canonical spellings)."""
    keys: list[str] = []
    for _, monai, kind in unet_monai_layout(config):
        if kind == "linear_nb":
            keys.append(f"{monai}.weight")
        else:
            keys += [f"{monai}.weight", f"{monai}.bias"]
    return keys


def canonicalize_torch_key(key: str) -> str:
    """Map a known alternate MONAI spelling back to its canonical key."""
    for canon, alts in _ALTERNATES.items():
        if canon in key:
            return key  # already canonical (guards substring alternates)
        for alt in alts:
            if alt in key:
                return key.replace(alt, canon)
    return key


def _get(tree: dict, path: str, leaf: str) -> np.ndarray:
    node = tree
    for part in [p for p in path.split("/") if p]:
        node = node[part]
    return np.asarray(node[leaf])


def _split_spec(spec: str) -> tuple[str, str | None]:
    if ":" in spec:
        path, prefix = spec.split(":")
        return path, prefix
    return spec, None


def unet_state_dict_from_flax(variables: dict, config: dict) -> dict[str, torch.Tensor]:
    """The JAX package's ``DiffusionUNet`` ``{"params": ...}`` tree (numpy
    leaves) -> the port's MONAI-keyed state dict (f32 tensors)."""
    params = variables.get("params", variables)
    sd: dict[str, torch.Tensor] = {}
    for spec, monai, kind in unet_monai_layout(config):
        path, prefix = _split_spec(spec)
        if kind == "conv":
            sd[f"{monai}.weight"] = _tensor(_oihw(_get(params, path, "kernel")))
            sd[f"{monai}.bias"] = _tensor(_get(params, path, "bias"))
        elif kind in ("linear", "linear_nb"):
            sd[f"{monai}.weight"] = _tensor(_get(params, path, "kernel").T)
            if kind == "linear":
                sd[f"{monai}.bias"] = _tensor(_get(params, path, "bias"))
        elif kind == "lnorm":
            sd[f"{monai}.weight"] = _tensor(_get(params, path, "scale"))
            sd[f"{monai}.bias"] = _tensor(_get(params, path, "bias"))
        elif kind == "inorm":
            sd[f"{monai}.weight"] = _tensor(_get(params, path, f"{prefix}_scale"))
            sd[f"{monai}.bias"] = _tensor(_get(params, path, f"{prefix}_bias"))
        else:  # pragma: no cover
            raise AssertionError(kind)
    return sd


def projector_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX package's ``ConditionProjector`` tree (one ``Dense``) -> the
    port's ``ConditionProjector`` state dict (``weight`` [out, in], ``bias``)."""
    params = variables.get("params", variables)
    (dense,) = params.values()
    return {"weight": _tensor(np.asarray(dense["kernel"]).T), "bias": _tensor(dense["bias"])}


def load_diffusion_checkpoint(path: str) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor] | None]:
    """(unet state dict with canonical keys, projector state dict or None)
    from the port's ``.pth`` diffusion checkpoint, found by
    ``checkpoint/paths.py:resolve_checkpoint`` (the JAX package's
    ``diffusion_last`` finds the ``diffusion_last.pth`` exported beside it)."""
    path = resolve_checkpoint(path, "diffusion")
    payload: dict[str, Any] = torch.load(path, map_location="cpu", weights_only=True)
    if "unet" not in payload:
        raise KeyError(f"{path}: no 'unet' entry (keys {sorted(payload)[:5]})")
    unet = {canonicalize_torch_key(k): torch.as_tensor(v) for k, v in payload["unet"].items()}
    return unet, payload.get("projector")
