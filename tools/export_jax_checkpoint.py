#!/usr/bin/env python
"""Export weights trained by the JAX package (orbax directories) into the
PyTorch port: each command writes ``<DIR>.pth`` beside the directory ``DIR``.

    # the VAE (train_vae's autoencoder_last / autoencoder_epoch{N}; a full
    # train-state tree with "params_g" is accepted too): a MONAI-keyed state dict
    python tools/export_jax_checkpoint.py vae DIR VAE_CONFIG.json

    # the diffusion UNet and its condition projector (train_diffusion's
    # diffusion_last): {"unet": MONAI-keyed state dict, "projector": state dict or None}
    python tools/export_jax_checkpoint.py diffusion DIR LDM_CONFIG.json

    # a regression head (head_best / head_last with its DIR.json sidecar):
    # {"regressor_state_dict", "targets", "epoch", "latent_dim"}; the config's
    # regressor_def.dropout places the Linear layers in the head's mlp.{i} keys
    python tools/export_jax_checkpoint.py head DIR REGRESSION_CONFIG.json

The payloads are the ones the port's own CLIs write (``train_vae``,
``train_diffusion``, ``save_regression_checkpoint``), so the port's loaders
take them as they are. Because the port resolves a checkpoint path ``P`` to
``P.pth`` when ``P`` is not a file (``checkpoint/paths.py``), the configs and
command lines that name the orbax directory keep working unedited.

This is the bridge between the two packages: it needs JAX (to read orbax) and
the port's converters, so it runs where both are installed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Any

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from pti_ldm_vae_tpu.checkpoint.orbax_io import load_pytree  # noqa: E402
from pti_ldm_vae_tpu_torch.checkpoint.manager import save_atomic  # noqa: E402
from pti_ldm_vae_tpu_torch.checkpoint.regressor_convert import (  # noqa: E402
    regressor_state_dict_from_flax,
)
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import state_dict_from_flax  # noqa: E402
from pti_ldm_vae_tpu_torch.checkpoint.unet_convert import (  # noqa: E402
    projector_state_dict_from_flax,
    unet_state_dict_from_flax,
)
from pti_ldm_vae_tpu_torch.config import load_config  # noqa: E402
from pti_ldm_vae_tpu_torch.utils.regression_utils import extract_regressor_def_config  # noqa: E402

__all__ = ["export_vae", "export_diffusion", "export_head", "main"]


def _numpy_tree(path: str) -> Any:
    """The orbax tree at ``path`` with numpy leaves."""
    import jax

    return jax.tree_util.tree_map(np.asarray, load_pytree(str(path)))


def _out_path(directory: str) -> str:
    directory = str(directory).rstrip("/")
    if not os.path.isdir(directory):
        raise NotADirectoryError(f"{directory} is not an orbax checkpoint directory")
    return directory + ".pth"


def export_vae(directory: str, config_file: str) -> str:
    """``DIR`` (an autoencoder tree, or a train state holding ``params_g``)
    -> ``DIR.pth``, a MONAI-keyed state dict."""
    out = _out_path(directory)
    tree = _numpy_tree(directory)
    if "params_g" in tree:  # a full train-state checkpoint
        tree = tree["params_g"]
    state = state_dict_from_flax(tree, load_config(config_file)["autoencoder_def"])
    save_atomic(state, out)
    return out


def export_diffusion(directory: str, config_file: str) -> str:
    """``DIR`` (``{"unet", "projector"?}`` trees) -> ``DIR.pth``,
    ``{"unet", "projector"}`` as the port's ``train_diffusion`` writes it."""
    out = _out_path(directory)
    tree = _numpy_tree(directory)
    unet = unet_state_dict_from_flax(tree["unet"], load_config(config_file)["diffusion_def"])
    projector = projector_state_dict_from_flax(tree["projector"]) if "projector" in tree else None
    save_atomic({"unet": unet, "projector": projector}, out)
    return out


def export_head(directory: str, config_file: str) -> str:
    """``DIR`` (the head's Flax tree) and ``DIR.json`` (targets, epoch,
    latent_dim) -> ``DIR.pth`` as the port's ``save_regression_checkpoint``
    writes it."""
    out = _out_path(directory)
    meta_path = Path(str(directory).rstrip("/") + ".json")
    meta = json.loads(meta_path.read_text(encoding="utf-8")) if meta_path.exists() else {}
    dropout = float(extract_regressor_def_config(load_config(config_file))["dropout"]) > 0
    state = regressor_state_dict_from_flax(_numpy_tree(directory), dropout=dropout)
    save_atomic({"regressor_state_dict": state, "targets": list(meta.get("targets") or []),
                 "epoch": meta.get("epoch"), "latent_dim": meta.get("latent_dim")}, out)
    return out


EXPORTS = {"vae": export_vae, "diffusion": export_diffusion, "head": export_head}


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="Export a JAX orbax checkpoint to DIR.pth.")
    parser.add_argument("kind", choices=sorted(EXPORTS))
    parser.add_argument("directory", help="orbax checkpoint directory of the JAX package")
    parser.add_argument("config_file", help="the VAE, LDM or regression config it was trained with")
    args = parser.parse_args(argv)
    out = EXPORTS[args.kind](args.directory, args.config_file)
    print(f"Wrote {out}")
    return out


if __name__ == "__main__":
    main()
