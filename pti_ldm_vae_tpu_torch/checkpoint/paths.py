"""The one rule by which the port finds a checkpoint file from a path.

The JAX package writes its weights as orbax directories
(``trained_weights/autoencoder_last``, ``diffusion_last``, ``head_best``),
and the shipped configs name those paths (``vae.checkpoint`` of
``config/ldm_dente.json`` and the regression configs). The port writes and
reads ``.pth`` files. :func:`resolve_checkpoint` lets one path serve both:

1. a file is loaded as it is;
2. otherwise, if ``path + ".pth"`` is a file, that file is loaded: the port's
   own ``autoencoder_last.pth`` under a config's ``.../autoencoder_last``, or
   the ``.pth`` that ``tools/export_jax_checkpoint.py`` writes beside a JAX
   orbax directory;
3. otherwise a directory raises ``ValueError``, naming the export command for
   the kind of checkpoint (an orbax directory needs JAX to read);
4. otherwise ``FileNotFoundError``.
"""

from __future__ import annotations

import os

__all__ = ["resolve_checkpoint", "EXPORT_COMMANDS"]

# the export of a JAX orbax directory into the .pth beside it, per kind
EXPORT_COMMANDS = {
    "vae": "python tools/export_jax_checkpoint.py vae {path} VAE_CONFIG.json",
    "diffusion": "python tools/export_jax_checkpoint.py diffusion {path} LDM_CONFIG.json",
    "head": "python tools/export_jax_checkpoint.py head {path} REGRESSION_CONFIG.json",
}


def resolve_checkpoint(path: str | os.PathLike, kind: str) -> str:
    """The file a checkpoint ``path`` of ``kind`` (``vae``, ``diffusion`` or
    ``head``) names, by the rule of the module docstring."""
    if kind not in EXPORT_COMMANDS:
        raise ValueError(f"checkpoint kind {kind!r} not in {sorted(EXPORT_COMMANDS)}")
    path = str(path)
    if os.path.isfile(path):
        return path
    if os.path.isfile(path + ".pth"):
        return path + ".pth"
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?) and {path}.pth "
            "does not exist; the PyTorch port loads .pth files only. Export it where JAX is "
            f"installed: {EXPORT_COMMANDS[kind].format(path=path)}")
    raise FileNotFoundError(f"no {kind} checkpoint at {path} (nor {path}.pth)")
