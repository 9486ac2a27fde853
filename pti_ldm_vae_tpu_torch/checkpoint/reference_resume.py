"""Resume training from a REFERENCE full checkpoint (torch ``.pth``;
counterpart of ``pti_ldm_vae_tpu/checkpoint/reference_resume.py``).

The reference's ``checkpoint_epoch{N}.pth`` carries both model state dicts,
both Adam optimizer state dicts and the loop counters
(``vae_scripts/train_vae.py:740-765``; resume path ``:309-339``). The port's
models use MONAI's parameter names and its optimizers are
``torch.optim.Adam`` like the reference's, so everything loads as it is:
weights with ``strict=True``, ``exp_avg`` / ``exp_avg_sq`` / ``step`` straight
into the optimizers (parameters are indexed by their position in
``model.parameters()``, which is the state dict's key order: these models
carry no buffers). A run started under the torch reference continues here
mid-optimizer-trajectory. Under tensor sharding each rank loads its blocks of
the whole tensors (``checkpoint/manager.py:load_whole``).
"""

from __future__ import annotations

import torch

from ..train.state import GanTrainState
from .torch_convert import monai_state_dict

__all__ = ["load_reference_checkpoint"]


def load_reference_checkpoint(path: str, state: GanTrainState) -> dict:
    """Load a reference ``checkpoint_epoch{N}.pth`` into ``state`` in place:
    the autoencoder and its Adam state always; the discriminator and its Adam
    state when ``state`` has a discriminator and the file holds one (a file
    that predates the discriminator leaves the live, freshly initialized one
    and its optimizer untouched, as the reference does,
    ``train_vae.py:320-325``).

    Returns ``{"epoch", "best_val_loss", "total_step"}``; ``total_step``
    falls back to the generator optimizer's step count."""
    device = next(state.model_g.parameters()).device
    raw = torch.load(path, map_location=device, weights_only=True)
    for key in ("autoencoder_state_dict", "optimizer_g_state_dict", "epoch"):
        if key not in raw:
            raise KeyError(f"{path} is not a reference full checkpoint (missing {key!r}; "
                           f"have {sorted(raw)[:6]})")
    from .manager import load_whole

    load_whole(state.model_g, monai_state_dict(raw), state.optimizer_g,
               raw["optimizer_g_state_dict"])
    steps = [int(entry["step"]) for entry in raw["optimizer_g_state_dict"].get("state", {}).values()]
    count_g = max(steps, default=0)
    state.step = count_g

    disc_sd = raw.get("discriminator_state_dict")
    if state.model_d is not None and disc_sd:
        load_whole(state.model_d, disc_sd, state.optimizer_d, raw.get("optimizer_d_state_dict"))
    return {
        "epoch": int(raw["epoch"]),
        "best_val_loss": float(raw.get("best_val_loss", 100.0)),
        "total_step": int(raw.get("total_step", count_g)),
    }
