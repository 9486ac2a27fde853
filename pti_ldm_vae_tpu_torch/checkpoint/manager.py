"""Best/last checkpoint bookkeeping on ``torch.save`` (counterpart of
``pti_ldm_vae_tpu/checkpoint/orbax_io.py:CheckpointManager``).

Reference behavior (``train_vae.py:675-769``):

* every validation: overwrite ``autoencoder_last.pth`` and, with a
  discriminator, ``discriminator_last.pth``;
* on val improvement: write ``autoencoder_epoch{N}.pth`` (MONAI-keyed state
  dict), with a discriminator ``discriminator_epoch{N}.pth``, and the full
  ``checkpoint_epoch{N}.pth`` (``autoencoder_state_dict``,
  ``optimizer_g_state_dict``, with a discriminator also
  ``discriminator_state_dict`` and ``optimizer_d_state_dict``, ``epoch``,
  ``best_val_loss``, ``total_step``), then delete the previous best's files —
  the new best is on disk before the old one goes;
* resume restores both models, both optimizers, epoch, best val loss and step
  from the newest ``checkpoint_epoch{N}.pth``; a checkpoint without a
  discriminator leaves a live one as it was initialized (the reference does
  the same, ``train_vae.py:320-325``).

The files are the reference's own layout, so the inference CLI and
``utils/vae_loader.py`` read them as they are. Every file is written to a
temporary name and renamed, so a crash mid-write leaves the previous file
intact. Writes are synchronous (the JAX package writes on a background
thread; at this model's 4.6 M parameters a write is milliseconds). A failed
write leaves a ``CHECKPOINT_WRITE_FAILED`` marker in the directory before the
error propagates; the marker is reported at the next start and cleared by the
next successful write.

Under a process group rank 0 alone writes; every rank keeps the same
bookkeeping (the validation loss is the global batch's, so the best epoch is
the same everywhere) and waits at a barrier after each save, so that no rank
reads a checkpoint before it is on disk. A resume loads the files on every
rank.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Any

import torch

from ..parallel.mesh import barrier_sync
from ..parallel.tensor import (
    full_optimizer_state,
    full_state_dict,
    shard_optimizer_state,
    shard_state_dict,
    tensor,
)
from ..train.state import GanTrainState

__all__ = ["CheckpointManager", "load_whole", "save_atomic", "whole_state"]

_FULL = re.compile(r"^checkpoint_epoch(\d+)\.pth$")


def save_atomic(payload: Any, path: str) -> None:
    """``torch.save`` to ``path`` through a temporary file and a rename."""
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def whole_state(state: GanTrainState) -> dict[str, Any]:
    """The models' and optimizers' state dicts on the host, whole: under
    tensor sharding gathered over the model group (a collective: every rank
    of the group calls it). Keys ``model_g``, ``optimizer_g`` and, with a
    discriminator, ``model_d``, ``optimizer_d``."""
    pairs = [("g", state.model_g, state.optimizer_g)]
    if state.model_d is not None:
        pairs.append(("d", state.model_d, state.optimizer_d))
    out = {}
    for tag, model, optimizer in pairs:
        if tensor():
            out[f"model_{tag}"] = full_state_dict(model)
            out[f"optimizer_{tag}"] = full_optimizer_state(model, optimizer)
        else:
            out[f"model_{tag}"], out[f"optimizer_{tag}"] = model.state_dict(), optimizer.state_dict()
    return _cpu(out)


def load_whole(model: torch.nn.Module, model_sd: dict, optimizer: torch.optim.Optimizer | None = None,
               optimizer_sd: dict | None = None) -> None:
    """Load whole state dicts (the unsharded run's files) into a model and
    its optimizer, cut to this rank's blocks under tensor sharding."""
    if tensor():
        model_sd = shard_state_dict(model, model_sd)
        if optimizer_sd is not None:
            optimizer_sd = shard_optimizer_state(model, optimizer_sd)
    model.load_state_dict(model_sd, strict=True)
    if optimizer is not None and optimizer_sd is not None:
        optimizer.load_state_dict(optimizer_sd)


class CheckpointManager:
    """Best/last checkpoints of one run directory; ``rank`` 0 writes them."""

    def __init__(self, model_dir: str, rank: int = 0):
        self.model_dir = os.path.abspath(model_dir)
        self.rank = rank
        if rank == 0:
            os.makedirs(self.model_dir, exist_ok=True)
        self._sentinel = os.path.join(self.model_dir, "CHECKPOINT_WRITE_FAILED")
        if rank == 0 and os.path.exists(self._sentinel):
            print(
                f"[WARN] {self._sentinel} exists: the previous run's final checkpoint "
                "write FAILED — on-disk best/last may be stale. The marker clears on "
                "the next successful write.", file=sys.stderr, flush=True,
            )
        self.best_epoch_saved: int | None = None

    def _path(self, name: str) -> str:
        return os.path.join(self.model_dir, name)

    def _write(self, payload: Any, name: str) -> None:
        try:
            save_atomic(payload, self._path(name))
        except OSError as exc:
            try:
                with open(self._sentinel, "w", encoding="utf-8") as fh:
                    fh.write(f"[ERROR] checkpoint write failed: {exc!r}\n")
            except OSError:
                pass  # the same full disk that failed the write
            raise

    def save_epoch(self, *, state: GanTrainState, epoch: int, val_loss: float,
                   best_val_loss: float, total_step: int) -> float:
        """One epoch's checkpoint work: overwrite ``last`` and, on val
        improvement, write the per-epoch best + full resume state and delete
        the previous best. Returns the new best val loss. Every rank calls
        it; rank 0 writes, then all meet at a barrier."""
        if self.rank == 0 or tensor():
            whole = whole_state(state)
            if self.rank == 0:
                self._write_epoch(whole, epoch, val_loss, best_val_loss, total_step)
        barrier_sync("checkpoint")
        if not val_loss < best_val_loss:
            return best_val_loss
        self.best_epoch_saved = epoch
        return float(val_loss)

    def _write_epoch(self, whole: dict[str, Any], epoch: int, val_loss: float,
                     best_val_loss: float, total_step: int) -> None:
        model_sd, disc_sd = whole["model_g"], whole.get("model_d")
        self._write(model_sd, "autoencoder_last.pth")
        if disc_sd is not None:
            self._write(disc_sd, "discriminator_last.pth")
        if os.path.exists(self._sentinel):
            os.remove(self._sentinel)  # a fresh write supersedes a stale failure marker
        if not val_loss < best_val_loss:
            return
        self._write(model_sd, f"autoencoder_epoch{epoch}.pth")
        full = {
            "autoencoder_state_dict": model_sd,
            "optimizer_g_state_dict": whole["optimizer_g"],
            "epoch": int(epoch),
            "best_val_loss": float(val_loss),
            "total_step": int(total_step),
        }
        if disc_sd is not None:
            self._write(disc_sd, f"discriminator_epoch{epoch}.pth")
            full["discriminator_state_dict"] = disc_sd
            full["optimizer_d_state_dict"] = whole["optimizer_d"]
        self._write(full, f"checkpoint_epoch{epoch}.pth")
        prev_best = self.best_epoch_saved
        if prev_best is not None and prev_best != epoch:
            for name in (f"checkpoint_epoch{prev_best}.pth", f"autoencoder_epoch{prev_best}.pth",
                         f"discriminator_epoch{prev_best}.pth"):
                if os.path.exists(self._path(name)):
                    os.remove(self._path(name))

    def find_latest_full(self) -> str | None:
        """The ``checkpoint_epoch{N}.pth`` of the highest N, if any."""
        found = [(int(m.group(1)), name) for name in os.listdir(self.model_dir)
                 if (m := _FULL.match(name))]
        return self._path(max(found)[1]) if found else None

    def restore(self, state: GanTrainState) -> dict[str, Any] | None:
        """Load the newest full checkpoint into ``state`` (models, optimizers,
        step) in place; returns ``{"epoch", "best_val_loss", "total_step"}``
        or ``None`` when there is none."""
        path = self.find_latest_full()
        if path is None:
            return None
        device = next(state.model_g.parameters()).device
        raw = torch.load(path, map_location=device, weights_only=True)
        load_whole(state.model_g, raw["autoencoder_state_dict"], state.optimizer_g,
                   raw["optimizer_g_state_dict"])
        if state.model_d is not None and raw.get("discriminator_state_dict"):
            load_whole(state.model_d, raw["discriminator_state_dict"], state.optimizer_d,
                       raw.get("optimizer_d_state_dict"))
        meta = {
            "epoch": int(raw["epoch"]),
            "best_val_loss": float(raw.get("best_val_loss", 100.0)),
            "total_step": int(raw.get("total_step", 0)),
        }
        state.step = meta["total_step"]
        self.best_epoch_saved = meta["epoch"]
        return meta
