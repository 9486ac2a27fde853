"""Host data pipeline: threaded decode/transform, RAM cache, sharding,
static batch shapes, prefetch.

Counterpart of ``pti_ldm_vae_tpu/data/loader.py``:

* the default transform is the JAX loader's: the native fused TIFF decode +
  area resize + mask z-score (``native/``, the same C++ source and flags, so
  the same bits) for the ``.tif/.tiff`` files the library parses, else the
  numpy path ``preprocess_image_np(read_image(...))``; every file is counted
  under ``native.decoded`` or ``native.python_path``. ``transform=`` replaces
  it with any ``path -> [H, W, 1] f32`` function,

* optional RAM cache of transformed samples (``cache_rate``: the first
  fraction of the dataset is cached),
* DistributedSampler-style index schedule (``shard_indices``): per-epoch
  seeded shuffle, pad by wrapping, ``rank::world`` interleave,
* batches are numpy dicts ``{"image": [B,H,W,1] f32, "mask": [B] f32,
  "attributes": {name: [B] f32}}`` (``attributes`` only when the loader was
  given per-image attributes aligned with ``paths``): the final partial batch
  is zero-padded to ``batch_size`` with a per-sample validity mask and
  attribute values of 0.0 (or dropped with ``drop_last``), exactly as the JAX
  loader does, and a background thread keeps two batches prefetched; while
  a profiler records, each request is a ``loader.wait`` span
  (``utils/profiling.py``) whose ``arg`` is the number of batches ready at
  the request (0: the consumer waits for the producer).

Device placement is the caller's job.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np

from .. import native
from ..utils.profiling import span
from .io import read_image
from .transforms import preprocess_image_np

__all__ = ["ShardedDataLoader", "shard_indices"]


def shard_indices(
    n: int, *, rank: int = 0, world: int = 1, shuffle: bool = False,
    seed: int = 0, epoch: int = 0,
) -> np.ndarray:
    """DistributedSampler-equivalent index schedule (``dataloaders.py:542-550``):
    optional per-epoch seeded shuffle, pad by wrapping to a multiple of
    ``world``, then interleave ``rank::world``."""
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    else:
        order = np.arange(n)
    total = -(-n // world) * world
    if total > n:
        order = np.concatenate([order, order[: total - n]])
    return order[rank::world]


class ShardedDataLoader:
    """Iterable over preprocessed, statically-shaped batches."""

    def __init__(self, paths: list[str], patch_size: tuple[int, int], batch_size: int, *,
                 attributes: list[dict[str, float]] | None = None,
                 shuffle: bool = False, seed: int | None = 42, rank: int = 0, world: int = 1,
                 cache_rate: float = 0.0, num_workers: int = 8, drop_last: bool = False,
                 transform: Callable[[str], np.ndarray] | None = None):
        if attributes is not None and len(attributes) != len(paths):
            raise ValueError("attributes must align with paths")
        if not 0.0 <= cache_rate <= 1.0:
            raise ValueError(f"cache_rate must be in [0, 1], got {cache_rate}")
        self.paths = list(paths)
        self.patch_size = tuple(patch_size)
        self.batch_size = int(batch_size)
        self.attributes = attributes
        self.shuffle = shuffle
        self.seed = seed if seed is not None else 0
        self.rank = rank
        self.world = world
        self.drop_last = drop_last
        self.epoch = 0
        self._transform = transform or self._default_transform
        self._cache: dict[int, np.ndarray] = {}
        self._cache_limit = int(cache_rate * len(self.paths))
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers))

    def close(self) -> None:
        """Stop the decode threads."""
        self._pool.shutdown(wait=True)

    def _default_transform(self, path: str) -> np.ndarray:
        """The JAX loader's preprocessing: the native fused path where the
        library parses the file, else the numpy path; each file counted."""
        if str(path).lower().endswith((".tif", ".tiff")):
            result = native.preprocess_tiff(str(path), self.patch_size)
            if result is not None:
                native.count_path(True)
                return result
        native.count_path(False)
        return preprocess_image_np(read_image(path), self.patch_size)

    def set_epoch(self, epoch: int) -> None:
        """Reference ``train_loader.sampler.set_epoch`` parity: the shuffle
        of the next iteration is seeded with ``seed + epoch``."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(shard_indices(len(self.paths), rank=self.rank, world=self.world))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _sample(self, idx: int) -> np.ndarray:
        if idx in self._cache:
            return self._cache[idx]
        img = self._transform(self.paths[idx])
        if idx < self._cache_limit:
            self._cache[idx] = img
        return img

    def _make_batch(self, idx_chunk: np.ndarray) -> dict[str, Any]:
        images = list(self._pool.map(self._sample, [int(i) for i in idx_chunk]))
        h, w = self.patch_size
        batch = np.zeros((self.batch_size, h, w, images[0].shape[-1]), dtype=np.float32)
        mask = np.zeros((self.batch_size,), dtype=np.float32)
        for i, img in enumerate(images):
            batch[i] = img
            mask[i] = 1.0
        out: dict[str, Any] = {"image": batch, "mask": mask}
        if self.attributes is not None:
            pad = [0.0] * (self.batch_size - len(images))
            out["attributes"] = {
                key: np.array([float(self.attributes[int(i)][key]) for i in idx_chunk] + pad,
                              dtype=np.float32)
                for key in self.attributes[0]
            }
        return out

    def _batches(self) -> Iterator[dict[str, Any]]:
        idx = shard_indices(len(self.paths), rank=self.rank, world=self.world,
                            shuffle=self.shuffle, seed=self.seed, epoch=self.epoch)
        end = len(idx) // self.batch_size * self.batch_size
        for start in range(0, end, self.batch_size):
            yield self._make_batch(idx[start : start + self.batch_size])
        if not self.drop_last and end < len(idx):
            yield self._make_batch(idx[end:])

    def __iter__(self) -> Iterator[dict[str, Any]]:
        """Iterate with a depth-2 background prefetch."""
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()
        error: list[BaseException] = []

        def producer():
            try:
                for batch in self._batches():
                    q.put(batch)
            except BaseException as exc:  # re-raised in the consumer below
                error.append(exc)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            with span("loader.wait", arg=q.qsize):
                item = q.get()
            if item is sentinel:
                thread.join()
                if error:
                    raise error[0]
                return
            yield item
