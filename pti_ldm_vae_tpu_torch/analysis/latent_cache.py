"""Content-addressed on-disk latent cache (a numpy copy of
``pti_ldm_vae_tpu/analysis/latent_cache.py``: the same keys, ``.npz`` fields
and ``_metadata.json``, so a cache written by either package is read by the
other).

Key semantics identical to the reference (``analysis/latent_cache.py:41-74``):
model signature = md5(abs-weights-path + patch_size)[:8]; image key =
md5(abs-image-path + mtime)[:12]; per-model ``_metadata.json`` index;
corrupted entries are re-encoded (``:196-202``). The encoder callback is a
*batched* device function: cache misses are encoded in fixed-size batches,
not one device round trip per image.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Callable

import numpy as np

__all__ = ["LatentCache"]


class LatentCache:
    def __init__(self, cache_root: Path = Path("cache/latents")) -> None:
        self.cache_root = Path(cache_root)
        self.cache_root.mkdir(parents=True, exist_ok=True)

    # -- keys ---------------------------------------------------------------
    def _get_model_signature(self, vae_weights: str, patch_size: tuple[int, int]) -> str:
        abs_weights = Path(vae_weights).resolve()
        return hashlib.md5(f"{abs_weights}_{tuple(patch_size)}".encode()).hexdigest()[:8]

    def _get_image_cache_key(self, image_path: str) -> str:
        abs_path = Path(image_path).resolve()
        mtime = abs_path.stat().st_mtime if abs_path.exists() else 0
        return hashlib.md5(f"{abs_path}_{mtime}".encode()).hexdigest()[:12]

    def _get_cache_file_path(self, image_path: str, model_signature: str) -> Path:
        model_dir = self.cache_root / model_signature
        model_dir.mkdir(parents=True, exist_ok=True)
        return model_dir / f"{self._get_image_cache_key(image_path)}.npz"

    # -- metadata -------------------------------------------------------------
    def _metadata_path(self, model_signature: str) -> Path:
        return self.cache_root / model_signature / "_metadata.json"

    def _load_metadata(self, model_signature: str) -> dict:
        path = self._metadata_path(model_signature)
        if path.exists():
            return json.loads(path.read_text(encoding="utf-8"))
        return {"images": {}}

    def _save_metadata(self, model_signature: str, metadata: dict) -> None:
        self._metadata_path(model_signature).write_text(
            json.dumps(metadata, indent=2), encoding="utf-8"
        )

    # -- main -------------------------------------------------------------
    def get_or_encode_batch(
        self,
        image_paths: list[str],
        encoder_fn: Callable[[list[str]], tuple[np.ndarray, list[str]]],
        vae_weights: str,
        patch_size: tuple[int, int],
        group_name: str,
    ) -> tuple[np.ndarray, list[str], list[str]]:
        """Latents for a batch of images, cache-first.

        ``encoder_fn(paths) -> (latents [n, D], patient_ids)`` encodes a list
        of images in one call (batched on device). Returns
        (latents [N, D], ids, paths) in input order.
        """
        model_signature = self._get_model_signature(vae_weights, patch_size)
        metadata = self._load_metadata(model_signature)
        print(f"Processing {group_name} ({len(image_paths)} images) "
              f"[cache sig: {model_signature}]")

        results: dict[int, tuple[np.ndarray, str]] = {}
        misses: list[int] = []
        for i, img_path in enumerate(image_paths):
            cache_file = self._get_cache_file_path(img_path, model_signature)
            abs_path = str(Path(img_path).resolve())
            cache_key = self._get_image_cache_key(img_path)
            entry = metadata["images"].get(abs_path, {})
            if cache_file.exists() and entry.get("cache_key") == cache_key:
                try:
                    data = np.load(cache_file)
                    results[i] = (data["latent"], str(data["patient_id"]))
                    continue
                except Exception as exc:  # corrupted entry -> re-encode
                    print(f"  cache corrupted for {Path(img_path).name}, re-encoding: {exc}")
            misses.append(i)

        if misses:
            miss_paths = [image_paths[i] for i in misses]
            latents, ids = encoder_fn(miss_paths)
            for j, i in enumerate(misses):
                img_path = image_paths[i]
                cache_file = self._get_cache_file_path(img_path, model_signature)
                np.savez(cache_file, latent=latents[j], patient_id=ids[j])
                metadata["images"][str(Path(img_path).resolve())] = {
                    "cache_key": self._get_image_cache_key(img_path),
                    "patient_id": ids[j],
                }
                results[i] = (latents[j], ids[j])
            metadata["model"] = str(Path(vae_weights).name)
            metadata["patch_size"] = list(patch_size)
            self._save_metadata(model_signature, metadata)

        print(f"  {len(image_paths) - len(misses)} from cache, {len(misses)} newly encoded")
        ordered = [results[i] for i in range(len(image_paths))]
        latents_arr = np.array([lat for lat, _ in ordered])
        ids_list = [pid for _, pid in ordered]
        return latents_arr, ids_list, list(image_paths)

    # -- maintenance ------------------------------------------------------------
    def clear_cache(self, model_signature: str | None = None) -> None:
        if model_signature is None:
            if self.cache_root.exists():
                shutil.rmtree(self.cache_root)
                self.cache_root.mkdir(parents=True, exist_ok=True)
            print(f"Cleared all cache in {self.cache_root}")
        else:
            model_dir = self.cache_root / model_signature
            if model_dir.exists():
                shutil.rmtree(model_dir)
            print(f"Cleared cache for model {model_signature}")

    def get_cache_stats(self) -> dict[str, dict]:
        stats: dict[str, dict] = {}
        if not self.cache_root.exists():
            return stats
        for model_dir in self.cache_root.iterdir():
            if not model_dir.is_dir():
                continue
            metadata = self._load_metadata(model_dir.name)
            total = sum(f.stat().st_size for f in model_dir.glob("*.npz") if f.is_file())
            stats[model_dir.name] = {
                "model": metadata.get("model", "unknown"),
                "patch_size": metadata.get("patch_size", []),
                "num_images": len(metadata.get("images", {})),
                "cache_size_mb": total / (1024 * 1024),
            }
        return stats
