"""Shared analysis setup helpers (counterpart of
``pti_ldm_vae_tpu/analysis/common.py``; reference ``analysis/common.py``)."""

from __future__ import annotations

import random
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..data.io import TifReader, read_image
from ..data.transforms import preprocess_image_np
from ..utils.cli_common import load_config_and_model, resolve_device
from .latent_cache import LatentCache
from .latent_space import LatentSpaceAnalyzer, load_image_paths

__all__ = [
    "set_seed",
    "setup_device_and_output",
    "load_vae_model",
    "create_transforms",
    "encode_single_image",
    "collect_image_paths",
    "load_and_encode_group",
    "load_and_encode_group_with_cache",
    "save_visualization_and_legend",
    "compute_and_save_statistics",
    "TifReader",
]

# the reference's analyze_ar_channels imports TifReader from analysis.common,
# where it was never defined; exported here, as the JAX package does, so that
# the import works


def set_seed(seed: int) -> None:
    """Seed the host RNGs and torch's (reference ``common.py:17-27``)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def setup_device_and_output(output_dir: str, device: str = "cuda") -> tuple[torch.device, Path]:
    """The torch device (CUDA unless ``device`` is ``"cpu"``; raises when
    CUDA is asked for and absent) and the created output directory."""
    dev = resolve_device(device)
    output_path = Path(output_dir)
    output_path.mkdir(parents=True, exist_ok=True)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"Device: {dev} ({where})")
    print(f"Output directory: {output_path}")
    return dev, output_path


def load_vae_model(config_file: str, vae_weights: str, *, device: torch.device,
                   conv_kernel: bool = False) -> nn.Module:
    """The frozen autoencoder in f32 with TF32 off (reference
    ``common.py:50-65``); ``conv_kernel`` sends its 3x3 convolutions through
    the hand-written kernels."""
    _, model = load_config_and_model(config_file, vae_weights, device=device, exact=True,
                                     conv_kernel=conv_kernel)
    print(f"Loaded VAE from {vae_weights}")
    return model


def create_transforms(patch_size: tuple[int, int]) -> Callable[[str], np.ndarray]:
    """Canonical preprocessing fn: TIF read -> area resize -> mask z-score
    (reference ``build_vae_preprocess_transform(use_tif_reader=True)``)."""
    patch = tuple(patch_size)

    def transform(path: str) -> np.ndarray:
        return preprocess_image_np(read_image(path), patch)

    return transform


def encode_single_image(analyzer: LatentSpaceAnalyzer, image_path: str):
    latent, ids = analyzer.encode_images([image_path], show_progress=False)
    return latent[0], ids[0]


def collect_image_paths(folder_path: str, max_images: int) -> list[str]:
    return load_image_paths(folder_path, max_images)


def load_and_encode_group(analyzer, folder_path: str, max_images: int, group_name: str):
    print(f"\nLoading {group_name} images from {folder_path}...")
    paths = load_image_paths(folder_path, max_images)
    print(f"Found {len(paths)} images")
    latent, ids = analyzer.encode_images(paths)
    print(f"Encoded {len(latent)} images to latent space")
    return latent, ids, paths


def load_and_encode_group_with_cache(
    analyzer: LatentSpaceAnalyzer,
    folder_path: str,
    vae_weights: str,
    max_images: int,
    patch_size: tuple[int, int],
    group_name: str,
    cache_dir: Path = Path("cache/latents"),
):
    """Cached group encoding (reference ``common.py:125-167``); cache misses
    are encoded in device batches."""
    image_paths = collect_image_paths(folder_path, max_images)

    def encoder_fn(paths: list[str]):
        return analyzer.encode_images(paths, show_progress=False)

    cache = LatentCache(cache_root=cache_dir)
    return cache.get_or_encode_batch(
        image_paths=image_paths,
        encoder_fn=encoder_fn,
        vae_weights=vae_weights,
        patch_size=tuple(patch_size),
        group_name=group_name,
    )


def save_visualization_and_legend(
    analyzer, projections, output_dir: Path, title: str, color_by_patient: bool,
    ids_group1, ids_group2, plot_filename: str, image_paths_list=None,
) -> Path:
    """Reference ``common.py:170-214``; returns the written plot's path."""
    save_path = analyzer.plot_projection_2d(
        projections=projections, output_path=str(Path(output_dir) / plot_filename), title=title,
        color_by_patient=color_by_patient, show_labels=color_by_patient,
        image_paths_list=image_paths_list,
    )
    print(f"Plot saved to {save_path}")
    if color_by_patient:
        all_ids = list(ids_group1) + (list(ids_group2) if ids_group2 else [])
        patient_to_id, patient_to_color = analyzer.create_patient_colormap(all_ids)
        legend_path = Path(output_dir) / "color_legend.txt"
        analyzer.save_color_legend(patient_to_id, patient_to_color, legend_path)
        print(f"Color legend saved to {legend_path}")
    return save_path


def compute_and_save_statistics(
    analyzer, projection_group1, projection_group2, latent_group1, latent_group2,
    ids_group1, ids_group2, group1_name: str, group2_name: str, output_dir: Path,
) -> None:
    """Reference ``common.py:217-250``."""
    projection_data = [
        (projection_group1, ids_group1, group1_name),
        (projection_group2, ids_group2, group2_name),
    ]
    latent_data = [
        (latent_group1, ids_group1, group1_name),
        (latent_group2, ids_group2, group2_name),
    ]
    analyzer.compute_group_statistics(projection_data, latent_data, output_dir)
    print(f"Statistics saved to {output_dir}/distance_metrics.txt")
