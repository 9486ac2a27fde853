"""Latent-space analysis (counterpart of ``pti_ldm_vae_tpu/analysis``):
cached encoding, PCA -> t-SNE on the device, plots and distance statistics;
and the GT-vs-synthesis comparison suite ``ImageComparison`` (contour
geometry on the host, VGG16 features on the device)."""

from .common import (
    collect_image_paths,
    compute_and_save_statistics,
    create_transforms,
    encode_single_image,
    load_and_encode_group,
    load_and_encode_group_with_cache,
    load_vae_model,
    save_visualization_and_legend,
    set_seed,
    setup_device_and_output,
)
from .latent_cache import LatentCache
from .latent_distance import (
    latent_distance,
    latent_distance_cross,
    latent_distance_from_indices,
)
from .latent_space import (
    LatentSpaceAnalyzer,
    compute_distance_metrics,
    extract_patient_id_from_filename,
    load_image_paths,
)
from .metrics import ImageComparison

__all__ = [
    "ImageComparison",
    "LatentCache",
    "LatentSpaceAnalyzer",
    "collect_image_paths",
    "compute_and_save_statistics",
    "compute_distance_metrics",
    "create_transforms",
    "encode_single_image",
    "extract_patient_id_from_filename",
    "latent_distance",
    "latent_distance_cross",
    "latent_distance_from_indices",
    "load_and_encode_group",
    "load_and_encode_group_with_cache",
    "load_image_paths",
    "load_vae_model",
    "save_visualization_and_legend",
    "set_seed",
    "setup_device_and_output",
]
