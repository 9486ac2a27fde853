"""Latent-space analysis: batched encoding, PCA -> t-SNE / UMAP, plots, stats
(counterpart of ``pti_ldm_vae_tpu/analysis/latent_space.py``; reference
``src/pti_ldm_vae/analysis/latent_space.py``).

* ``LatentSpaceAnalyzer.encode_images``: deterministic (z_mu) encoding of
  image lists at one fixed batch shape (the last batch zero-padded, its
  padded rows dropped), latents flattened channel-major for cache
  compatibility; host float32 ``[N, C*h*w]`` out.
* PCA(50) -> t-SNE on the device (``analysis/projection.py``: exact PCA,
  exact-repulsion t-SNE), or UMAP where ``umap-learn`` is installed (gated
  as in the JAX package), with the same validation rules.
* The 2-D projection plot drawn with numpy (``utils/visualization.py``) as a
  PNG, with the JAX package's markers, filled-vs-open rule and palette.
* Inter-group distance statistics -> ``distance_metrics.txt`` /
  ``exams_sorted_by_distance.txt``, the same bytes as the JAX package's.
"""

from __future__ import annotations

import os
from collections import defaultdict
from glob import glob
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from scipy.spatial.distance import cdist
from torch import nn

from ..data.io import write_png
from ..models.regressor import flatten_latent
from ..utils.visualization import GROUP_COLORS, draw_scatter
from .projection import PCA, TSNE

__all__ = [
    "extract_patient_id_from_filename",
    "compute_distance_metrics",
    "ComposedProjection",
    "LatentSpaceAnalyzer",
    "load_image_paths",
]

try:  # optional
    import umap as _umap
except ImportError:  # pragma: no cover
    _umap = None


def extract_patient_id_from_filename(filename: str) -> str:
    """``ID_HA_YEAR_MONTH_PATIENT.tif`` -> ``PATIENT``
    (reference ``latent_space.py:21-37``)."""
    stem = filename.rsplit(".", 1)[0] if "." in filename else filename
    parts = stem.split("_")
    return parts[-1] if parts else stem


def compute_distance_metrics(points1, points2):
    """(center_distance, std1, std2, mean_cross_distance) or None
    (reference ``latent_space.py:40-66``)."""
    if len(points1) == 0 or len(points2) == 0:
        return None
    points1 = np.array(points1)
    points2 = np.array(points2)
    center_distance = float(np.linalg.norm(points1.mean(axis=0) - points2.mean(axis=0)))
    std1 = float(np.mean(np.std(points1, axis=0))) if len(points1) > 1 else 0.0
    std2 = float(np.mean(np.std(points2, axis=0))) if len(points2) > 1 else 0.0
    mean_cross = float(np.mean(cdist(points1, points2)))
    return center_distance, std1, std2, mean_cross


# Plotly's qualitative colours, as the JAX package's fallback palette; plotly is
# never imported here, so legends are these colours in every environment.
_PALETTE = [
    "#636EFA", "#EF553B", "#00CC96", "#AB63FA", "#FFA15A",
    "#19D3F3", "#FF6692", "#B6E880", "#FF97FF", "#FECB52",
]


class ComposedProjection:
    """Fitted PCA -> UMAP pipeline whose ``transform`` takes RAW latents
    (the JAX package's ``ComposedProjection``, over the port's PCA)."""

    def __init__(self, pca: PCA, umap_model):
        self.pca = pca
        self.umap = umap_model

    def transform(self, raw_latents: np.ndarray) -> np.ndarray:
        return self.umap.transform(self.pca.transform(raw_latents).cpu().numpy())


class LatentSpaceAnalyzer:
    """Encoding, projection and plotting on ``device`` (the VAE's)."""

    def __init__(self, vae: nn.Module, transform: Callable[[str], np.ndarray], *,
                 batch_size: int = 8, device: torch.device | str) -> None:
        self.vae = vae
        self.transform = transform
        self.batch_size = batch_size
        self.device = torch.device(device)

    # -- encoding -------------------------------------------------------------
    def encode_images(
        self, image_paths: list[str], max_images: int | None = None,
        batch_size: int | None = None, show_progress: bool = True,
    ) -> tuple[np.ndarray, list[str]]:
        """Deterministic z_mu encoding -> flattened latents [N, D] (host
        float32) + ids. Images are read and preprocessed on the host one
        batch at a time; every batch has the same shape (zero-padded)."""
        if len(image_paths) == 0:
            raise ValueError("image_paths cannot be empty")
        if max_images is not None:
            image_paths = image_paths[:max_images]
        bsz = batch_size or self.batch_size

        latents = []
        ids = []
        with torch.inference_mode():
            for start in range(0, len(image_paths), bsz):
                chunk = image_paths[start : start + bsz]
                imgs = np.stack([np.asarray(self.transform(p), dtype=np.float32) for p in chunk])
                if imgs.ndim == 3:
                    imgs = imgs[..., None]
                valid = len(chunk)
                if valid < bsz:  # zero-pad to the fixed batch shape
                    pad = np.zeros((bsz - valid, *imgs.shape[1:]), dtype=np.float32)
                    imgs = np.concatenate([imgs, pad])
                z = self.vae.encode_deterministic(torch.from_numpy(imgs).to(self.device))
                latents.append(flatten_latent(z)[:valid])
                ids.extend(extract_patient_id_from_filename(os.path.basename(p)) for p in chunk)
            flat = torch.cat(latents).to(torch.float32).cpu().numpy()
        return flat, ids

    # -- reduction -------------------------------------------------------------
    def _apply_pca(self, vectors, n_components: int = 50) -> tuple[torch.Tensor, PCA]:
        pca = PCA(n_components, device=self.device)
        return pca.fit_transform(vectors), pca

    def _validate(self, latent_vectors, pca_components, neighbor_param, neighbor_name):
        if latent_vectors.ndim != 2:
            raise ValueError(f"Expected 2D array, got {latent_vectors.ndim}D array")
        n = len(latent_vectors)
        if n < pca_components:
            raise ValueError(
                f"Need at least {pca_components} samples for PCA with {pca_components} "
                f"components, got {n} samples."
            )
        if neighbor_param >= n:
            raise ValueError(f"{neighbor_name} ({neighbor_param}) must be < n_samples ({n}).")

    def reduce_dimensionality_umap(
        self, latent_vectors: np.ndarray, n_components: int = 2, n_neighbors: int = 40,
        min_dist: float = 0.5, random_state: int = 42, pca_components: int = 50,
    ):
        """PCA -> UMAP (reference ``latent_space.py:181-238``); returns
        ``(embedding, model)`` where ``model.transform`` accepts RAW latents.
        Needs ``umap-learn``, which runs on the host."""
        self._validate(latent_vectors, pca_components, n_neighbors, "n_neighbors")
        if _umap is None:
            raise ImportError("Please install umap-learn: pip install umap-learn")
        vectors_pca, pca = self._apply_pca(latent_vectors, pca_components)
        model = _umap.UMAP(
            n_components=n_components, random_state=random_state,
            n_neighbors=n_neighbors, min_dist=min_dist,
        )
        embedding = model.fit_transform(vectors_pca.cpu().numpy())
        return embedding, ComposedProjection(pca, model)

    def reduce_dimensionality_tsne(
        self, latent_vectors: np.ndarray, n_components: int = 2, perplexity: int = 30,
        random_state: int = 42, pca_components: int = 50,
    ) -> np.ndarray:
        """PCA -> t-SNE on the device (reference ``latent_space.py:240-290``);
        host float32 ``[N, n_components]``."""
        self._validate(latent_vectors, pca_components, perplexity, "perplexity")
        if perplexity < 5:
            print(f"Warning: perplexity={perplexity} is very low. Consider 5-50.")
        vectors_pca, _ = self._apply_pca(latent_vectors, pca_components)
        tsne = TSNE(n_components=n_components, perplexity=perplexity,
                    random_state=random_state, device=self.device)  # init="pca"
        return tsne.fit_transform(vectors_pca).cpu().numpy()

    # -- colors -------------------------------------------------------------
    def create_patient_colormap(self, patient_ids: list[str]):
        unique = sorted(set(patient_ids))
        patient_to_id = {p: i for i, p in enumerate(unique)}
        patient_to_color = {p: _PALETTE[i % len(_PALETTE)] for i, p in enumerate(unique)}
        return patient_to_id, patient_to_color

    # -- plotting -------------------------------------------------------------
    def plot_projection_2d(
        self, projections, output_path: str, title: str = "Latent Space Projection",
        color_by_patient: bool = True, show_labels: bool = True, image_paths_list=None,
    ) -> Path:
        """2-D scatter of (vectors, ids, marker, name) groups as a PNG (an
        ``.html`` path is written as ``.png``, as the JAX package's matplotlib
        fallback does): ``"dente"`` groups filled, the others open; colours by
        patient or by group. The title is printed, not drawn."""
        patient_to_color = None
        if color_by_patient:
            all_ids = [i for _, ids, _, _ in projections for i in ids]
            _, patient_to_color = self.create_patient_colormap(all_ids)
        markers = {"o": "o", "^": "^", "s": "s", "d": "d"}
        groups = []
        for k, (vectors, ids, marker, name) in enumerate(projections):
            filled = "dente" in name.lower() and "edente" not in name.lower()
            colors = ([patient_to_color[i] for i in ids] if color_by_patient
                      else GROUP_COLORS[k % len(GROUP_COLORS)])
            groups.append((np.asarray(vectors), colors, markers.get(marker, "o"), filled))
        if output_path.endswith(".html"):
            output_path = output_path.rsplit(".", 1)[0] + ".png"
        write_png(output_path, draw_scatter(groups))
        print(f"{title}: {', '.join(f'{name} ({len(v)})' for v, _, _, name in projections)}")
        return Path(output_path)

    # -- statistics -------------------------------------------------------------
    def compute_group_statistics(self, projections, latent_vectors_list, output_dir: Path) -> None:
        """Per-exam distance report (reference ``latent_space.py:459-536``)."""
        if len(projections) != 2 or len(latent_vectors_list) != 2:
            return
        proj1, ids1, name1 = projections[0]
        proj2, ids2, name2 = projections[1]
        lat1 = latent_vectors_list[0][0]
        lat2 = latent_vectors_list[1][0]

        exam_proj = defaultdict(lambda: {name1: [], name2: []})
        exam_lat = defaultdict(lambda: {name1: [], name2: []})
        for i, exam in enumerate(ids1):
            exam_proj[exam][name1].append(proj1[i])
            exam_lat[exam][name1].append(lat1[i])
        for i, exam in enumerate(ids2):
            exam_proj[exam][name2].append(proj2[i])
            exam_lat[exam][name2].append(lat2[i])

        output_dir = Path(output_dir)
        exam_distances = []
        with open(output_dir / "distance_metrics.txt", "w", encoding="utf-8") as fh:
            fh.write("Distance Metrics per Exam (Latent Space and Projection)\n")
            fh.write("=" * 60 + "\n\n")
            for exam in sorted(exam_lat.keys()):
                g1, g2 = exam_lat[exam][name1], exam_lat[exam][name2]
                p1, p2 = exam_proj[exam][name1], exam_proj[exam][name2]
                if not g1 or not g2:
                    continue
                m_lat = compute_distance_metrics(g1, g2)
                m_proj = compute_distance_metrics(p1, p2)
                if not m_lat or not m_proj:
                    continue
                fh.write(f"{exam}\n")
                fh.write(f"  - n_{name1}: {len(g1)}, n_{name2}: {len(g2)}\n")
                fh.write(f"  - [Latent] center_dist: {m_lat[0]:.3f}, "
                         f"std_{name1}: {m_lat[1]:.3f}, std_{name2}: {m_lat[2]:.3f}, "
                         f"mean_cross_dist: {m_lat[3]:.3f}\n")
                fh.write(f"  - [Projection] center_dist: {m_proj[0]:.3f}, "
                         f"std_{name1}: {m_proj[1]:.3f}, std_{name2}: {m_proj[2]:.3f}, "
                         f"mean_cross_dist: {m_proj[3]:.3f}\n\n")
                exam_distances.append((exam, m_lat[0]))

        exam_distances.sort(key=lambda x: x[1])
        with open(output_dir / "exams_sorted_by_distance.txt", "w", encoding="utf-8") as fh:
            fh.write("Exams sorted by latent space center distance\n")
            fh.write("=" * 60 + "\n\n")
            for exam, dist in exam_distances:
                fh.write(f"{exam}: {dist:.3f}\n")

    def save_color_legend(self, exam_to_id, exam_to_color, output_path: Path) -> None:
        with open(output_path, "w", encoding="utf-8") as fh:
            fh.write("Color Legend for Exams\n")
            fh.write("=" * 60 + "\n\n")
            for exam in sorted(exam_to_id.keys(), key=lambda x: exam_to_id[x]):
                fh.write(f"{exam_to_id[exam]}: {exam} — {exam_to_color[exam]}\n")


def load_image_paths(data_dir: str, max_images: int | None = None,
                     extensions: list[str] | None = None) -> list[str]:
    """Sorted image paths with extension filtering (reference ``:555-589``)."""
    if extensions is None:
        extensions = [".tif", ".tiff"]
    paths: list[str] = []
    for ext in extensions:
        if not ext.startswith("."):
            ext = f".{ext}"
        paths.extend(glob(os.path.join(data_dir, f"*{ext}")))
    paths = sorted(paths)
    return paths[:max_images] if max_images is not None else paths
