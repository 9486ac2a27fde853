"""Paired image augmentation (counterpart of
``pti_ldm_vae_tpu/data/augmentation.py``; reference
``src/pti_ldm_vae/data/augmentation.py``).

The reference builds an albumentations pipeline (HFlip / VFlip / Rot90 /
ShiftScaleRotate / ElasticTransform with a paired ``condition_image``
target) that the training path never uses. Where ``albumentations`` is
installed that pipeline is returned; otherwise ``PairedAugmentation``
applies the SAME sampled transform to image and condition image, with the
JAX package's probabilities, parameter ranges and numpy random stream (one
seed gives the JAX object's decisions), through the port's OpenCV subset
(``utils/imgproc.py``). Host-side numpy, as in the JAX package.
"""

from __future__ import annotations

import importlib.util

import numpy as np

from ..utils import imgproc

__all__ = ["get_albumentations_transform", "PairedAugmentation"]


def get_albumentations_transform(prob: float = 0.5):
    """HFlip/VFlip/Rot90/ShiftScaleRotate/Elastic pipeline with paired target.

    Returns an albumentations ``Compose`` when the package exists (reference
    behavior), else a :class:`PairedAugmentation` with the same call contract
    (``transform(image=..., condition_image=...) -> dict``).
    """
    if importlib.util.find_spec("albumentations") is not None:  # absent on both machines
        import albumentations as albu

        return albu.Compose(
            [
                albu.HorizontalFlip(p=prob),
                albu.VerticalFlip(p=prob),
                albu.RandomRotate90(p=prob),
                albu.ShiftScaleRotate(shift_limit=0.0625, scale_limit=0.1, rotate_limit=15, p=prob),
                albu.ElasticTransform(alpha=1, sigma=50, p=prob),
            ],
            additional_targets={"condition_image": "image"},
        )
    return PairedAugmentation(prob=prob)


class PairedAugmentation:
    """Numpy fallback with albumentations-compatible call contract."""

    def __init__(self, prob: float = 0.5, seed: int | None = None):
        self.prob = prob
        self.rng = np.random.default_rng(seed)

    def _shift_scale_rotate(self, img, shift, scale, angle):
        h, w = img.shape[:2]
        mat = imgproc.get_rotation_matrix_2d((w / 2, h / 2), angle, scale)
        mat[0, 2] += shift[0] * w
        mat[1, 2] += shift[1] * h
        return imgproc.warp_affine(img, mat, (w, h), interpolation="linear", border="reflect101")

    def _elastic(self, img, alpha, sigma, seed):
        h, w = img.shape[:2]
        local = np.random.default_rng(seed)
        dx = imgproc.gaussian_blur(local.random((h, w)).astype(np.float32) * 2 - 1, sigma) * alpha
        dy = imgproc.gaussian_blur(local.random((h, w)).astype(np.float32) * 2 - 1, sigma) * alpha
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        return imgproc.remap_linear(img, xx + dx, yy + dy)

    def __call__(self, *, image: np.ndarray, condition_image: np.ndarray | None = None, **_):
        imgs = {"image": np.asarray(image, dtype=np.float32)}
        if condition_image is not None:
            imgs["condition_image"] = np.asarray(condition_image, dtype=np.float32)

        # Sample one transform decision set; apply identically to both images.
        decisions = {
            "hflip": self.rng.random() < self.prob,
            "vflip": self.rng.random() < self.prob,
            "rot90": int(self.rng.integers(0, 4)) if self.rng.random() < self.prob else 0,
            "ssr": self.rng.random() < self.prob,
            "elastic": self.rng.random() < self.prob,
        }
        shift = self.rng.uniform(-0.0625, 0.0625, size=2)
        scale = 1.0 + self.rng.uniform(-0.1, 0.1)
        angle = self.rng.uniform(-15, 15)
        elastic_seed = int(self.rng.integers(0, 2**31))

        for key, img in imgs.items():
            if decisions["hflip"]:
                img = img[:, ::-1]
            if decisions["vflip"]:
                img = img[::-1, :]
            if decisions["rot90"]:
                img = np.rot90(img, k=decisions["rot90"])
            img = np.ascontiguousarray(img)
            if decisions["ssr"]:
                img = self._shift_scale_rotate(img, shift, scale, angle)
            if decisions["elastic"]:
                img = self._elastic(img, alpha=1.0, sigma=50.0, seed=elastic_seed)
            imgs[key] = img
        return imgs
