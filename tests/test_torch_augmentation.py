"""The port's paired augmentation (``pti_ldm_vae_tpu_torch/data/augmentation.py``)
against the JAX package's: for one seed the same decisions (the same numpy
stream, drawn in the same order) and outputs within 1e-5, for the image and
its condition image, at probabilities 0, 0.5 and 1."""

import importlib.util

import numpy as np
import pytest

from pti_ldm_vae_tpu.data import augmentation as jax_augmentation
from pti_ldm_vae_tpu_torch.data.augmentation import PairedAugmentation, get_albumentations_transform


@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("seed", range(4))
def test_paired_augmentation_against_jax(prob, seed):
    rng = np.random.default_rng(100 + seed)
    shape = (32, 32) if seed % 2 else (24, 40)  # rot90 swaps a non-square image's sides
    ours = PairedAugmentation(prob=prob, seed=seed)
    theirs = jax_augmentation.PairedAugmentation(prob=prob, seed=seed)
    for _ in range(3):  # three calls: the stream stays in step
        image = rng.uniform(size=shape).astype(np.float32)
        condition = rng.uniform(size=shape).astype(np.float32)
        got = ours(image=image, condition_image=condition)
        want = theirs(image=image, condition_image=condition)
        assert set(got) == set(want) == {"image", "condition_image"}
        for key in got:
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
            assert np.abs(got[key] - want[key]).max() <= 1e-5
        if prob == 0.0:
            np.testing.assert_array_equal(got["image"], image)
        assert ours.rng.bit_generator.state == theirs.rng.bit_generator.state


def test_image_alone_and_identical_pair():
    aug = PairedAugmentation(prob=1.0, seed=3)
    img = np.random.default_rng(1).uniform(size=(32, 32)).astype(np.float32)
    out = aug(image=img, condition_image=img.copy())
    np.testing.assert_array_equal(out["image"], out["condition_image"])
    assert not np.array_equal(out["image"], img)
    assert set(PairedAugmentation(prob=0.5, seed=0)(image=img)) == {"image"}


def test_factory_without_albumentations():
    assert importlib.util.find_spec("albumentations") is None  # on neither machine
    transform = get_albumentations_transform(prob=0.25)
    assert isinstance(transform, PairedAugmentation) and transform.prob == 0.25
