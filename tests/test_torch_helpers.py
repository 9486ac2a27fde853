"""The port's small public helpers against the JAX package's (CPU), exactly,
on seeded numpy inputs: ``TifReader`` (``data/io.py``, re-exported from
``data`` and ``analysis.common``), ``normalize_image_to_uint8``,
``visualize_2d_image`` and ``visualize_one_slice_in_3d_image``
(``utils/visualization.py``, exported from ``utils``) and
``attention_flops`` (``ops/attention.py``)."""

import numpy as np
import pytest

from pti_ldm_vae_tpu.analysis import common as jax_common
from pti_ldm_vae_tpu.data import io as jax_io
from pti_ldm_vae_tpu.ops.attention import attention_flops as jax_attention_flops
from pti_ldm_vae_tpu.utils import visualization as jax_vis
from pti_ldm_vae_tpu_torch import data as port_data
from pti_ldm_vae_tpu_torch import utils as port_utils
from pti_ldm_vae_tpu_torch.analysis import common as port_common
from pti_ldm_vae_tpu_torch.data import io as port_io
from pti_ldm_vae_tpu_torch.ops import attention as port_attention
from pti_ldm_vae_tpu_torch.utils import visualization as port_vis


def _same(ours, theirs) -> None:
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


def test_the_helpers_are_at_the_jax_import_paths():
    assert port_data.TifReader is port_io.TifReader is port_common.TifReader
    assert "TifReader" in port_common.__all__ and "TifReader" in port_data.__all__
    for name in ("normalize_image_to_uint8", "visualize_2d_image",
                 "visualize_one_slice_in_3d_image"):
        assert getattr(port_utils, name) is getattr(port_vis, name) and name in port_utils.__all__
    assert "attention_flops" in port_attention.__all__


_READER_CASES = ["tif_square", "tif_ragged_negative", "png_uint8"]


@pytest.mark.parametrize("case", _READER_CASES)
def test_tif_reader_equals_jax(tmp_path, case):
    rng = np.random.default_rng(_READER_CASES.index(case))
    if case == "png_uint8":
        path = tmp_path / "img.png"
        port_io.write_png(str(path), rng.integers(0, 256, (19, 27), dtype=np.uint8))
    else:
        shape, low = ((48, 48), 0.0) if case == "tif_square" else ((17, 31), -3.0)
        path = tmp_path / "img.tif"
        jax_io.write_tif(str(path), rng.uniform(low, 5.0, shape).astype(np.float32))
    ours = port_common.TifReader()(str(path))
    _same(ours, jax_common.TifReader()(str(path)))
    assert ours.dtype == np.float32


_IMAGES = {
    "normal": lambda rng: rng.normal(size=(23, 17)).astype(np.float32),
    "positive_wide": lambda rng: rng.uniform(0.0, 800.0, (16, 16)).astype(np.float32),
    "small_positive": lambda rng: rng.uniform(0.0, 0.05, (9, 12)).astype(np.float32),
    "zeros": lambda rng: np.zeros((8, 8), np.float32),
    "float64_negative": lambda rng: rng.uniform(-2.0, -1.0, (10, 7)),
}


@pytest.mark.parametrize("name", sorted(_IMAGES))
def test_normalize_image_to_uint8_equals_jax(name):
    image = _IMAGES[name](np.random.default_rng(3))
    ours = port_vis.normalize_image_to_uint8(image)
    _same(ours, jax_vis.normalize_image_to_uint8(image))
    assert ours.dtype == np.uint8


@pytest.mark.parametrize("name", ["normal", "positive_wide", "small_positive"])
def test_visualize_2d_image_equals_jax(name):
    image = _IMAGES[name](np.random.default_rng(4))
    ours = port_vis.visualize_2d_image(image)
    _same(ours, jax_vis.visualize_2d_image(image))
    assert ours.shape == (*image.shape, 3)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_visualize_one_slice_in_3d_image_equals_jax(axis):
    volume = np.random.default_rng(5).normal(size=(7, 10, 13)).astype(np.float32)
    ours = port_vis.visualize_one_slice_in_3d_image(volume, axis=axis)
    _same(ours, jax_vis.visualize_one_slice_in_3d_image(volume, axis=axis))
    assert ours.shape == (*np.delete(volume.shape, axis), 3)


@pytest.mark.parametrize("axis", [3, -1])
def test_visualize_one_slice_in_3d_image_bad_axis_raises_as_jax(axis):
    volume = np.zeros((4, 4, 4), np.float32)
    with pytest.raises(ValueError) as theirs:
        jax_vis.visualize_one_slice_in_3d_image(volume, axis=axis)
    with pytest.raises(ValueError) as ours:
        port_vis.visualize_one_slice_in_3d_image(volume, axis=axis)
    assert str(ours.value) == str(theirs.value) == f"axis should be in [0, 1, 2], got {axis}"


@pytest.mark.parametrize("batch,seq,channels", [
    (8, 1024, 128),  # the flagship's mid block at 256², b8
    (128, 1024, 128),  # at b128
    (8, 4096, 256),  # the kl1e3 model's
    (1, 1, 1),
    (3, 77, 5),
])
def test_attention_flops_equals_jax(batch, seq, channels):
    ours = port_attention.attention_flops(batch, seq, channels)
    assert ours == jax_attention_flops(batch, seq, channels) and type(ours) is int
