"""The port's native host data path and device preprocessing (CPU).

* ``pti_ldm_vae_tpu_torch/native``: the port's own copy of ``ptidata.cpp``,
  built with the JAX module's flags into the repository's ``build/``; its
  ``decode_tiff`` and ``preprocess_tiff`` are bit-equal to the JAX package's
  ``native`` module on the same files, and the data loader's default
  transform counts every file under ``native.decoded`` or
  ``native.python_path`` (a TIFF the library does not parse takes the numpy
  path, bit-equal to the JAX loader's). A library that fails to build warns
  on stderr.
* ``ops/resize.py:resize_area`` and ``data/transforms.py:preprocess_batch_device``
  against the JAX package's at rtol 1e-5 / atol 1e-6 (f32 sums in another
  order).

Skipped only where there is no ``g++``; otherwise a failed build fails.
"""

import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from pti_ldm_vae_tpu import native as jax_native
from pti_ldm_vae_tpu.data.io import write_tif
from pti_ldm_vae_tpu.data.loader import ShardedDataLoader as JaxLoader
from pti_ldm_vae_tpu.data.transforms import local_normalize_by_mask as jax_normalize
from pti_ldm_vae_tpu.data.transforms import preprocess_batch_device as jax_preprocess_batch
from pti_ldm_vae_tpu.ops.resize import resize_area as jax_resize_area
from pti_ldm_vae_tpu_torch import native
from pti_ldm_vae_tpu_torch.data.loader import ShardedDataLoader
from pti_ldm_vae_tpu_torch.data.transforms import (
    local_normalize_by_mask,
    preprocess_batch_device,
)
from pti_ldm_vae_tpu_torch.ops.kernels import _build
from pti_ldm_vae_tpu_torch.ops.resize import _area_matrix_np, resize_area

DEVICE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built here")
    assert native.build() is not None, "the native library failed to build"
    assert native.available() and jax_native.available()


def _image(seed, shape, background=True):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 2.0, size=shape).astype(np.float32)
    if background:
        img[img < 0.5] = 0.0
    return img


def test_the_library_is_the_ports_own(built):
    assert native.SOURCE.read_bytes() == open(jax_native._SRC, "rb").read()
    lib = native.library_path()
    assert lib.parent == _build.BUILD_DIR and lib.is_file()
    assert lib.name.startswith("ptidata_") and lib.suffix == ".so"
    assert native.GXX_FLAGS == ["-O3", "-shared", "-fPIC", "-std=c++17"]
    assert native._lib is not None and native._lib._name == str(lib)
    assert "pti_ldm_vae_tpu/native" not in native._lib._name


@pytest.mark.parametrize("shape", [(33, 47), (300, 300), (1, 5)])
def test_decode_is_bit_equal_to_the_jax_native_module(built, tmp_path, shape):
    path = str(tmp_path / "x.tif")
    write_tif(path, _image(0, shape, background=False) - 1.0)
    ours, theirs = native.decode_tiff(path), jax_native.decode_tiff(path)
    assert ours is not None and ours.dtype == np.float32 and ours.shape == shape
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("mode,dtype", [("L", np.uint8), ("I;16", np.uint16)])
def test_integer_tiffs_decode_like_the_jax_native_module(built, tmp_path, mode, dtype):
    arr = np.random.default_rng(1).integers(0, 200, size=(21, 30)).astype(dtype)
    path = str(tmp_path / "x.tif")
    Image.fromarray(arr, mode=mode).save(path, format="TIFF")
    np.testing.assert_array_equal(native.decode_tiff(path), jax_native.decode_tiff(path))
    np.testing.assert_array_equal(native.preprocess_tiff(path, (16, 16)),
                                  jax_native.preprocess_tiff(path, (16, 16)))


@pytest.mark.parametrize("shape,patch", [((300, 300), (256, 256)), ((50, 70), (32, 32)),
                                         ((16, 16), (16, 16)), ((20, 24), (32, 40))])
def test_preprocess_is_bit_equal_to_the_jax_native_module(built, tmp_path, shape, patch):
    path = str(tmp_path / "y.tif")
    write_tif(path, _image(2, shape))
    ours = native.preprocess_tiff(path, patch)
    assert ours is not None and ours.shape == (*patch, 1)
    np.testing.assert_array_equal(ours, jax_native.preprocess_tiff(path, patch))


def test_loader_counts_native_decodes_and_matches_the_jax_loader(built, tmp_path):
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"img_{i}.tif"))
        write_tif(paths[-1], _image(10 + i, (40, 36)))
    native.reset_counts()
    ours = ShardedDataLoader(paths, (32, 32), 3, num_workers=2)
    got = list(ours)
    ours.close()
    assert (native.decoded, native.python_path) == (5, 0)
    want = list(JaxLoader(paths, (32, 32), 3, shuffle=False, num_workers=2))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["mask"], b["mask"])


def test_an_unsupported_tiff_takes_the_counted_numpy_path(built, tmp_path):
    """A compressed TIFF: the library refuses it, the numpy path reads it, as
    the JAX loader's default transform does."""
    arr = np.random.default_rng(4).integers(1, 255, size=(30, 26)).astype(np.uint8)
    path = str(tmp_path / "lzw.tif")
    Image.fromarray(arr).save(path, format="TIFF", compression="tiff_lzw")
    assert native.preprocess_tiff(path, (16, 16)) is None
    native.reset_counts()
    ours = ShardedDataLoader([path], (16, 16), 1, num_workers=1)
    got = next(iter(ours))["image"]
    ours.close()
    assert (native.decoded, native.python_path) == (0, 1)
    want = next(iter(JaxLoader([path], (16, 16), 1, shuffle=False, num_workers=1)))["image"]
    np.testing.assert_array_equal(got, want)


def test_a_transform_argument_replaces_the_default(built, tmp_path):
    path = str(tmp_path / "a.tif")
    write_tif(path, _image(5, (20, 20)))
    native.reset_counts()
    loader = ShardedDataLoader([path], (8, 8), 1, num_workers=1,
                               transform=lambda p: np.full((8, 8, 1), 7.0, np.float32))
    batch = next(iter(loader))
    loader.close()
    assert (batch["image"] == 7.0).all() and (native.decoded, native.python_path) == (0, 0)


def test_a_failed_build_warns(tmp_path, monkeypatch, capsys):
    bad = tmp_path / "ptidata.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    assert native.preprocess_tiff(str(bad), (8, 8)) is None
    err = capsys.readouterr().err
    assert err.count("[WARN] native: the TIFF library did not build") == 1  # once per process


@pytest.mark.parametrize("shape,out_hw", [((2, 300, 300, 1), (256, 256)), ((3, 20, 24, 2), (32, 40)),
                                          ((1, 16, 16, 1), (16, 16)), ((37, 50, 3), (16, 16)),
                                          ((45, 33), (8, 11))])
def test_resize_area_matches_jax(shape, out_hw):
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    got = resize_area(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(jax_resize_area(x, out_hw))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **DEVICE_TOL)


def test_local_normalize_by_mask_matches_jax():
    x = _image(7, (4, 24, 20, 1))
    x[1] = 0.0  # an all-background image stays 0
    x[2] = np.where(x[2] != 0, 1.5, 0.0)  # a constant foreground: the std floor
    got = local_normalize_by_mask(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_normalize(x))
    np.testing.assert_allclose(got, want, **DEVICE_TOL)
    assert not got[1].any() and (got[x == 0] == 0).all()
    np.testing.assert_allclose(local_normalize_by_mask(torch.from_numpy(x[0, :, :, 0])).numpy(),
                               np.asarray(jax_normalize(x[0, :, :, 0])), **DEVICE_TOL)


def test_preprocess_batch_device_matches_jax_at_the_path_shape():
    """[8, 300, 300, 1] -> 256² (the loader's images, ``chip_smoke.py``'s check)."""
    raw = _image(8, (8, 300, 300, 1))
    got = preprocess_batch_device(torch.from_numpy(raw), (256, 256)).numpy()
    want = np.asarray(jax_preprocess_batch(raw, (256, 256)))
    assert got.shape == (8, 256, 256, 1)
    np.testing.assert_allclose(got, want, **DEVICE_TOL)


def _preprocess_f64(raw: np.ndarray, patch) -> np.ndarray:
    """Area resize and per-image mask z-score in float64 (numpy)."""
    x = np.einsum("oh,bhwc->bowc", _area_matrix_np(raw.shape[1], patch[0]).astype(np.float64),
                  raw.astype(np.float64))
    x = np.einsum("ow,bhwc->bhoc", _area_matrix_np(raw.shape[2], patch[1]).astype(np.float64), x)
    out = np.zeros_like(x)
    for i, img in enumerate(x):
        mask = img != 0
        std = img[mask].std()
        out[i][mask] = (img[mask] - img[mask].mean()) / (std if std > 1e-5 else 1.0)
    return out


@pytest.mark.parametrize("patch", [(32, 48), (128, 128), (350, 320)])
def test_preprocess_batch_device_is_as_exact_as_jax(patch):
    """At other sizes the z-score of f32 sums over up to 10^5 pixels rounds
    differently in the two packages by up to ~1e-5 (the JAX package is itself
    8.6e-6 from a float64 evaluation at 32x48, where averaging leaves a small
    std that amplifies the mean's rounding): both are held to the float64
    evaluation, the port to no worse than the JAX package plus 1e-6."""
    raw = _image(8, (8, 300, 300, 1))
    exact = _preprocess_f64(raw, patch)
    got = preprocess_batch_device(torch.from_numpy(raw), patch).numpy()
    want = np.asarray(jax_preprocess_batch(raw, patch))
    assert got.shape == want.shape == (8, *patch, 1) and got.dtype == np.float32
    port_err, jax_err = np.abs(got - exact).max(), np.abs(want - exact).max()
    assert port_err <= jax_err + 1e-6 and port_err <= 1e-5, (port_err, jax_err)
