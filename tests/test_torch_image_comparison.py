"""The port's GT-vs-synthesis comparison suite
(``pti_ldm_vae_tpu_torch/analysis/metrics.py``) against the JAX package's on
the same inputs and VGG16 weights, on the CPU: the seeded VGG16 init bit for
bit; features within 1e-4 of their largest magnitude (cuDNN's form and the
convolution kernel's plain version); per-pair metrics exact on the
geometry, rtol 1e-6 on MSE / SSIM / PSNR and 1e-4 on the feature
distances; ``process_all_images``' dicts (geometry and threshold counts
exact, the rest rtol 1e-4) and CSVs (``_dimensions.csv`` byte for byte)."""

import csv
import io
import logging

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from pti_ldm_vae_tpu.analysis import metrics as jax_metrics
from pti_ldm_vae_tpu.data.io import write_tif
from pti_ldm_vae_tpu_torch.analysis import ImageComparison
from pti_ldm_vae_tpu_torch.analysis import metrics
from pti_ldm_vae_tpu_torch.data.io import read_image

EXACT = ("Dice Coefficient", "Dice Loss", "IoU", "Height Metric", "Width Metric Upper",
         "Width Metric Middle", "Width Metric Lower", "Absolute Height Difference",
         "Absolute Width Upper Difference", "Absolute Width Middle Difference",
         "Absolute Width Lower Difference")
RECON = ("MSE", "SSIM", "PSNR")
FEATURE = ("Cosine Similarity", "Euclidean Distance")


@pytest.fixture(autouse=True)
def _no_vgg_weights(monkeypatch):
    monkeypatch.setenv("PTI_VGG16_WEIGHTS", "none")


@pytest.fixture(scope="module")
def comparisons():
    """One JAX and one port (CPU) comparison object for the module; the VGG16
    weights are both packages' seeded init (no weights ship)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PTI_VGG16_WEIGHTS", "none")
        return jax_metrics.ImageComparison(), ImageComparison(device="cpu")


def ellipse_image(seed: int, axes=(12, 22), angle=0.0, value=1.0, side=64, center=(32, 32)):
    """A filled float32 ellipse with noise inside (the JAX tests' pairs are such)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((side, side), np.float32)
    cv2.ellipse(img, center, axes, angle, 0, 360, value, -1)
    return img + rng.normal(scale=0.01, size=img.shape).astype(np.float32) * (img > 0)


def synthetic_pair(seed: int):
    rng = np.random.default_rng(seed)
    if seed == 0:  # the JAX tests' pair: axis-aligned
        return ellipse_image(0), ellipse_image(100, (10, 20), value=0.9)
    gt = ellipse_image(seed, (int(rng.integers(9, 14)), int(rng.integers(20, 25))),
                       float(rng.uniform(-20, 20)), center=(31, 37))
    pred = ellipse_image(seed + 100, (int(rng.integers(8, 13)), int(rng.integers(20, 25))),
                         float(rng.uniform(-20, 20)), float(rng.uniform(0.6, 1.0)), center=(33, 36))
    return gt, pred


def test_init_vgg_params_bit_equal():
    ours, theirs = metrics._init_vgg_params(0), jax_metrics._init_vgg_params(0)
    assert len(ours) == len(theirs) == 13
    for a, b in zip(ours, theirs):
        for k in ("w", "b"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_load_vgg_params_rules(tmp_path, monkeypatch, caplog):
    with caplog.at_level(logging.WARNING):
        params = metrics._load_vgg_params()
    assert "DETERMINISTIC RANDOM" in caplog.text
    np.testing.assert_array_equal(params[3]["w"], metrics._init_vgg_params(0)[3]["w"])
    path = tmp_path / "vgg.npz"
    rng = np.random.default_rng(1)
    arrays = {f"conv{i}/{k}": rng.standard_normal(p[k].shape).astype(np.float32)
              for i, p in enumerate(params) for k in ("w", "b")}
    np.savez(path, **arrays)
    monkeypatch.setenv("PTI_VGG16_WEIGHTS", str(path))
    loaded = metrics._load_vgg_params()
    assert len(loaded) == 13
    np.testing.assert_array_equal(loaded[12]["b"], arrays["conv12/b"])
    state = metrics.vgg16_params_to_torch(loaded)
    np.testing.assert_array_equal(state["convs.5.weight"].numpy(),
                                  arrays["conv5/w"].transpose(3, 2, 0, 1))
    metrics.VGG16Features().load_state_dict(state)  # every key, every shape


def test_vgg16_convolutions_run_without_tf32(monkeypatch):
    """PyTorch lets cuDNN run f32 convolutions in TF32 by default; VGG16 turns
    that off for its own convolutions, whatever the caller set, and restores
    the caller's setting after them."""
    seen, conv2d = [], torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(metrics.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with torch.inference_mode():
        assert metrics.VGG16Features()(torch.zeros(1, 32, 32, 3)).shape == (1, 512)
    assert len(seen) == 13 and not any(seen)
    assert torch.backends.cudnn.allow_tf32


def test_vgg16_features_against_jax(comparisons):
    """Both of the port's forms (F.conv2d, and the kernel's plain version that
    ``conv_kernel=True`` runs on CPU tensors) on one normalized input."""
    jax_cmp, port = comparisons
    img = ellipse_image(3, (20, 40), 10.0, side=256, center=(128, 120))
    rgb = cv2.resize(cv2.cvtColor(cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8),
                                  cv2.COLOR_GRAY2RGB), (224, 224), interpolation=cv2.INTER_LINEAR)
    x = ((rgb.astype(np.float32) / 255.0 - metrics._IMAGENET_MEAN) / metrics._IMAGENET_STD)[None]
    want = np.asarray(jax_cmp._vgg_features(x))
    assert want.shape == (25088,)
    bar = 1e-4 * np.abs(want).max()
    got = port._vgg_features(x)
    assert got.shape == want.shape and np.abs(got - want).max() <= bar
    with_kernel = metrics.vgg16_features_fn("cpu", conv_kernel=True)
    assert np.abs(with_kernel(x) - want).max() <= bar
    # the port's own preprocessing gives the JAX package's input, bit for bit
    np.testing.assert_array_equal(metrics.vgg16_input(img), x)


@pytest.mark.parametrize("seed", range(8))
def test_geometry_against_jax(comparisons, seed):
    """Masks, straightening, alignment and dimensions on pairs at random
    angles (and the JAX tests' axis-aligned pair), no VGG16."""
    jax_cmp, port = comparisons
    gt, pred = synthetic_pair(seed)
    for kind, img in (("gt", gt), ("pred", pred)):
        np.testing.assert_array_equal(port.generate_clean_mask(img, kind),
                                      jax_cmp.generate_clean_mask(img, kind))
    rot = [port.straighten_image(img) for img in (gt, pred)]
    want_rot = [jax_cmp.straighten_image(img) for img in (gt, pred)]
    for got, want in zip(rot, want_rot):
        assert np.abs(got - want).max() <= 1e-5
        np.testing.assert_array_equal(got != 0, want != 0)
    aligned = port.align_images_by_bottom_20_center(*want_rot)
    np.testing.assert_array_equal(aligned, jax_cmp.align_images_by_bottom_20_center(*want_rot))
    for kind in ("gt", "pred"):
        mask = jax_cmp.generate_clean_mask(aligned, kind)
        assert port.compute_object_dimensions(mask) == jax_cmp.compute_object_dimensions(mask)
    assert (port.compute_height_width_metrics(*want_rot)
            == jax_cmp.compute_height_width_metrics(*want_rot))
    assert port.dice_coefficient(pred, gt) == jax_cmp.dice_coefficient(pred, gt)
    assert port.iou(pred, gt) == jax_cmp.iou(pred, gt)


def test_ssim_and_psnr_against_jax(comparisons):
    jax_cmp, port = comparisons
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, size=(32, 32)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    assert metrics.skimage_ssim(a, b, 1.0) == jax_metrics.skimage_ssim(a, b, 1.0)
    assert port.calculate_psnr(a, b) == jax_cmp.calculate_psnr(a, b)
    assert port.calculate_psnr(a, a) == float("inf")


def _check_metrics(got: dict, want: dict, rtol_recon: float) -> None:
    assert list(got) == list(want)
    for k in EXACT:
        assert got[k] == want[k], k
    for k in RECON:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol_recon, err_msg=k)
    for k in FEATURE:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_compare_images_against_jax(comparisons):
    jax_cmp, port = comparisons
    jax_cmp.worst_metrics, port.worst_metrics = {}, {}
    gt, pred = synthetic_pair(0)
    want = jax_cmp.compare_images_and_display_metrics(gt, pred, original_image="a")
    got = port.compare_images_and_display_metrics(gt, pred, original_image="a")
    _check_metrics(got, want, 1e-6)
    assert got["Height Metric"] == pytest.approx(41 / 45)
    assert set(port.worst_metrics) == set(jax_cmp.worst_metrics)
    for k, (value, tag) in port.worst_metrics.items():
        assert tag == "a" and value == got[k]


def test_process_all_images_against_jax(comparisons, tmp_path):
    """Three pairs at 64² (the JAX test's pair and two at random angles): the
    returned dicts, then the CSVs and the plot of each package, in turn in
    one folder (the listing order is the folder's)."""
    for sub in ("edente", "edente_synth"):
        (tmp_path / sub).mkdir()
    for i in range(3):
        gt, pred = synthetic_pair(i)
        write_tif(str(tmp_path / "edente" / f"img_{i}.tif"), gt)
        write_tif(str(tmp_path / "edente_synth" / f"img_{i}.tif"), pred)
    folder = tmp_path / "edente"
    outputs = ("_metrics.csv", "_dimensions.csv", "_metrics_distribution.png")

    def run(comparison):
        avg, ci = comparison.process_all_images([str(folder)], save_csv=True)
        files = {name: (folder / name).read_bytes() for name in outputs}
        for name in outputs:
            (folder / name).unlink()
        return avg, ci, files

    jax_cmp, port = comparisons
    jax_cmp.worst_metrics, port.worst_metrics = {}, {}
    want_avg, want_ci, want_files = run(jax_cmp)
    avg, ci, files = run(port)
    _check_metrics(avg, want_avg, 1e-4)
    assert list(ci) == list(want_ci)
    for k in ci:
        np.testing.assert_allclose(ci[k], want_ci[k], rtol=1e-4, atol=1e-12, err_msg=k)
    assert files["_dimensions.csv"] == want_files["_dimensions.csv"]
    ours = list(csv.reader(io.StringIO(files["_metrics.csv"].decode()), delimiter=";"))
    theirs = list(csv.reader(io.StringIO(want_files["_metrics.csv"].decode()), delimiter=";"))
    assert len(ours) == len(theirs) == 1 + 16 + 12 and ours[0] == theirs[0]
    for row, want_row in zip(ours[1:], theirs[1:]):
        assert row[0] == want_row[0]
        tol = 1e-4 if row[0] in RECON + FEATURE else 0.0
        for cell, want_cell in zip(row[1:], want_row[1:]):
            assert (cell == "") == (want_cell == "")
            assert ("." in cell) == ("." in want_cell)  # "3.0" where pandas writes a float
            if cell:
                # CSV values are rounded to 3 places: within the bar or one rounding step
                assert abs(float(cell) - float(want_cell)) <= max(
                    tol * abs(float(want_cell)), 1e-3 if tol else 0.0), (row[0], cell, want_cell)
    (tmp_path / "plot.png").write_bytes(files["_metrics_distribution.png"])
    # 15 panels (every metric but the Euclidean distance), 3 a row, 400 x 500 pixels each
    assert read_image(str(tmp_path / "plot.png")).shape == (5 * 400, 1500, 3)


def test_csv_writer_matches_pandas(tmp_path):
    """Ints, floats, an int column with gaps (pandas writes it as floats),
    NaN and inf, and a cell that needs quoting."""
    rows = [{"Metric": "a;b", "Average": 0.123, "Count": None, "N": 3},
            {"Metric": 'say "x"', "Average": float("nan"), "Count": 7, "N": 4},
            {"Metric": "c", "Average": float("inf"), "N": 5, "Percentage": 33.33},
            {"Metric": "d", "Average": 1e-05, "Count": 2, "N": 6, "Percentage": 100.0}]
    metrics._write_csv(str(tmp_path / "ours.csv"), rows)
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=False, sep=";")
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImageComparison()
