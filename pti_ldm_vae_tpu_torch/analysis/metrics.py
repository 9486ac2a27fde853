"""GT-vs-synthesized image comparison suite (counterpart of
``pti_ldm_vae_tpu/analysis/metrics.py``).

Reference ``src/pti_ldm_vae/analysis/metrics.py``: reconstruction metrics
(MSE / SSIM / PSNR), Dice / IoU on derived masks (pred mask = |x| > 0.2 and
its largest contour), VGG16 feature cosine / Euclidean similarity,
ellipse-fit straightening, bottom-20%-centre alignment, height and
width-at-thirds, outlier counts, CSV reports and distribution plots.

- The geometry runs on the host through ``utils/imgproc.py``, the port's own
  copy of the OpenCV calls the JAX module makes (the card's machine has no
  OpenCV); the CSVs are written here with the bytes pandas writes, and the
  distribution plot is drawn with numpy (``utils/visualization.py``).
- VGG16's 13 convolutions run on ``device``: ``F.conv2d`` (cuDNN on the card,
  channels-last) by default, or with ``conv_kernel=True`` the hand-written
  3x3 convolution kernel (``ops/conv.py:conv3x3``, which runs its plain
  version on CPU tensors). No VGG16 weights ship: ``$PTI_VGG16_WEIGHTS`` or
  ``weights/vgg16_features.npz`` (``tools/convert_vgg16_weights.py``), else
  the JAX package's seeded random init, bit for bit.
"""

from __future__ import annotations

import contextlib
import csv
import logging
import os
import random
import traceback
from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from scipy.ndimage import uniform_filter
from scipy.spatial.distance import euclidean

from ..data.io import read_image, write_png
from ..ops.conv import conv3x3
from ..utils import imgproc
from ..utils.cli_common import resolve_device
from ..utils.visualization import draw_histogram_panels

__all__ = ["ImageComparison", "VGG16Features", "skimage_ssim", "vgg16_conv_shapes",
           "vgg16_features_fn", "vgg16_input", "vgg16_params_to_torch"]


def skimage_ssim(im1: np.ndarray, im2: np.ndarray, data_range: float) -> float:
    """scikit-image ``structural_similarity`` (defaults: win=7, uniform
    filter, unbiased covariance, crop edges) on scipy."""
    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    win_size = 7
    np_window = win_size ** im1.ndim
    cov_norm = np_window / (np_window - 1)

    def filt(x):
        return uniform_filter(x, size=win_size)

    ux, uy = filt(im1), filt(im2)
    uxx, uyy, uxy = filt(im1 * im1), filt(im2 * im2), filt(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


# --------------------------------------------------------------- VGG16 ----
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
VGG_SIZE = 224


def vgg16_conv_shapes(batch: int = 1, size: int = VGG_SIZE) -> list[tuple[int, int, int, int, int]]:
    """``(B, H, W, Cin, Cout)`` of VGG16's 13 convolutions, in order, at
    ``batch`` images of ``size``² (9 distinct shapes at 224²)."""
    shapes, cin, side = [], 3, size
    for item in _VGG_CFG:
        if item == "M":
            side //= 2
        else:
            shapes.append((batch, side, side, cin, item))
            cin = item
    return shapes


def _init_vgg_params(seed: int = 0) -> list[dict]:
    """He-normal HWIO weights and zero biases from numpy's ``default_rng(seed)``,
    in the JAX package's order (the same arrays, bit for bit)."""
    rng = np.random.default_rng(seed)
    params = []
    in_ch = 3
    for item in _VGG_CFG:
        if item == "M":
            continue
        fan_in = in_ch * 9
        params.append({
            "w": (rng.standard_normal((3, 3, in_ch, item)) * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "b": np.zeros((item,), dtype=np.float32),
        })
        in_ch = item
    return params


def _load_vgg_params(seed: int = 0) -> list[dict]:
    """Converted IMAGENET1K_V1 weights (``conv{i}/w`` HWIO, ``conv{i}/b``) from
    ``$PTI_VGG16_WEIGHTS`` or ``weights/vgg16_features.npz``; ``"none"``
    skips both; with neither, the seeded init and a warning."""
    env = os.environ.get("PTI_VGG16_WEIGHTS")
    if env == "none":  # explicit opt-out (test isolation from weights/)
        candidates = []
    else:
        candidates = [
            env,
            os.path.join(os.path.dirname(__file__), "..", "..", "weights", "vgg16_features.npz"),
        ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            raw = np.load(cand)
            n = len([k for k in raw.files if k.endswith("/w")])
            return [{"w": raw[f"conv{i}/w"], "b": raw[f"conv{i}/b"]} for i in range(n)]
    logging.getLogger(__name__).warning(
        "VGG16: no pretrained weights found; ImageComparison feature "
        "similarities use DETERMINISTIC RANDOM features (not ImageNet). "
        "Convert real weights with tools/convert_vgg16_weights.py and set "
        "$PTI_VGG16_WEIGHTS or place weights/vgg16_features.npz."
    )
    return _init_vgg_params(seed)


def vgg16_params_to_torch(params: list[dict]) -> dict[str, torch.Tensor]:
    """The JAX package's ``[{"w": HWIO, "b"}]`` list (numpy) as
    ``VGG16Features``' state dict: ``convs.{i}.weight`` OIHW, ``convs.{i}.bias``."""
    state = {}
    for i, p in enumerate(params):
        state[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)))
        state[f"convs.{i}.bias"] = torch.from_numpy(np.asarray(p["b"], np.float32).copy())
    return state


@contextlib.contextmanager
def _true_f32():
    """cuDNN's f32 convolutions in f32: PyTorch lets them run in TF32 by
    default (``torch.backends.cudnn.allow_tf32``), which keeps about three
    decimal digits. The flag is restored on the way out."""
    allowed = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allowed


class VGG16Features(nn.Module):
    """torchvision's ``vgg16().features``: 13 3x3 SAME convolutions with ReLU
    and five 2x2 max pools, f32 (TF32 off for its own calls, whatever the
    caller's setting). NHWC in ``[B, 224, 224, 3]``, out ``[B, 25088]``
    flattened in NCHW order (the reference's layout). ``conv_kernel`` sends
    the convolutions through ``ops/conv.py:conv3x3`` (the hand-written kernel
    on CUDA tensors), else ``F.conv2d`` on the channels-last view."""

    def __init__(self, conv_kernel: bool = False):
        super().__init__()
        widths = [c for c in _VGG_CFG if c != "M"]
        self.convs = nn.ModuleList(nn.Conv2d(cin, cout, 3, padding=1)
                                   for cin, cout in zip([3] + widths[:-1], widths))
        self.conv_kernel = conv_kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _true_f32():
            return self._features(x)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        convs = iter(self.convs)
        for item in _VGG_CFG:
            if item == "M":
                b, hh, ww, c = h.shape
                h = h.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
                continue
            conv = next(convs)
            if self.conv_kernel:
                h = conv3x3(h, conv.weight, conv.bias)
            else:
                nchw = h.permute(0, 3, 1, 2)  # the channels-last view of the NHWC tensor
                h = F.conv2d(nchw, conv.weight, conv.bias, padding=1).permute(0, 2, 3, 1)
            h = F.relu(h)
        return h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)


def vgg16_input(image: np.ndarray) -> np.ndarray:
    """VGG16's input for a 2-D float image (reference ``metrics.py:211-227``):
    min-max to uint8, gray to RGB, 224² bilinear resize, ImageNet
    normalisation; float32 ``[1, 224, 224, 3]``."""
    rgb = imgproc.gray2rgb(imgproc.normalize_minmax_u8(image))
    resized = imgproc.resize_linear_u8(rgb, (VGG_SIZE, VGG_SIZE))
    x = resized.astype(np.float32) / 255.0
    return ((x - _IMAGENET_MEAN) / _IMAGENET_STD)[None]


def vgg16_features_fn(device: str | torch.device = "cuda", conv_kernel: bool = False):
    """VGG16 ``features`` on ``device`` with the weights of ``_load_vgg_params``:
    a function of a float32 ``[1, 224, 224, 3]`` array (numpy or tensor) that
    returns the flat vector of 25 088 floats as numpy."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    device = resolve_device(str(device))
    model = VGG16Features(conv_kernel=conv_kernel)
    model.load_state_dict(vgg16_params_to_torch(_load_vgg_params()))
    model = model.to(device).eval()

    def features(x) -> np.ndarray:
        with torch.inference_mode():
            t = torch.as_tensor(np.asarray(x, np.float32)).to(device)
            return model(t).reshape(-1).float().cpu().numpy()

    features.model, features.device = model, device
    return features


# ------------------------------------------------------------- CSV ----
def _csv_cells(column: list) -> list[str]:
    """One column's cells as pandas ``to_csv`` writes them: an int column as
    ints; a column with a float or a missing value (``None``, NaN) as
    float64, its values in numpy's shortest repr (``3.0``) and NaN empty;
    strings as they are."""
    if all(isinstance(v, str) for v in column):
        return list(column)
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in column):
        return [str(int(v)) for v in column]
    values = np.array([np.nan if v is None else float(v) for v in column], np.float64)
    cells = values.astype(str)
    cells[np.isnan(values)] = ""
    return cells.tolist()


def _write_csv(path: str, rows: list[dict]) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False, sep=";")``: the columns
    in order of first appearance, a key a row lacks written empty."""
    columns: list[str] = []
    for row in rows:
        columns += [k for k in row if k not in columns]
    cells = [_csv_cells([row.get(k) for row in rows]) for k in columns]
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, delimiter=";", lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*cells))


class ImageComparison:
    """API parity with the JAX package's class (reference ``metrics.py:29-810``).

    ``device`` runs VGG16 (``"cuda"`` by default; without CUDA it raises
    unless ``"cpu"`` is asked for); ``conv_kernel`` sends its convolutions
    through the hand-written 3x3 kernel. Everything else runs on the host."""

    def __init__(self, apply_otsu_mask: bool = False, *, device: str | torch.device = "cuda",
                 conv_kernel: bool = False) -> None:
        self.apply_otsu_mask = apply_otsu_mask
        self._vgg_features = vgg16_features_fn(device, conv_kernel=conv_kernel)
        self.device = self._vgg_features.device
        self.worst_metrics: dict[str, tuple[float, Any]] = {}

    # -- IO -------------------------------------------------------------
    def _to_2d(self, img: np.ndarray) -> np.ndarray:
        img = np.squeeze(np.asarray(img))
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        if img.ndim != 2:
            raise ValueError(f"Image must be 2D after squeeze, got shape {img.shape}")
        return img.astype(np.float32)

    def get_image_pair(self, image_path: str):
        """GT from ``edente/``, prediction from ``edente_synth/`` with the
        same filename (reference ``metrics.py:75-114``)."""
        norm = os.path.normpath(image_path)
        parts = norm.split(os.sep)
        if "edente_synth" in parts:
            idx = parts.index("edente_synth")
            pred_path = norm
            parts[idx] = "edente"
            gt_path = os.sep.join(parts)
        elif "edente" in parts:
            idx = parts.index("edente")
            gt_path = norm
            parts[idx] = "edente_synth"
            pred_path = os.sep.join(parts)
        else:
            raise ValueError("get_image_pair expects path containing 'edente' or 'edente_synth'.")
        if not os.path.isfile(gt_path):
            raise FileNotFoundError(f"Ground truth file missing: {gt_path}")
        if not os.path.isfile(pred_path):
            raise FileNotFoundError(f"Prediction file missing: {pred_path}")
        return self._to_2d(read_image(gt_path)), self._to_2d(read_image(pred_path)), None

    def get_all_files_from_folders(self, folder_paths, file_selection_mode="all", n=None):
        all_paths = []
        for folder in folder_paths:
            for root, _, files in os.walk(folder):
                all_paths.extend(os.path.join(root, f) for f in files)
        if file_selection_mode == "random_n" and n is not None:
            all_paths = random.sample(all_paths, min(n, len(all_paths)))
        elif file_selection_mode == "last_n" and n is not None:
            all_paths = all_paths[-n:]
        return all_paths

    # -- masks / overlap -------------------------------------------------------
    def generate_clean_mask(self, image: np.ndarray, kind: str = "gt") -> np.ndarray:
        """GT: nonzero. Pred: |x| > 0.2, then largest contour only
        (reference ``metrics.py:143-168``)."""
        if kind == "gt":
            mask = (image != 0).astype(np.uint8)
        else:
            mask = ((image > 0.2) | (image < -0.2)).astype(np.uint8)
            contours = imgproc.find_external_contours(mask)
            if contours:
                biggest = max(contours, key=imgproc.contour_area)
                mask = imgproc.fill_contour(mask.shape, biggest)
        return (mask * 255).astype(np.uint8)

    def dice_coefficient(self, prediction, gt, smooth: float = 1e-6) -> float:
        pred_bin = self.generate_clean_mask(prediction, kind="pred").flatten() / 255.0
        gt_bin = self.generate_clean_mask(gt, kind="gt").flatten() / 255.0
        intersection = np.sum(pred_bin * gt_bin)
        union = np.sum(pred_bin) + np.sum(gt_bin)
        return float((2.0 * intersection + smooth) / (union + smooth))

    def iou(self, prediction, gt) -> float:
        pred_bin = self.generate_clean_mask(prediction, kind="pred").flatten() / 255.0
        gt_bin = self.generate_clean_mask(gt, kind="gt").flatten() / 255.0
        intersection = np.sum(pred_bin * gt_bin)
        union = np.sum((pred_bin + gt_bin) > 0)
        return 1.0 if union == 0 else float(intersection / union)

    # -- features -------------------------------------------------------------
    def extract_features(self, image: np.ndarray) -> np.ndarray:
        """VGG16 features of ``vgg16_input(image)`` on the device."""
        return self._vgg_features(vgg16_input(image))

    # -- geometry -------------------------------------------------------------
    def align_images_by_bottom_20_center(self, image1, image2, verbosity=False):
        """Shift image2 so the bottom-20% mask centers line up
        (reference ``metrics.py:229-279``)."""
        if image1.shape != image2.shape:
            raise ValueError("Images do not have the same dimensions. Resize them to match.")

        def bottom_center(image):
            height = image.shape[0]
            region = self.generate_clean_mask(image, kind="gt")[-int(height * 0.2):, :]
            cols = np.column_stack(np.where(region == 255))
            return int(np.mean(cols[:, 1])) if len(cols) else None

        c1, c2 = bottom_center(image1), bottom_center(image2)
        if c1 is None or c2 is None:
            raise ValueError("Could not find white pixels in bottom 20% of one or both images.")
        shift = c1 - c2
        if shift > 0:
            out = np.zeros_like(image2)
            out[:, shift:] = image2[:, :-shift]
        elif shift < 0:
            out = np.zeros_like(image2)
            out[:, :shift] = image2[:, -shift:]
        else:
            out = image2.copy()
        return out

    def straighten_image(self, image, verbosity=False):
        """Ellipse-fit rotation (reference ``metrics.py:281-310``)."""
        binary = self.generate_clean_mask(image, kind="gt")
        contours = imgproc.find_external_contours(binary)
        if not contours:
            raise ValueError("No contours found in the image.")
        contour = max(contours, key=imgproc.contour_area)
        if len(contour) < 5:
            raise ValueError("Not enough points to fit an ellipse.")
        angle = imgproc.fit_ellipse(contour)[2]
        if angle > 90:
            angle -= 180
        h, w = image.shape[:2]
        rot = imgproc.get_rotation_matrix_2d((w // 2, h // 2), angle, 1.0)
        return imgproc.warp_affine(image, rot, (w, h), interpolation="cubic", border="replicate")

    def compute_object_dimensions(self, binary_image):
        """(height, width_upper, width_middle, width_lower)
        (reference ``metrics.py:312-343``)."""
        contours = imgproc.find_external_contours(binary_image)
        if not contours:
            raise ValueError("No contours found in the binary image.")
        x, y, w, h = imgproc.bounding_rect(max(contours, key=imgproc.contour_area))
        rows = (y + h // 4, y + h // 2, y + 3 * h // 4)
        widths = [int(np.sum(binary_image[r, x : x + w] == 255)) for r in rows]
        return h, widths[0], widths[1], widths[2]

    def compute_height_width_metrics(self, gt_img, gen_img) -> dict[str, float]:
        gt_dims = self.compute_object_dimensions(self.generate_clean_mask(gt_img, "gt"))
        gen_dims = self.compute_object_dimensions(self.generate_clean_mask(gen_img, "pred"))
        names = ("height", "width_upper", "width_middle", "width_lower")
        out: dict[str, float] = {}
        for name, a, b in zip(names, gt_dims, gen_dims):
            key = "height_metric" if name == "height" else f"width_metric_{name.split('_')[1]}"
            out[key] = min(a, b) / max(a, b) if max(a, b) else 1.0
            diff_key = ("abs_height_diff" if name == "height"
                        else f"abs_{name}_diff")
            out[diff_key] = abs(a - b)
        return out

    def calculate_psnr(self, gt_img, gen_img) -> float:
        mse = float(np.mean((np.asarray(gt_img, np.float64) - np.asarray(gen_img, np.float64)) ** 2))
        if mse == 0:
            return float("inf")
        pixel_max = max(float(np.max(gt_img)), float(np.max(gen_img)))
        return float(20 * np.log10(pixel_max / np.sqrt(mse)))

    # -- full comparison ---------------------------------------------------------
    _HIGHER_BETTER = {
        "SSIM", "PSNR", "Dice Coefficient", "Cosine Similarity", "IoU",
        "Height Metric", "Width Metric Upper", "Width Metric Middle", "Width Metric Lower",
    }

    def compare_images_and_display_metrics(self, gt_img, gen_img, original_image=None):
        """All metrics for one pair (reference ``metrics.py:400-482``). The
        JAX method also computes the Manhattan, Chebyshev and Minkowski
        distances of the features and discards them; they are left out."""
        if gen_img.shape != gt_img.shape:
            raise ValueError("Images do not have the same dimensions. Resize them to match.")
        mse_value = float(np.mean((gen_img.astype(np.float64) - gt_img.astype(np.float64)) ** 2))
        ssim_value = skimage_ssim(gen_img, gt_img, data_range=float(gt_img.max() - gt_img.min()))
        psnr_value = self.calculate_psnr(gt_img, gen_img)
        dice_value = self.dice_coefficient(gen_img, gt_img)
        iou_value = self.iou(gen_img, gt_img)

        f_gen = self.extract_features(gen_img)
        f_gt = self.extract_features(gt_img)
        cos = float(np.dot(f_gen, f_gt) / (np.linalg.norm(f_gen) * np.linalg.norm(f_gt) + 1e-12))
        eucl = round(float(euclidean(f_gen, f_gt)), 2)

        hw = self.compute_height_width_metrics(gt_img, gen_img)
        metrics = {
            "MSE": mse_value,
            "SSIM": ssim_value,
            "PSNR": psnr_value,
            "Dice Coefficient": dice_value,
            "Dice Loss": 1 - dice_value,
            "IoU": iou_value,
            "Cosine Similarity": cos,
            "Euclidean Distance": eucl,
            "Height Metric": hw["height_metric"],
            "Width Metric Upper": hw["width_metric_upper"],
            "Width Metric Middle": hw["width_metric_middle"],
            "Width Metric Lower": hw["width_metric_lower"],
            "Absolute Height Difference": hw["abs_height_diff"],
            "Absolute Width Upper Difference": hw["abs_width_upper_diff"],
            "Absolute Width Middle Difference": hw["abs_width_middle_diff"],
            "Absolute Width Lower Difference": hw["abs_width_lower_diff"],
        }
        for name, value in metrics.items():
            if name not in self.worst_metrics:
                self.worst_metrics[name] = (value, original_image)
            elif name in self._HIGHER_BETTER:
                if value < self.worst_metrics[name][0]:
                    self.worst_metrics[name] = (value, original_image)
            elif value > self.worst_metrics[name][0]:
                self.worst_metrics[name] = (value, original_image)
        return metrics

    # -- aggregates --------------------------------------------------------------
    def count_outliers(self, all_metrics, metrics_avg, metrics_ci95):
        """CI / IQR / z-score outlier counts (reference ``metrics.py:484-541``)."""
        counts = {k: {} for k in
                  ("outside_1_ci", "outside_2_ci", "outside_3_ci", "outside_iqr", "outside_z")}
        for key in metrics_avg:
            data = np.array([m[key] for m in all_metrics], dtype=np.float64)
            mean = metrics_avg[key]
            std = np.std(data)
            ci_lower, ci_upper = metrics_ci95[key]
            margin = (ci_upper - ci_lower) / 2
            z = (data - mean) / std if std else np.zeros_like(data)
            q1, q3 = np.percentile(data, [25, 75])
            iqr = q3 - q1
            counts["outside_z"][key] = int(np.sum(np.abs(z) > 3))
            counts["outside_iqr"][key] = int(
                np.sum((data < q1 - 1.5 * iqr) | (data > q3 + 1.5 * iqr))
            )
            counts["outside_1_ci"][key] = int(np.sum((data < ci_lower) | (data > ci_upper)))
            counts["outside_2_ci"][key] = int(
                np.sum((data < mean - 2 * margin) | (data > mean + 2 * margin))
            )
            counts["outside_3_ci"][key] = int(
                np.sum((data < mean - 3 * margin) | (data > mean + 3 * margin))
            )
        return counts

    def plot_metric_distributions_with_ci(self, all_metrics, metrics_avg, metrics_ci95,
                                          save_path=None):
        """Histogram panels with the mean, IQR and z-score lines (reference
        ``metrics.py:543-618``), drawn with numpy: no titles or legends."""
        exclude = {"Euclidean Distance", "Manhattan Distance", "Chebyshev Distance",
                   "Minkowski Distance"}
        panels = []
        for key in (k for k in metrics_avg if k not in exclude):
            data = np.array([m[key] for m in all_metrics], dtype=np.float64)
            mean = metrics_avg[key]
            std = np.std(data)
            q1, q3 = np.percentile(data, [25, 75])
            iqr = q3 - q1
            panels.append((data, [(mean, "#FF0000", True),
                                  (q1 - 1.5 * iqr, "#FFA500", False),
                                  (q3 + 1.5 * iqr, "#FFA500", False),
                                  (mean - 3 * std, "#FF0000", False),
                                  (mean + 3 * std, "#FF0000", False)]))
        if save_path:
            write_png(save_path, draw_histogram_panels(panels))

    def process_all_images(self, folder_paths, file_selection_mode="all", n=None,
                           verbose=False, save_csv=False):
        """Full pipeline over ``edente``/``edente_synth`` pairs
        (reference ``metrics.py:620-810``): clean -> straighten -> align ->
        dimensions + metrics -> aggregates, threshold counters, CSV, plots.
        A pair that raises is counted out and skipped, as in the JAX method."""
        all_metrics = []
        all_paths = self.get_all_files_from_folders(folder_paths, file_selection_mode, n)
        num_images = len(all_paths)
        thresholds = {f"{kind}_{level}": 0
                      for kind in ("height", "width") for level in (90, 95, 97)}
        rows = []
        for path in all_paths:
            try:
                gt, pred, _ = self.get_image_pair(path)
                pred = pred * (self.generate_clean_mask(pred, kind="pred") > 0)
                rot_gt = self.straighten_image(gt, verbosity=verbose)
                rot_gen = self.straighten_image(pred, verbosity=verbose)
                aligned = self.align_images_by_bottom_20_center(rot_gt, rot_gen, verbose)
                gt_dims = self.compute_object_dimensions(self.generate_clean_mask(rot_gt, "gt"))
                gen_dims = self.compute_object_dimensions(self.generate_clean_mask(aligned, "pred"))
                rows.append([os.path.basename(path), *gt_dims, *gen_dims])
                metrics = self.compare_images_and_display_metrics(rot_gt, aligned)
                all_metrics.append(metrics)
                for level in (90, 95, 97):
                    if metrics["Height Metric"] > level / 100:
                        thresholds[f"height_{level}"] += 1
                    if metrics["Width Metric Middle"] > level / 100:
                        thresholds[f"width_{level}"] += 1
            except Exception:
                num_images -= 1
                if verbose:
                    print(f"Failed to process image {path}: {traceback.format_exc()}")
                continue

        if not all_metrics:
            raise RuntimeError("No image pairs processed successfully.")

        metrics_avg = {k: float(np.mean([m[k] for m in all_metrics])) for k in all_metrics[0]}
        metrics_std = {k: float(np.std([m[k] for m in all_metrics])) for k in all_metrics[0]}
        metrics_ci95 = {
            k: (metrics_avg[k] - 1.96 * metrics_std[k] / np.sqrt(num_images),
                metrics_avg[k] + 1.96 * metrics_std[k] / np.sqrt(num_images))
            for k in metrics_avg
        }
        outliers = self.count_outliers(all_metrics, metrics_avg, metrics_ci95)

        dim_columns = ["Image Path", "GT Height", "GT Width Upper", "GT Width Middle",
                       "GT Width Lower", "Gen Height", "Gen Width Upper", "Gen Width Middle",
                       "Gen Width Lower"]
        dims = np.array([r[1:] for r in rows], np.int64).reshape(-1, 8)
        h_diff = np.abs(dims[:, 4] - dims[:, 0])
        wm_diff = np.abs(dims[:, 6] - dims[:, 2])
        wl_diff = np.abs(dims[:, 7] - dims[:, 3])

        if save_csv:
            out_rows = [{
                "Metric": k,
                "Average": round(metrics_avg[k], 3),
                "Worst Value": round(self.worst_metrics[k][0], 3),
                "Confidence Interval Lower (95%)": round(metrics_ci95[k][0], 3),
                "Confidence Interval Upper (95%)": round(metrics_ci95[k][1], 3),
                "Number of Images Processed": num_images,
                "Outside 1 CI": outliers["outside_1_ci"][k],
                "Outside 2 CI": outliers["outside_2_ci"][k],
                "Outside 3 CI": outliers["outside_3_ci"][k],
                "IQR Outliers": outliers["outside_iqr"][k],
                "Z-Score Outliers": outliers["outside_z"][k],
            } for k in metrics_avg]
            for name, count in [
                ("Exams with Height Metric > 0.95", thresholds["height_95"]),
                ("Exams with Width Metric > 0.95", thresholds["width_95"]),
                ("Exams with Height Metric > 0.97", thresholds["height_97"]),
                ("Exams with Width Metric > 0.97", thresholds["width_97"]),
                ("Exams with Height Metric > 0.90", thresholds["height_90"]),
                ("Exams with Width Metric > 0.90", thresholds["width_90"]),
                ("Exams with Absolute Height Difference < 5", int((h_diff < 5).sum())),
                ("Exams with Absolute Middle Width Difference < 5", int((wm_diff < 5).sum())),
                ("Exams with Absolute Lower Width Difference < 5", int((wl_diff < 5).sum())),
                ("Exams with Absolute Height Difference < 10", int((h_diff < 10).sum())),
                ("Exams with Absolute Middle Width Difference < 10", int((wm_diff < 10).sum())),
                ("Exams with Absolute Lower Width Difference < 10", int((wl_diff < 10).sum())),
            ]:
                out_rows.append({
                    "Metric": name, "Count": count,
                    "Percentage": round(count / num_images * 100, 2),
                })
            _write_csv(f"{folder_paths[0]}/_metrics.csv", out_rows)
            _write_csv(f"{folder_paths[0]}/_dimensions.csv",
                       [dict(zip(dim_columns, r)) for r in rows])

        self.plot_metric_distributions_with_ci(
            all_metrics, metrics_avg, metrics_ci95,
            save_path=f"{folder_paths[0]}/_metrics_distribution.png",
        )
        return metrics_avg, metrics_ci95
