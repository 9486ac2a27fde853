"""Display normalization for dumps (counterpart of
``pti_ldm_vae_tpu/utils/visualization.py``), and the analysis CLIs' plots
drawn with numpy.

Reference ``src/pti_ldm_vae/utils/visualization.py``: percentile [2, 98]
mask-aware display normalization (background stays black, sub-1e-3 values
suppressed), uint8 normalization and 2-D / 3-D-slice -> RGB helpers. The
projection scatter and the AR-channel grid stand in for the JAX package's
matplotlib fallbacks (``analysis/latent_space.py:277-304``,
``cli/analyze_ar_channels.py:84-118``): the same markers and filled-vs-open
rule, drawn into RGB arrays; the comparison suite's metric histograms stand
in for ``analysis/metrics.py:plot_metric_distributions_with_ci``. Host-side
numpy."""

from __future__ import annotations

import numpy as np

__all__ = ["normalize_batch_for_display", "normalize_image_to_uint8", "visualize_2d_image",
           "visualize_one_slice_in_3d_image", "draw_scatter", "draw_channel_grid",
           "draw_histogram_panels", "channel_grid_shape", "normalize_unit", "hex_to_rgb",
           "SCATTER_SHAPE"]


def normalize_batch_for_display(
    batch: np.ndarray, low: int = 2, high: int = 98
) -> np.ndarray:
    """Percentile display normalization of an NHWC batch to [0, 1];
    per-image per-channel stats over non-zero pixels."""
    arr = np.asarray(batch, dtype=np.float32)
    if arr.ndim != 4:
        raise ValueError(f"expected 4-D batch, got {arr.shape}")
    out = np.zeros_like(arr)
    for b in range(arr.shape[0]):
        for c in range(arr.shape[-1]):
            plane = arr[b, :, :, c]
            mask = plane != 0
            normed = np.zeros_like(plane)
            if np.any(mask):
                pixels = plane[mask]
                lo = np.percentile(pixels, low)
                hi = np.percentile(pixels, high)
                normed[mask] = np.clip((pixels - lo) / (hi - lo + 1e-8), 0, 1)
            normed[normed < 1e-3] = 0.0  # suppress background noise
            out[b, :, :, c] = normed
    return out


# -- plots drawn with numpy (no matplotlib on the card's machine) ------------------
# A projection scatter and the AR-channel grid are drawn into uint8 RGB arrays
# and written with ``data.io.write_png``. They carry no text: the CLIs print
# titles and labels, and the patient colours go to ``color_legend.txt``.

SCATTER_SHAPE = (800, 1000)  # (height, width) of a projection plot, pixels
SCATTER_MARGIN = 50
MARKER_RADIUS = 6
MARKER_ALPHA = 0.7
GRID_PANEL = 256  # side of one panel of the channel grid
GRID_GAP = 8
GRID_COLUMNS = 4
AR_BORDER = 4  # red frame around the panels of AR-regularized channels
# colours of the groups when points are not coloured by patient (matplotlib's first two)
GROUP_COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728")
# viridis at 10 evenly spaced points, interpolated linearly
_VIRIDIS = np.array([
    (68, 1, 84), (72, 40, 120), (62, 73, 137), (49, 104, 142), (38, 130, 142),
    (31, 158, 137), (53, 183, 121), (110, 206, 88), (181, 222, 43), (253, 231, 37),
], np.float32)


def normalize_image_to_uint8(image: np.ndarray) -> np.ndarray:
    """[min, max] -> uint8 [0, 255] (reference ``visualization.py:43-57``)."""
    draw = np.asarray(image, dtype=np.float32).copy()
    if draw.min() < 0:
        draw -= draw.min()
    if draw.max() > 0.1:
        draw /= draw.max()
    return (255 * draw).astype(np.uint8)


def visualize_2d_image(image: np.ndarray) -> np.ndarray:
    """(H, W) -> RGB uint8 (reference ``visualization.py:60-71``)."""
    draw = normalize_image_to_uint8(np.asarray(image))
    return np.stack([draw, draw, draw], axis=-1)


def visualize_one_slice_in_3d_image(image: np.ndarray, axis: int = 2) -> np.ndarray:
    """Center slice of a 3-D volume -> RGB (reference ``visualization.py:74-101``)."""
    image = np.asarray(image)
    if axis not in (0, 1, 2):
        raise ValueError(f"axis should be in [0, 1, 2], got {axis}")
    center = image.shape[axis] // 2
    return visualize_2d_image(np.take(image, center, axis=axis))


def hex_to_rgb(color: str) -> np.ndarray:
    """``"#RRGGBB"`` -> float32 ``[3]`` in 0-255."""
    color = color.lstrip("#")
    return np.array([int(color[i:i + 2], 16) for i in (0, 2, 4)], np.float32)


def _marker_mask(marker: str, radius: int) -> np.ndarray:
    """Boolean stamp ``[2r + 1, 2r + 1]`` of a marker: ``"o"`` circle,
    ``"^"`` triangle, ``"s"`` square, ``"d"`` diamond (any other: circle)."""
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1].astype(np.float32)
    if marker == "^":
        return (dy >= -radius) & (np.abs(dx) <= (dy + radius) / 2.0 + 0.5)
    if marker == "s":
        return np.maximum(np.abs(dx), np.abs(dy)) <= 0.85 * radius
    if marker == "d":
        return np.abs(dx) + np.abs(dy) <= radius
    return dx * dx + dy * dy <= radius * radius


def _stamps(marker: str, filled: bool, radius: int = MARKER_RADIUS):
    """(colour mask, white-edge mask) of one marker: a filled marker with a
    one-pixel white edge, or an open one drawn as a two-pixel ring."""
    outer = _marker_mask(marker, radius)
    inner = np.pad(_marker_mask(marker, radius - 1), 1)
    if filled:
        return inner, outer & ~inner
    return outer & ~np.pad(_marker_mask(marker, radius - 2), 2), np.zeros_like(outer)


def _blend(canvas: np.ndarray, mask: np.ndarray, top: int, left: int, rgb: np.ndarray,
           alpha: float) -> None:
    """Alpha-blend ``rgb`` into ``canvas`` (float32) where ``mask`` (placed at
    ``top``, ``left``) is set, clipped to the canvas."""
    h, w = canvas.shape[:2]
    r = mask.shape[0]
    t0, l0 = max(top, 0), max(left, 0)
    t1, l1 = min(top + r, h), min(left + r, w)
    if t0 >= t1 or l0 >= l1:
        return
    m = mask[t0 - top:t1 - top, l0 - left:l1 - left]
    region = canvas[t0:t1, l0:l1]
    region[m] = (1.0 - alpha) * region[m] + alpha * rgb


def draw_scatter(groups) -> np.ndarray:
    """A 2-D scatter as a uint8 RGB image ``[H, W, 3]``: white background, a
    black frame around the plot area, one marker per point. ``groups`` is a
    list of ``(points [n, 2], colors, marker, filled)`` with ``colors`` one
    ``"#RRGGBB"`` per point or a single one; the data range of all groups,
    padded by 5%, fills the plot area (y grows upwards); ``SCATTER_SHAPE``."""
    h, w = SCATTER_SHAPE
    canvas = np.full((h, w, 3), 255.0, np.float32)
    m = SCATTER_MARGIN
    canvas[m - 1, m - 1:w - m + 1] = canvas[h - m, m - 1:w - m + 1] = 0.0
    canvas[m - 1:h - m + 1, m - 1] = canvas[m - 1:h - m + 1, w - m] = 0.0
    points = [np.asarray(p, np.float64).reshape(-1, 2) for p, *_ in groups]
    every = np.concatenate(points) if points else np.zeros((0, 2))
    lo, hi = (every.min(0), every.max(0)) if len(every) else (np.zeros(2), np.ones(2))
    span = np.where(hi > lo, hi - lo, 1.0)
    lo, span = lo - 0.05 * span, 1.1 * span
    inner = np.array([w - 2 * m - 1, h - 2 * m - 1], np.float64)
    r = MARKER_RADIUS
    white = np.full(3, 255.0, np.float32)
    for pts, (_, colors, marker, filled) in zip(points, groups):
        body, edge = _stamps(marker, filled)
        cols = np.round(m + (pts[:, 0] - lo[0]) / span[0] * inner[0]).astype(int)
        rows = np.round(h - m - 1 - (pts[:, 1] - lo[1]) / span[1] * inner[1]).astype(int)
        per_point = not isinstance(colors, str)
        rgb = hex_to_rgb(colors) if not per_point else None
        for i, (y, x) in enumerate(zip(rows, cols)):
            color = hex_to_rgb(colors[i]) if per_point else rgb
            _blend(canvas, body, y - r, x - r, color, MARKER_ALPHA)
            _blend(canvas, edge, y - r, x - r, white, MARKER_ALPHA)
    return np.clip(np.round(canvas), 0, 255).astype(np.uint8)


def normalize_unit(data: np.ndarray) -> np.ndarray:
    """Min-max to [0, 1]; a constant map gives zeros."""
    lo, hi = float(data.min()), float(data.max())
    if hi <= lo:
        return np.zeros_like(data)
    return (data - lo) / (hi - lo)


def _panel(data: np.ndarray, colormap: str, side: int) -> np.ndarray:
    """One ``[side, side, 3]`` float32 panel of a 2-D map: min-max
    normalized, nearest-neighbour resized, gray or viridis."""
    unit = normalize_unit(np.asarray(data, np.float32))
    rows = (np.arange(side) * unit.shape[0]) // side
    cols = (np.arange(side) * unit.shape[1]) // side
    unit = unit[rows][:, cols]
    if colormap == "gray":
        return np.repeat(unit[..., None] * 255.0, 3, axis=-1)
    pos = unit * (len(_VIRIDIS) - 1)
    low = np.clip(np.floor(pos).astype(int), 0, len(_VIRIDIS) - 2)
    frac = (pos - low)[..., None]
    return (1.0 - frac) * _VIRIDIS[low] + frac * _VIRIDIS[low + 1]


def channel_grid_shape(n_channels: int) -> tuple[int, int]:
    """(height, width) of ``draw_channel_grid``'s image for ``n_channels``."""
    rows = 1 + -(-n_channels // GRID_COLUMNS)
    return (rows * GRID_PANEL + (rows + 1) * GRID_GAP,
            GRID_COLUMNS * GRID_PANEL + (GRID_COLUMNS + 1) * GRID_GAP)


def draw_channel_grid(original: np.ndarray, reconstruction: np.ndarray, latents: np.ndarray,
                      framed: set[int] | frozenset[int] = frozenset()) -> np.ndarray:
    """Original | reconstruction (gray) in the first row, then one viridis
    heatmap per latent channel (``latents`` ``[C, h, w]``), ``GRID_COLUMNS``
    a row, the channels in ``framed`` (the AR-regularized ones) in a red
    frame; uint8 RGB of ``channel_grid_shape(C)``."""
    canvas = np.full((*channel_grid_shape(latents.shape[0]), 3), 255.0, np.float32)
    p, g = GRID_PANEL, GRID_GAP

    def place(slot: int, image: np.ndarray, frame: bool = False) -> None:
        top, left = g + (slot // GRID_COLUMNS) * (p + g), g + (slot % GRID_COLUMNS) * (p + g)
        canvas[top:top + p, left:left + p] = image
        if frame:
            b = AR_BORDER
            red = np.array([214.0, 39.0, 40.0], np.float32)
            canvas[top:top + b, left:left + p] = canvas[top + p - b:top + p, left:left + p] = red
            canvas[top:top + p, left:left + b] = canvas[top:top + p, left + p - b:left + p] = red

    place(0, _panel(original, "gray", p))
    place(1, _panel(reconstruction, "gray", p))
    for c in range(latents.shape[0]):
        place(GRID_COLUMNS + c, _panel(latents[c], "viridis", p), c in framed)
    return np.clip(np.round(canvas), 0, 255).astype(np.uint8)


HISTOGRAM_PANEL = (400, 500)  # (height, width) of one panel: matplotlib's 15 x 4 in, 3 a row, dpi 100
HISTOGRAM_COLUMNS = 3
HISTOGRAM_BINS = 20
HISTOGRAM_MARGIN = 40
_BAR_RGB = hex_to_rgb("#ADD8E6")  # matplotlib's "lightblue"
_BAR_ALPHA = 0.7


def draw_histogram_panels(panels) -> np.ndarray:
    """Histograms, ``HISTOGRAM_COLUMNS`` a row, as a uint8 RGB image (white
    background, a black frame per panel, no text): ``panels`` is a list of
    ``(data, lines)``, ``data`` a 1-D array binned in ``HISTOGRAM_BINS`` equal
    bins over its range (``np.histogram``'s), drawn as light-blue bars with
    black edges, and ``lines`` a list of ``(x, "#RRGGBB", dashed)`` vertical
    lines; each panel's x range holds the bins and the lines, padded by 5%."""
    ph, pw = HISTOGRAM_PANEL
    rows = max(1, -(-len(panels) // HISTOGRAM_COLUMNS))
    canvas = np.full((rows * ph, HISTOGRAM_COLUMNS * pw, 3), 255.0, np.float32)
    m = HISTOGRAM_MARGIN
    for slot, (data, lines) in enumerate(panels):
        top, left = (slot // HISTOGRAM_COLUMNS) * ph, (slot % HISTOGRAM_COLUMNS) * pw
        y0, y1, x0, x1 = top + m, top + ph - m, left + m, left + pw - m
        counts, edges = np.histogram(np.asarray(data, np.float64), bins=HISTOGRAM_BINS)
        xs = np.concatenate([edges, [x for x, _, _ in lines if np.isfinite(x)]])
        lo, hi = float(xs.min()), float(xs.max())
        span = hi - lo if hi > lo else 1.0
        lo, span = lo - 0.05 * span, 1.1 * span

        def col(x):
            return int(round(x0 + (x - lo) / span * (x1 - x0 - 1)))

        top_count = max(int(counts.max()), 1)
        for n, a, b in zip(counts, edges[:-1], edges[1:]):
            if not n:
                continue
            c0, c1 = col(a), col(b)
            r0 = int(round(y1 - 1 - n / (1.05 * top_count) * (y1 - y0 - 1)))
            region = canvas[r0:y1, c0:c1 + 1]
            region[:] = (1.0 - _BAR_ALPHA) * region + _BAR_ALPHA * _BAR_RGB
            canvas[r0, c0:c1 + 1] = 0.0
            canvas[r0:y1, c0] = canvas[r0:y1, c1] = 0.0
        for x, color, dashed in lines:
            if not np.isfinite(x):
                continue
            c = col(x)
            if x0 <= c < x1:
                rows_on = np.arange(y0, y1)
                if dashed:
                    rows_on = rows_on[(rows_on - y0) % 12 < 8]
                canvas[rows_on, max(c - 1, x0):c + 1] = hex_to_rgb(color)
        canvas[y0 - 1, x0 - 1:x1 + 1] = canvas[y1, x0 - 1:x1 + 1] = 0.0
        canvas[y0 - 1:y1 + 1, x0 - 1] = canvas[y0 - 1:y1 + 1, x1] = 0.0
    return np.clip(np.round(canvas), 0, 255).astype(np.uint8)
