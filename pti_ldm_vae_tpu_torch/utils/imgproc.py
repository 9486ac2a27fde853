"""The OpenCV subset that the comparison suite and the paired augmentation
call, in numpy and scipy on the host (the card's machine has no OpenCV).

Counterpart of the ``cv2`` calls of ``pti_ldm_vae_tpu/analysis/metrics.py``
and ``pti_ldm_vae_tpu/data/augmentation.py``. Each function keeps the name
meaning and argument meaning of the OpenCV call it replaces (its docstring
names it) and follows OpenCV's published algorithm, so that the point sets,
masks and integer results are OpenCV's own and the float results agree to
rounding:

- contours: Suzuki-Abe border following of the outer borders
  (``findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``), the shoelace area,
  the filled polygon of ``drawContours(thickness=-1)``, ``boundingRect``;
- ``fitEllipse`` (``fitEllipseNoDirect`` of ``imgproc/src/shapedescr.cpp``,
  ``fitEllipseDirect`` for five points) and ``getRotationMatrix2D``;
- resampling: ``warpAffine`` (bicubic with a replicated border, bilinear with
  a reflected one) and ``remap`` (bilinear, reflected), both at unquantised
  source coordinates; ``resize(INTER_LINEAR)`` on uint8 in OpenCV's 11-bit
  fixed point; ``GaussianBlur`` on float32 (kernel size 8 sigma + 1);
- ``normalize(NORM_MINMAX)`` to uint8 and ``cvtColor(GRAY2RGB)``.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import correlate1d

__all__ = ["bounding_rect", "contour_area", "fill_contour", "find_external_contours",
           "fit_ellipse", "gaussian_blur", "get_rotation_matrix_2d", "gray2rgb",
           "normalize_minmax_u8", "remap_linear", "resize_linear_u8", "set_rng_seed",
           "warp_affine"]

# chain codes 0..7 (OpenCV's icvCodeDeltas): right, up-right, up, up-left,
# left, down-left, down, down-right, in image coordinates (y grows downward)
_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)
# marks of followed border pixels, as in OpenCV's 8-bit scanner: 2, and
# 2 | -128 where the pixel to the right was examined and is background
_MARK, _MARK_RIGHT = 2, 2 - 128


def _follow_border(flat: np.ndarray, step: int, start: int, x: int, y: int) -> list[tuple[int, int]]:
    """Follow the outer border that starts at flat index ``start`` (image
    point ``x, y``), mark its pixels and return the points where the chain
    changes direction (``CHAIN_APPROX_SIMPLE``); ``icvFetchContour``."""
    deltas = [_CODE_DX[k] + _CODE_DY[k] * step for k in range(8)] * 2
    # the first neighbour, searched clockwise from the left
    s = 4
    while True:
        s = (s - 1) & 7
        i1 = start + deltas[s]
        if flat[i1] != 0 or s == 4:
            break
    if s == 4:  # a lone pixel
        flat[start] = _MARK_RIGHT
        return [(x, y)]
    points = []
    i3, prev_s = start, s ^ 4
    while True:
        s_end = s
        i4 = i3
        while s < 15:  # counter-clockwise from the pixel we came from
            s += 1
            i4 = i3 + deltas[s]
            if flat[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:  # the right neighbour was examined and is background
            flat[i3] = _MARK_RIGHT
        elif flat[i3] == 1:
            flat[i3] = _MARK
        if s != prev_s:
            points.append((x, y))
            prev_s = s
        x += _CODE_DX[s]
        y += _CODE_DY[s]
        if i4 == start and i3 == i1:
            return points
        i3 = i4
        s = (s + 4) & 7


def find_external_contours(mask: np.ndarray) -> list[np.ndarray]:
    """``cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]``:
    the outer borders of the 8-connected foreground (nonzero) components that
    lie in no hole of another, each an int32 ``[N, 2]`` array of ``(x, y)``
    points where the border changes direction, starting at its top-left pixel
    and running counter-clockwise on screen; in OpenCV's order (the last found
    first). The image's edge counts as background."""
    m = np.asarray(mask)
    if m.ndim != 2:
        raise ValueError(f"find_external_contours takes a 2-D mask, got shape {m.shape}")
    h, w = m.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = m != 0
    flat = img.reshape(-1)
    step = w + 2
    found = []
    for y in np.flatnonzero(img.any(axis=1)):
        row = img[y]
        x, prev, lnbd = 1, 0, 0  # lnbd: the last border pixel passed in this row
        while x <= w:
            hits = np.flatnonzero(row[x:w + 1] != prev)
            if not hits.size:
                break
            x += int(hits[0])
            p = int(row[x])
            outer = prev == 0 and p == 1
            # a hole's start (p == 0 after a pixel not marked right-bound) is never followed
            # here, nor is an outer border that lies in a hole (its last border pixel is not
            # a right-bound mark)
            if outer and not row[lnbd] > 0:
                found.append(np.array(_follow_border(flat, step, y * step + x, x - 1, y - 1),
                                      np.int32))
                prev = int(row[x])
            else:
                if not outer and p == 0 and prev >= 1 and prev & -2:
                    lnbd = x - 1
                prev = p
                if prev & -2:
                    lnbd = x
            x += 1
    return found[::-1]


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea(contour)``: the absolute shoelace area of the
    polygon through the points (not the pixel count)."""
    pts = np.asarray(contour, np.float64).reshape(-1, 2)
    x, y = pts[:, 0], pts[:, 1]
    # integer points: every term and partial sum is exact, in any order
    return abs(float(np.sum(np.roll(x, 1) * y - np.roll(y, 1) * x)) * 0.5)


def _segment_pixels(x0: int, y0: int, x1: int, y1: int) -> tuple[np.ndarray, np.ndarray]:
    """The pixels of the 8-connected line from ``(x0, y0)`` to ``(x1, y1)``."""
    n = max(abs(x1 - x0), abs(y1 - y0))
    t = np.arange(n + 1)
    if n == 0:
        return np.array([x0]), np.array([y0])
    # a chain's segments are horizontal, vertical or diagonal: exact steps
    return x0 + (x1 - x0) * t // n, y0 + (y1 - y0) * t // n


def fill_contour(shape: tuple[int, int], contour: np.ndarray) -> np.ndarray:
    """``cv2.drawContours(np.zeros(shape, np.uint8), [contour], -1, color=1,
    thickness=-1)``: the polygon through the points filled (the scan-line
    spans between its edges, each edge's rows half-open) with its edges drawn
    as 8-connected lines; uint8 0/1."""
    h, w = shape
    out = np.zeros((h, w), np.uint8)
    pts = np.asarray(contour, np.int64).reshape(-1, 2)
    n = len(pts)
    if not n:
        return out
    prev = pts[-1]
    edges = []
    for cur in pts:
        xs, ys = _segment_pixels(int(prev[0]), int(prev[1]), int(cur[0]), int(cur[1]))
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        out[ys[keep], xs[keep]] = 1
        if prev[1] != cur[1]:
            (xa, ya), (xb, yb) = (prev, cur) if prev[1] < cur[1] else (cur, prev)
            edges.append((int(ya), int(yb), int(xa), (int(xb) - int(xa)) / (int(yb) - int(ya))))
        prev = cur
    if len(edges) >= 2:
        for y in range(max(min(e[0] for e in edges), 0), min(max(e[1] for e in edges), h)):
            xs = sorted(int(np.floor(x0 + (y - y0) * dx)) for y0, y1, x0, dx in edges
                        if y0 <= y < y1)
            for a, b in zip(xs[0::2], xs[1::2]):
                if a < w and b >= 0:
                    out[y, max(a, 0):min(b, w - 1) + 1] = 1
    return out


def bounding_rect(contour: np.ndarray) -> tuple[int, int, int, int]:
    """``cv2.boundingRect(contour)``: ``(x, y, width, height)`` of the
    smallest upright rectangle of pixels that holds every point."""
    pts = np.asarray(contour).reshape(-1, 2)
    x0, y0 = (int(v) for v in pts.min(axis=0))
    x1, y1 = (int(v) for v in pts.max(axis=0))
    return x0, y0, x1 - x0 + 1, y1 - y0 + 1


# -- ellipse fit --------------------------------------------------------------------
_FLT_EPSILON = float(np.finfo(np.float32).eps)
_MIN_EPS = 1e-8
# OpenCV's default random generator (``cv::theRNG()``): a multiply-with-carry state,
# 0xFFFFFFFF until seeded; the ellipse fits nudge points with it
_RNG_COEFF = 4164903690
_rng_state = [0xFFFFFFFF]


def set_rng_seed(seed: int) -> None:
    """``cv2.setRNGSeed(seed)``: the state of the generator that the ellipse
    fits draw their point nudges from (OpenCV's ``theRNG``)."""
    _rng_state[0] = int(seed) & 0xFFFFFFFFFFFFFFFF or 0xFFFFFFFF


def _rng_uniform(a: np.float32, b: np.float32) -> np.float32:
    """``RNG::uniform(float a, float b)``: one 32-bit draw scaled in float32."""
    s = _rng_state[0]
    s = ((s & 0xFFFFFFFF) * _RNG_COEFF + (s >> 32)) & 0xFFFFFFFFFFFFFFFF
    _rng_state[0] = s
    u = np.float32(s & 0xFFFFFFFF) * np.float32(2.3283064365386963e-10)
    return np.float32(np.float32(u * np.float32(b - a)) + a)


def _perturbation(n: int, eps: float) -> np.ndarray:
    """OpenCV's ``getOfs`` for points 0 .. n-1: each moved by
    ``uniform(-eps, eps)`` in x and in y from ``theRNG``, y drawn first.
    OpenCV draws even at ``eps`` 0 (the five-point fit's first try), so this
    does too: the generator's state follows OpenCV's."""
    e = np.float32(eps)
    out = np.empty((n, 2), np.float32)
    for i in range(n):
        out[i, 1] = _rng_uniform(-e, e)
        out[i, 0] = _rng_uniform(-e, e)
    return out


def _svd_solve(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Least squares by SVD back-substitution, dropping singular values at or
    below their sum times 2 DBL_EPSILON (``SVBackSubst``, ``solve(DECOMP_SVD)``);
    also returns the singular values, largest first."""
    u, w, vt = np.linalg.svd(a, full_matrices=False)
    keep = w > w.sum() * 2 * np.finfo(np.float64).eps
    return vt[keep].T @ ((u[:, keep].T @ b) / w[keep]), w


def _centre_and_scale(p: np.ndarray) -> tuple[np.ndarray, float]:
    """OpenCV's centroid (summed and divided in float32) and the points'
    summed absolute deviation from it (float32 per point, summed in float64),
    both summed point by point."""
    c = np.cumsum(p, axis=0, dtype=np.float32)[-1] / np.float32(len(p))
    s = float(np.cumsum(np.abs(p - c).sum(axis=1, dtype=np.float32), dtype=np.float64)[-1])
    return c, s


def _fit_ellipse_no_direct(p: np.ndarray) -> tuple[tuple[float, float], tuple[float, float], float]:
    """``fitEllipseNoDirect``: a least-squares conic about the centroid, the
    centre from its gradient, then the three quadratic terms refit about that
    centre. A design whose smallest singular value is below the largest's
    times FLT_EPSILON (points on a line, repeated points) is refit with every
    point nudged by ``getOfs`` (random, from ``theRNG``)."""
    n = len(p)
    c, s = _centre_and_scale(p)
    scale = 100.0 / (s if s > _FLT_EPSILON else _FLT_EPSILON)

    def design(q):
        dq = (q - c).astype(np.float64) * scale
        return dq[:, 0], dq[:, 1]

    px, py = design(p)
    b = np.full(n, 10000.0)
    gfp, w = _svd_solve(np.stack([-px * px, -py * py, -px * py, px, py], 1), b)
    if w[0] * _FLT_EPSILON > w[-1]:
        p = (p + _perturbation(n, s / (n * 2) * 1e-3)).astype(np.float32)
        px, py = design(p)
        gfp = _svd_solve(np.stack([-px * px, -py * py, -px * py, px, py], 1), b)[0]
    rp = _svd_solve(np.array([[2 * gfp[0], gfp[2]], [gfp[2], 2 * gfp[1]]]), gfp[3:5])[0]
    ex, ey = px - rp[0], py - rp[1]
    g = _svd_solve(np.stack([ex * ex, ey * ey, ex * ey], 1), np.ones(n))[0]
    if abs(g[2]) <= _MIN_EPS:
        # an axis-aligned conic: the cross term is rounding noise of either sign, and its
        # sign alone decides between 0 and 180 degrees where the axes swap; OpenCV's is +0
        g[2] = 0.0
    theta = -0.5 * np.arctan2(g[2], g[1] - g[0])
    t = g[2] / np.sin(-2.0 * theta) if abs(g[2]) > _MIN_EPS else g[1] - g[0]
    r1, r2 = abs(g[0] + g[1] - t), abs(g[0] + g[1] + t)
    r1 = np.sqrt(2.0 / r1) if r1 > _MIN_EPS else r1
    r2 = np.sqrt(2.0 / r2) if r2 > _MIN_EPS else r2
    center = (float(np.float32(np.float32(rp[0] / scale) + c[0])),
              float(np.float32(np.float32(rp[1] / scale) + c[1])))
    width, height = float(np.float32(r1 * 2 / scale)), float(np.float32(r2 * 2 / scale))
    # OpenCV sets the angle only where it swaps the axes; otherwise it stays 0
    angle = 0.0
    if width > height:
        width, height = height, width
        angle = float(np.float32(90 + theta * 180 / np.pi))
    if angle < -180:
        angle += 360
    if angle > 360:
        angle -= 360
    return center, (width, height), angle


def _direct_system(px: list[float], py: list[float]) -> tuple[np.ndarray, np.ndarray, float, float]:
    """``fitEllipseDirect``'s reduced 3x3 system as OpenCV's source writes
    it: the 6x6 scatter summed point by point and scaled by 1/n, ``TM`` and
    ``Ts`` from cofactors, then ``M`` and its determinant. For five points
    ``M`` is singular, so the determinant that OpenCV tests against 1e-10 is
    rounding noise; this order of operations meets OpenCV's branch more often
    than a library solve does, not always. Returns ``(M, TM, Ts, det M)``."""
    n = len(px)
    rows = [(x * x, x * y, y * y, x, y, 1.0) for x, y in zip(px, py)]
    d = [[0.0] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i, 6):
            acc = 0.0
            for r in rows:
                acc += r[i] * r[j]
            d[i][j] = d[j][i] = acc
    inv_n = 1.0 / n
    d = [[v * inv_n for v in row] for row in d]

    def cofactors(r):  # TM(0, r), TM(1, r), TM(2, r)
        return (d[r][5] * d[3][5] * d[4][4] - d[r][5] * d[3][4] * d[4][5] - d[r][4] * d[3][5] * d[5][4]
                + d[r][3] * d[4][5] * d[5][4] + d[r][4] * d[3][4] * d[5][5] - d[r][3] * d[4][4] * d[5][5],
                d[r][5] * d[3][3] * d[4][5] - d[r][5] * d[3][5] * d[4][3] + d[r][4] * d[3][5] * d[5][3]
                - d[r][3] * d[4][5] * d[5][3] - d[r][4] * d[3][3] * d[5][5] + d[r][3] * d[4][3] * d[5][5],
                d[r][5] * d[3][4] * d[4][3] - d[r][5] * d[3][3] * d[4][4] - d[r][4] * d[3][4] * d[5][3]
                + d[r][3] * d[4][4] * d[5][3] + d[r][4] * d[3][3] * d[5][4] - d[r][3] * d[4][3] * d[5][4])

    tm = np.array([cofactors(r) for r in range(3)]).T.tolist()
    ts = (-(d[3][5] * d[4][4] * d[5][3]) + d[3][4] * d[4][5] * d[5][3] + d[3][5] * d[4][3] * d[5][4]
          - d[3][3] * d[4][5] * d[5][4] - d[3][4] * d[4][3] * d[5][5] + d[3][3] * d[4][4] * d[5][5])
    m = [[0.0] * 3 for _ in range(3)]
    for j in range(3):
        m[0][j] = (d[2][j] + (d[2][3] * tm[0][j] + d[2][4] * tm[1][j] + d[2][5] * tm[2][j]) / ts) / 2.0
        m[1][j] = -d[1][j] - (d[1][3] * tm[0][j] + d[1][4] * tm[1][j] + d[1][5] * tm[2][j]) / ts
        m[2][j] = (d[0][j] + (d[0][3] * tm[0][j] + d[0][4] * tm[1][j] + d[0][5] * tm[2][j]) / ts) / 2.0
    det = (m[0][0] * (m[1][1] * m[2][2] - m[2][1] * m[1][2])
           - m[0][1] * (m[1][0] * m[2][2] - m[2][0] * m[1][2])
           + m[0][2] * (m[1][0] * m[2][1] - m[2][0] * m[1][1]))
    return np.array(m), np.array(tm), ts, det


def _fit_ellipse_direct(p: np.ndarray) -> tuple[tuple[float, float], tuple[float, float], float]:
    """``fitEllipseDirect`` (OpenCV calls it for exactly five points): the
    ellipse-constrained least squares (Fitzgibbon's, in Halir and Flusser's
    reduced 3x3 eigenproblem), retried once with the points nudged by
    ``getOfs`` where the reduced matrix is singular, then
    ``fitEllipseNoDirect``. Both tries draw nudges from ``theRNG`` (zero ones
    on the first)."""
    n = len(p)
    c, s = _centre_and_scale(p)
    scale = 100.0 / (s if s > _FLT_EPSILON else _FLT_EPSILON)
    eps = 0.0
    for _ in range(2):
        dq = (p + _perturbation(n, eps)).astype(np.float32) - c  # float32, as OpenCV's Point2f
        m, tm, ts, det = _direct_system((dq[:, 0].astype(np.float64) * scale).tolist(),
                                        (dq[:, 1].astype(np.float64) * scale).tolist())
        if abs(det) > 1e-10:
            break
        eps = float(np.float32(s / (n * 2) * 1e-2))
    else:
        return _fit_ellipse_no_direct(p)
    # OpenCV's eigenNonSymmetric gives unnormalised eigenvectors, which can tip the choice
    # below where two candidates are ellipses; numpy's are unit vectors
    vecs = np.real(np.linalg.eig(m)[1]).T
    cond = 4 * vecs[:, 0] * vecs[:, 2] - vecs[:, 1] ** 2
    # the eigenvector with the largest 4ac - b^2, ties to the later one
    if cond[0] < cond[1]:
        i = 2 if cond[1] < cond[2] else 1
    else:
        i = 2 if cond[0] < cond[2] else 0
    v = vecs[i]
    norm = np.sqrt((v * v).sum())
    if np.prod([-1 if e < 0 else 1 for e in v]) <= 0:
        norm = -norm
    pa, pb, pc = v / norm
    q0, q1, q2 = (tm @ np.array([pa, pb, pc])) / ts
    u1 = pc * q0 * q0 - pb * q0 * q1 + pa * q1 * q1 + pb * pb * q2
    u2 = pa * pc * q2
    l1 = np.sqrt(pb * pb + (pa - pc) ** 2)
    l2 = pa + pc
    l3 = pb * pb - 4.0 * pa * pc
    x0 = (2.0 * pc * q0 - pb * q1) / l3 / scale + float(c[0])
    y0 = (2.0 * pa * q1 - pb * q0) / l3 / scale + float(c[1])
    with np.errstate(invalid="ignore", divide="ignore"):
        ra = np.sqrt(2.0) * np.sqrt((u1 - 4.0 * u2) / ((l1 - l2) * l3)) / scale
        rb = np.sqrt(2.0) * np.sqrt(-((u1 - 4.0 * u2) / ((l1 + l2) * l3))) / scale
    if pb == 0:
        theta = 0.0 if pa < pc else np.pi / 2
    else:
        theta = np.pi / 2 + 0.5 * np.arctan2(pb, pa - pc)
    width, height = float(np.float32(2.0 * ra)), float(np.float32(2.0 * rb))
    if width > height:
        width, height = height, width
        angle = float(np.float32(np.fmod(90 + theta * 180 / np.pi, 180.0)))
    else:
        angle = float(np.float32(np.fmod(theta * 180 / np.pi, 180.0)))
    return (float(np.float32(x0)), float(np.float32(y0))), (width, height), angle


def fit_ellipse(points: np.ndarray) -> tuple[tuple[float, float], tuple[float, float], float]:
    """``cv2.fitEllipse(points)``: ``((cx, cy), (width, height), angle)`` of
    OpenCV's ``RotatedRect``, width <= height; at least five points, else
    ``ValueError`` (OpenCV raises there too)."""
    p = np.asarray(points).reshape(-1, 2).astype(np.float32)
    if len(p) < 5:
        raise ValueError("There should be at least 5 points to fit the ellipse")
    return _fit_ellipse_direct(p) if len(p) == 5 else _fit_ellipse_no_direct(p)


def get_rotation_matrix_2d(center: tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the float64 ``[2, 3]``
    matrix that rotates by ``angle`` degrees (counter-clockwise on screen)
    about ``center`` and scales by ``scale``."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = float(np.float32(center[0])), float(np.float32(center[1]))
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


# -- resampling ---------------------------------------------------------------------
def _reflect_101(i: np.ndarray, n: int) -> np.ndarray:
    """``BORDER_REFLECT_101`` indices (``gfedcb|abcdefgh|gfedcba``), repeated
    as far as needed."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def _border(border: str):
    if border == "replicate":
        return lambda i, n: np.clip(i, 0, n - 1)
    if border == "reflect101":
        return _reflect_101
    raise ValueError(f"border must be 'replicate' or 'reflect101', got {border!r}")


def _cubic_weights(t: np.ndarray) -> list[np.ndarray]:
    """OpenCV's ``interpolateCubic`` (A = -0.75) at fractional offsets
    ``t``; a zero offset gives the weights 0, 1, 0, 0 exactly."""
    a = -0.75
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    return [c0, c1, c2, 1 - c0 - c1 - c2]


def _sample(img: np.ndarray, x: np.ndarray, y: np.ndarray, interpolation: str,
            border: str) -> np.ndarray:
    """``img`` at source coordinates ``x, y`` (unquantised), bicubic or
    bilinear, weights and sums in float64, float32 output."""
    index = _border(border)
    h, w = img.shape
    src = img.astype(np.float64)
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    if interpolation == "cubic":
        wx, wy, taps = _cubic_weights(fx), _cubic_weights(fy), range(-1, 3)
    elif interpolation == "linear":
        wx, wy, taps = [1 - fx, fx], [1 - fy, fy], range(2)
    else:
        raise ValueError(f"interpolation must be 'cubic' or 'linear', got {interpolation!r}")
    cols = [index(x0 + k, w) for k in taps]
    out = np.zeros(x.shape)
    for wj, j in zip(wy, taps):
        rows = index(y0 + j, h)
        out += wj * sum(wi * src[rows, ci] for wi, ci in zip(wx, cols))
    return out.astype(np.float32)


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: tuple[int, int], *,
                interpolation: str = "linear", border: str = "reflect101") -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=INTER_CUBIC | INTER_LINEAR,
    borderMode=BORDER_REPLICATE | BORDER_REFLECT_101)`` of a 2-D float image:
    each output pixel ``(x, y)`` samples ``img`` at the inverse of ``m``
    applied to it (``dsize`` is ``(width, height)``), the coordinate rounded
    to float32 as OpenCV rounds it, so that a tap OpenCV weighs by exactly 0
    (a whole-pixel coordinate, as at 90 degrees) weighs 0 here too."""
    a = np.asarray(m, np.float64).reshape(2, 3)
    det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    i00, i01, i10, i11 = a[1, 1] * det, -a[0, 1] * det, -a[1, 0] * det, a[0, 0] * det
    i02 = -i00 * a[0, 2] - i01 * a[1, 2]
    i12 = -i10 * a[0, 2] - i11 * a[1, 2]
    w, h = dsize
    # the source coordinates as OpenCV computes them: float32, the row's term first
    inv = np.array([[i00, i01, i02], [i10, i11, i12]], np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    x = inv[0, 0] * xs + (inv[0, 1] * ys + inv[0, 2])
    y = inv[1, 0] * xs + (inv[1, 1] * ys + inv[1, 2])
    return _sample(np.asarray(img), x.astype(np.float64), y.astype(np.float64), interpolation,
                   border)


def remap_linear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, interpolation=INTER_LINEAR,
    borderMode=BORDER_REFLECT_101)`` with float maps: output pixel ``(x, y)``
    samples ``img`` at ``(map_x[y, x], map_y[y, x])``."""
    return _sample(np.asarray(img), np.asarray(map_x, np.float64), np.asarray(map_y, np.float64),
                   "linear", "reflect101")


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a float32 image: the
    separable kernel of size ``round(8 sigma + 1) | 1`` (OpenCV's size for
    float images), its float32 taps normalised in float64, reflect-101
    borders repeated as far as the kernel reaches."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x)
    kernel = (taps * (1.0 / taps.sum())).astype(np.float32).astype(np.float64)
    out = correlate1d(np.asarray(img, np.float64), kernel, axis=1, mode="mirror")
    return correlate1d(out, kernel, axis=0, mode="mirror").astype(np.float32)


def resize_linear_u8(img: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=INTER_LINEAR)`` of a uint8 image
    ([H, W] or [H, W, C]), bit for bit: OpenCV's 11-bit fixed point (half-
    pixel centres; each tap's float32 weight times 2048 rounded on its own;
    columns clamped to the edge, rows clipped; the vertical pass as its
    vector code computes it, ``((a >> 4) * b >> 16)`` per row, then
    ``(sum + 2) >> 2``), and at an exact 2x downscale the 2x2 mean of
    INTER_AREA that OpenCV takes there instead."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"resize_linear_u8 takes uint8, got {a.dtype}")
    if a.ndim == 3:
        return np.stack([resize_linear_u8(a[..., k], dsize) for k in range(a.shape[-1])], -1)
    h, w = a.shape
    dw, dh = dsize
    s = a.astype(np.int64)
    if (w, h) == (2 * dw, 2 * dh):
        quad = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((quad + 2) >> 2).astype(np.uint8)

    def taps(src: int, dst: int, clamp: bool):
        f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
        i = np.floor(f).astype(np.int64)
        f = (f - i.astype(np.float32)).astype(np.float32)
        if clamp:  # columns: an outside tap takes the edge pixel whole
            f[i < 0], i[i < 0] = 0, 0
            f[i >= src - 1], i[i >= src - 1] = 0, src - 1
        w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
        w1 = np.rint(f * np.float32(2048)).astype(np.int64)
        return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), w0, w1

    x0, x1, a0, a1 = taps(w, dw, True)
    y0, y1, b0, b1 = taps(h, dh, False)
    rows = s[:, x0] * a0 + s[:, x1] * a1
    v = (((rows[y0] >> 4) * b0[:, None]) >> 16) + (((rows[y1] >> 4) * b1[:, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


# -- intensity ----------------------------------------------------------------------
def normalize_minmax_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)``
    of a float32 image: OpenCV's float32 scale and shift, ``x * scale +
    shift`` rounded once to float32 as its fused multiply-add does (the
    product is exact in float64), then truncated to uint8."""
    x = np.asarray(img, np.float32)
    smin, smax = float(x.min()), float(x.max())
    scale = 255.0 * (1.0 / (smax - smin) if smax - smin > np.finfo(np.float64).eps else 0.0)
    scale = float(np.float32(scale))
    shift = float(np.float32(0.0) - np.float32(smin * scale))
    y = (x.astype(np.float64) * scale + shift).astype(np.float32)
    return y.astype(np.uint8)


def gray2rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)``: the one channel three times."""
    a = np.asarray(img)
    return np.repeat(a[..., None], 3, axis=-1)
