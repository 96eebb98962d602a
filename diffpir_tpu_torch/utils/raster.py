"""Two of Pillow's raster operations on 8-bit images, in numpy.

The motion PSF (``ops/degrade.py::motion_psf``) draws its path and blurs it
as the JAX package does with Pillow (``diffpir_tpu/ops/degrade.py:296-301``);
the port does not depend on Pillow.  This follows ``libImaging/Draw.c`` and
``libImaging/BoxBlur.c``:

* ``draw_line`` is ``ImageDraw.line(points, fill, width)``.  Each vertex is
  truncated toward zero to integers.  A width of at most 1 draws each segment
  with Bresenham's walk, which leaves out the segment's end point, then the
  polyline's last point; a wider line draws each segment as a filled
  four-sided polygon whose sides are offset by the width rounded half up and
  half down, filled by scan lines at integer rows with float32 crossings.
* ``gaussian_blur`` is ``ImageFilter.GaussianBlur(radius)``: three passes of
  an extended box blur along each axis (rows first), each on 8-bit data.
  The box radius of one pass is Gwosdek et al.'s (SSVM 2011):
  ``sigma2 = radius^2 / 3``, ``L = sqrt(12 sigma2 + 1)``,
  ``l = floor((L - 1) / 2)``, and the fractional radius
  ``l + (2l + 1)(l(l + 1) - 3 sigma2) / (6 (sigma2 - (l + 1)^2))``, in
  float32.  A pass of fractional radius ``R`` weighs the ``2 floor(R) + 1``
  inner pixels by ``ww = floor(2^24 / (2R + 1))`` and the two outer ones by
  ``fw = (2^24 - (2 floor(R) + 1) ww) / 2``, repeats edge pixels past the
  border, and rounds ``(sum + 2^23) >> 24``.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["draw_line", "gaussian_blur", "box_blur_radius"]


def _point(canvas: np.ndarray, x: int, y: int, value: int) -> None:
    if 0 <= x < canvas.shape[1] and 0 <= y < canvas.shape[0]:
        canvas[y, x] = value


def _segment(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int,
             value: int) -> None:
    """Bresenham's walk from (x0, y0), the end point left out."""
    dx, dy = x1 - x0, y1 - y0
    xs = -1 if dx < 0 else 1
    ys = -1 if dy < 0 else 1
    dx, dy = abs(dx), abs(dy)
    if dx == 0:
        for _ in range(dy):
            _point(canvas, x0, y0, value)
            y0 += ys
    elif dy == 0:
        for _ in range(dx):
            _point(canvas, x0, y0, value)
            x0 += xs
    elif dx > dy:
        e = 2 * dy - dx
        for _ in range(dx):
            _point(canvas, x0, y0, value)
            if e >= 0:
                y0 += ys
                e -= 2 * dx
            e += 2 * dy
            x0 += xs
    else:
        e = 2 * dx - dy
        for _ in range(dy):
            _point(canvas, x0, y0, value)
            if e >= 0:
                x0 += xs
                e -= 2 * dy
            e += 2 * dx
            y0 += ys


def _round_up(f: float) -> int:     # half away from zero
    return int(math.floor(f + 0.5)) if f >= 0.0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:   # half toward zero
    return int(math.ceil(f - 0.5)) if f >= 0.0 else -int(math.ceil(abs(f) - 0.5))


def _hline(canvas: np.ndarray, x0: int, y: int, x1: int, value: int) -> None:
    h, w = canvas.shape
    if 0 <= y < h:
        x0, x1 = max(x0, 0), min(x1, w - 1)
        if x0 <= x1:
            canvas[y, x0:x1 + 1] = value


def _edge(x0: int, y0: int, x1: int, y1: int) -> dict:
    dx = (np.float32(0.0) if y0 == y1
          else np.float32(np.float32(x1 - x0) / np.float32(y1 - y0)))
    return dict(xmin=min(x0, x1), xmax=max(x0, x1), ymin=min(y0, y1),
                ymax=max(y0, y1), dx=dx, x0=x0, y0=y0)


def _crossing(e: dict, y: int) -> np.float32:
    return np.float32(np.float32(y - e["y0"]) * e["dx"] + np.float32(e["x0"]))


def _polygon(canvas: np.ndarray, vertices, value: int) -> None:
    """Pillow's scan-line fill of a closed polygon (``polygon_generic``)."""
    n = len(vertices)
    edges = [_edge(*vertices[i], *vertices[(i + 1) % n]) for i in range(n)]
    h = canvas.shape[0]
    ymin = min(min(e["ymin"] for e in edges), h - 1)
    ymax = max(max(e["ymax"] for e in edges), 0)
    table = []
    for e in edges:
        if e["ymin"] == e["ymax"]:
            _hline(canvas, e["xmin"], e["ymin"], e["xmax"], value)
        else:
            table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, h)
    for y in range(ymin, ymax + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur["ymin"] <= y <= cur["ymax"]:
                continue
            xx.append(_crossing(cur, y))
            if y == cur["ymax"] and y < ymax:
                xx.append(xx[-1])
            elif (cur["dx"] != 0 and len(xx) % 2 == 1
                  and np.float32(round(float(xx[-1]))) == xx[-1]):
                # join discontiguous corners
                for k in range(i):
                    other = table[k]
                    if ((cur["dx"] > 0 and other["dx"] <= 0)
                            or (cur["dx"] < 0 and other["dx"] >= 0)):
                        continue
                    if xx[-1] == _crossing(other, y):
                        off = -1 if y == ymax else 1
                        adj = _crossing(cur, y + off)
                        adj_other = _crossing(other, y + off)
                        if y == cur["ymax"]:
                            xx[k] = (max(adj, adj_other) + 1 if cur["dx"] > 0
                                     else min(adj, adj_other) - 1)
                        else:
                            xx[k] = (min(adj, adj_other) if cur["dx"] > 0
                                     else max(adj, adj_other) + 1)
                        break
        xx.sort()
        for i in range(1, len(xx), 2):
            x_start, x_end = _round_up(float(xx[i - 1])), _round_down(float(xx[i]))
            if x_end >= x_start:
                _hline(canvas, x_start, y, x_end, value)


def _wide_segment(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int,
                  width: int, value: int) -> None:
    dx, dy = x1 - x0, y1 - y0
    if dx == 0 and dy == 0:
        _point(canvas, x0, y0, value)
        return
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    ratio_max = _round_up(small) / big
    ratio_min = _round_down(small) / big
    dxmin, dxmax = _round_down(ratio_min * dy), _round_down(ratio_max * dy)
    dymin, dymax = _round_down(ratio_min * dx), _round_down(ratio_max * dx)
    _polygon(canvas, [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
                      (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)], value)


def draw_line(canvas: np.ndarray, points, width: int = 0, value: int = 255) -> None:
    """``ImageDraw.Draw(img).line(points, fill=value, width=width)`` on a
    uint8 (H, W) ``canvas``, in place; ``points`` is a sequence of (x, y)."""
    pts = [(int(x), int(y)) for x, y in points]  # C's (int) cast
    if width <= 1:
        for (xa, ya), (xb, yb) in zip(pts[:-1], pts[1:]):
            _segment(canvas, xa, ya, xb, yb, value)
        if len(pts) > 1:
            _point(canvas, *pts[-1], value)
    else:
        for (xa, ya), (xb, yb) in zip(pts[:-1], pts[1:]):
            _wide_segment(canvas, xa, ya, xb, yb, width, value)


def box_blur_radius(radius: float, passes: int = 3) -> float:
    """The fractional box radius of one of ``passes`` passes that
    ``GaussianBlur(radius)`` runs, in float32 as Pillow computes it."""
    f = np.float32
    sigma2 = f(f(radius) * f(radius) / f(passes))
    big_l = f(math.sqrt(float(f(12.0) * sigma2 + f(1.0))))
    small_l = f(math.floor(float((big_l - f(1.0)) / f(2.0))))
    a = f((f(2) * small_l + f(1)) * (small_l * (small_l + f(1)) - f(3) * sigma2))
    a = f(a / f(f(6) * (sigma2 - (small_l + f(1)) * (small_l + f(1)))))
    return float(f(small_l + a))


def _box_pass(img: np.ndarray, radius: float) -> np.ndarray:
    """One extended box blur along axis 1 of a uint8 (H, W) image."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / np.float32(np.float32(radius) * np.float32(2)
                                                + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    w = img.shape[1]
    idx = np.clip(np.arange(-r - 1, w + r + 1), 0, w - 1)
    src = img[:, idx].astype(np.int64)           # edge pixels repeated
    csum = np.concatenate([np.zeros((img.shape[0], 1), np.int64),
                           np.cumsum(src, axis=1)], axis=1)
    x = np.arange(w)
    inner = csum[:, x + 2 * r + 2] - csum[:, x + 1]    # taps x-r .. x+r
    outer = src[:, x] + src[:, x + 2 * r + 2]          # taps x-r-1, x+r+1
    out = (inner * ww + outer * fw + (1 << 23)) >> 24
    return out.astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """``Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius))`` for
    a uint8 (H, W) image."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise TypeError(f"gaussian_blur takes a uint8 (H, W) image, got "
                        f"{img.dtype} {img.shape}")
    box = box_blur_radius(radius)
    out = img
    if box != 0.0:
        for _ in range(3):
            out = _box_pass(out, box)
        out = out.T
        for _ in range(3):
            out = _box_pass(out, box)
        out = out.T
    return np.ascontiguousarray(out)
