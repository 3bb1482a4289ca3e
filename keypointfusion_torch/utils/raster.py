"""Drawing primitives with cv2's pixels, without cv2.

The skeleton overlays of utils/vis.py draw filled circles and lines on
uint8 images. These functions set the pixels that OpenCV's drawing.cpp
sets for the same call, so an overlay equals cv2's bit for bit
(tests/test_torch_port_vis.py holds them to cv2 5.0):

  * `circle(img, center, radius, color)`: cv2.circle with thickness -1,
    LINE_8 and shift 0, which is drawing.cpp's `Circle` with `fill`: the
    midpoint circle's horizontal spans, clipped to the image.
  * `line(img, p0, p1, color, thickness)`: cv2.line with LINE_8 and shift
    0. Thickness 1 is drawing.cpp's `Line`: the end points clipped to the
    image by `clipLine` (double arithmetic, truncated), then the
    8-connected Bresenham walk of `LineIterator`, left to right. A larger
    thickness t is `ThickLine` between end points that cv2 5.0 first
    clips to the image grown by t on every side (found by comparing with
    OpenCV 4's code, which does not clip: the two differ only on lines
    that leave the image): the line's rectangle in 16-bit fixed point
    filled by `FillConvexPoly` (its outline drawn by `Line2`) and a
    filled circle of radius (t + 1) // 2 at each end.
  * `arrowed_line(img, p0, p1, color, thickness, tip_length)`:
    cv2.arrowedLine with LINE_8 and shift 0: the shaft `line(p0, p1)`,
    then two tip lines drawn from q to p1, q = p1 + tip_length * |p0 - p1|
    * (cos, sin)(atan2(p0 - p1) +- pi / 4), each coordinate rounded in
    double half to even (cvRound).
  * `gray_to_bgr(img)`: cv2.cvtColor(img, cv2.COLOR_GRAY2BGR).

Points are integer pixel coordinates, as the callers pass int(x) (toward
zero); they may lie outside the image. Colours follow cv2.Scalar: a
sequence of up to 4 values, its first C used for a C-channel image.
The functions draw in place and return the image.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _pixel(img: np.ndarray, color: Sequence[float]) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise TypeError(f'drawing needs a uint8 [H, W] or [H, W, C] image, '
                        f'got {img.dtype} {img.shape}')
    channels = 1 if img.ndim == 2 else img.shape[2]
    values = list(color)[:4] + [0] * (4 - len(color))
    # saturate_cast<uchar>(double): rounded half to even, clipped
    px = np.clip(np.rint(np.asarray(values[:channels], np.float64)), 0, 255)
    px = px.astype(np.uint8)
    return px if img.ndim == 3 else px[0]


def _hline(img, px, y: int, x0: int, x1: int) -> None:
    """The span x0..x1 (both included) of row y, clipped."""
    h, w = img.shape[:2]
    if 0 <= y < h:
        x0, x1 = max(x0, 0), min(x1, w - 1)
        if x0 <= x1:
            img[y, x0:x1 + 1] = px


def _circle(img, px, cx: int, cy: int, radius: int) -> None:
    """drawing.cpp `Circle` with fill: two pairs of spans per step of the
    midpoint walk."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                        (cy + dx, dy)):
            _hline(img, px, y, cx - half, cx + half)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1            # 0 or -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def circle(img: np.ndarray, center: Tuple[int, int], radius: int,
           color: Sequence[float], thickness: int = -1) -> np.ndarray:
    """cv2.circle(img, center, radius, color, -1): a filled circle."""
    if thickness >= 0:
        raise NotImplementedError('only filled circles (thickness -1)')
    if radius < 0:
        raise ValueError('radius must be >= 0')
    _circle(img, _pixel(img, color), int(center[0]), int(center[1]),
            int(radius))
    return img


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """drawing.cpp `clipLine` on an image of width x height: the end points
    moved onto the border, or None when the line misses the image."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return None

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line(img, px, x1: int, y1: int, x2: int, y2: int) -> None:
    """drawing.cpp `Line` with LINE_8: LineIterator(leftToRight=true)."""
    h, w = img.shape[:2]
    clipped = _clip_line(w, h, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:                       # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    # the major axis steps every pixel, the minor one where err < 0
    major = (0, sy) if vert else (1, 0)
    minor = (1, 0) if vert else (0, sy)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = px
        if err < 0:
            err += minus + plus
            x, y = x + major[0] + minor[0], y + major[1] + minor[1]
        else:
            err += minus
            x, y = x + major[0], y + major[1]


def _trunc_div(a: int, b: int) -> int:
    """C's integer division, toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _put(img, px, x: int, y: int) -> None:
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = px


def _line2(img, px, p1, p2) -> None:
    """drawing.cpp `Line2`: a line between 16-bit fixed-point points."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _trunc_div(dy << XY_SHIFT, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        dx = (dx ^ i) - i
        if i:
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _trunc_div(dx << XY_SHIFT, ay | 1), XY_ONE
        count = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    x1, y1 = x1 + half, y1 + half
    _put(img, px, (x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            _put(img, px, x1, y1 >> XY_SHIFT)
            x1, y1 = x1 + 1, y1 + y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            _put(img, px, x1 >> XY_SHIFT, y1)
            x1, y1 = x1 + x_step, y1 + 1


def _fill_convex_poly(img, px, v) -> None:
    """drawing.cpp `FillConvexPoly` with LINE_8 on 16-bit fixed-point
    vertices: the outline by `Line2`, then a span per row between the two
    edges walked down from the top vertex."""
    h, w = img.shape[:2]
    half = XY_ONE >> 1
    n = len(v)
    p0 = v[-1]
    for p in v:
        _line2(img, px, p0, p)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + half) >> XY_SHIFT, (max(xs) + half) >> XY_SHIFT
    ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-XY_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y < e['ye']:
                continue
            idx0 = e['idx']
            idx = (idx0 + e['di']) % n
            while True:                  # for (; edges-- > 0; )
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + half) >> XY_SHIFT
                if ty > y:
                    xs0, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, x=xs0, idx=idx, dx=_trunc_div(
                        (xe - xs0) * 2 + (ty - y), 2 * (ty - y)))
                    break
                idx0, idx = idx, (idx + e['di']) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted(edge, key=lambda e: e['x'])
            x1 = (left['x'] + half) >> XY_SHIFT
            x2 = (right['x'] + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = px
        for e in edge:
            e['x'] += e['dx']
        y += 1
        if y > ymax:
            break


def _thick_line(img, px, p0, p1, thickness: int) -> None:
    """drawing.cpp `ThickLine` with LINE_8 and both ends capped, between
    end points cv2 5.0 first clips to the image grown by `thickness` on
    every side."""
    h, w = img.shape[:2]
    t = thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t, p0[0] + t, p0[1] + t,
                         p1[0] + t, p1[1] + t)
    if clipped is None:
        return
    x0, y0, x1, y1 = (c - t for c in clipped)
    q0, q1 = (x0 << XY_SHIFT, y0 << XY_SHIFT), (x1 << XY_SHIFT, y1 << XY_SHIFT)
    dx = (q0[0] - q1[0]) / XY_ONE
    dy = (q1[1] - q0[1]) / XY_ONE
    r = dx * dx + dy * dy
    fixed = t << (XY_SHIFT - 1)
    if r > np.finfo(np.float64).eps:
        r = (fixed + (t & 1) * XY_ONE * 0.5) / np.sqrt(r)
        # cvRound: half to even, as Python's round
        ex, ey = int(round(dy * r)), int(round(dx * r))
        _fill_convex_poly(img, px, [(q0[0] + ex, q0[1] + ey),
                                    (q0[0] - ex, q0[1] - ey),
                                    (q1[0] - ex, q1[1] - ey),
                                    (q1[0] + ex, q1[1] + ey)])
    radius = (fixed + (XY_ONE >> 1)) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        _circle(img, px, x, y, radius)


def line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
         color: Sequence[float], thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p0, p1, color, thickness) with LINE_8."""
    if thickness < 1:
        raise ValueError('thickness must be >= 1')
    px = _pixel(img, color)
    p0, p1 = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if thickness == 1:
        _line(img, px, *p0, *p1)
    else:
        _thick_line(img, px, p0, p1, int(thickness))
    return img


def arrowed_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
                 color: Sequence[float], thickness: int = 1,
                 tip_length: float = 0.3) -> np.ndarray:
    """cv2.arrowedLine(img, p0, p1, color, thickness, tipLength=
    tip_length): an arrow from p0 to its tip p1."""
    p0, p1 = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    dx, dy = p0[0] - p1[0], p0[1] - p1[1]
    tip = math.sqrt(float(dx * dx + dy * dy)) * tip_length
    line(img, p0, p1, color, thickness)
    angle = math.atan2(float(dy), float(dx))
    for side in (math.pi / 4, -math.pi / 4):
        # round(): half to even, as cvRound
        q = (round(p1[0] + tip * math.cos(angle + side)),
             round(p1[1] + tip * math.sin(angle + side)))
        line(img, q, p1, color, thickness)
    return img


def gray_to_bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_GRAY2BGR): [H, W] (or [H, W, 1]) ->
    [H, W, 3], the grey value in every channel."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim != 2:
        raise ValueError(f'a grey image is [H, W], got {img.shape}')
    return np.repeat(img[..., None], 3, axis=2)
