"""numpy versions of the cv2 calls of the host preprocessing, with the
roundings of cv2 5.0 (OpenCV's resize, warpAffine, warpPerspective,
invert, getRotationMatrix2D, Rodrigues, getAffineTransform, flip and
copyMakeBorder), worked out against cv2 on the same inputs, so that a
crop or a warp holds cv2's pixels:

  * resize(src, (w, h)) is cv2.resize(..., interpolation=INTER_NEAREST):
    source index min(floor(x * (1 / fx)), w_src - 1), fx = w / w_src, in
    double (not x * w_src / w: the two differ at exact integers).
  * warp_affine(src, M, (w, h), border_value) is cv2.warpAffine with
    INTER_NEAREST and BORDER_CONSTANT: M inverted in double as
    invertAffineTransform does, cast to float32, and each destination
    pixel's source coordinate computed in float32 as cv2's vector code
    does it (one fused multiply-add per coordinate, the row's term rounded
    before it; 16 columns a step, the columns after the last full step in
    its scalar order), then rounded half to even.
  * warp_perspective(src, M, (w, h), border_value) is cv2.warpPerspective
    with INTER_NEAREST and BORDER_CONSTANT: M inverted by its adjugate
    over det3 in double (cv::invert's 3x3 case), cast to float32, X, Y and
    W as above, X / W and Y / W in float32, rounded half to even.
  * get_rotation_matrix_2d and rodrigues are cv2.getRotationMatrix2D and
    cv2.Rodrigues, in the same order of double operations.
  * get_affine_transform(src, dst) is cv2.getAffineTransform: the 6x6
    system solved in double by cv::solve's LU (partial pivoting, the
    back substitution dividing by the pivot), bit for bit.
  * flip(img, 1) and copy_make_border(img, top, bottom, left, right,
    value) are cv2.flip about the vertical axis and cv2.copyMakeBorder
    with BORDER_CONSTANT: value[c] fills channel c, and a 2-D image
    takes value[0].

Pixels that map outside the source take the border value. The source
may have channels ([H, W, C]); a 2-D source stays 2-D.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

def resize(src: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(src, dsize, interpolation=cv2.INTER_NEAREST)."""
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = src.shape[:2]
    ifx = 1.0 / (w / sw)
    ify = 1.0 / (h / sh)
    xs = np.minimum(np.floor(np.arange(w) * ifx).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * ify).astype(np.int64), sh - 1)
    return src[ys[:, None], xs[None, :]]


def _gather(src, sx, sy, border_value):
    """dst[i, j] = src[sy, sx] where that lies in src, else the border:
    a number is cv2's Scalar(v), v in the first channel and 0 in the
    others."""
    sh, sw = src.shape[:2]
    inside = (sx >= 0) & (sx < sw) & (sy >= 0) & (sy < sh)
    out = src[np.where(inside, sy, 0), np.where(inside, sx, 0)]
    if src.ndim == 3:
        border = np.zeros(src.shape[2], src.dtype)
        border[0] = border_value
        out[~inside] = border
    else:
        out[~inside] = border_value
    return out


def _fma32(a, b, c) -> np.ndarray:
    """float32 fma(a, b, c), rounded once, in float64 arithmetic: the
    product of two float32 is exact in float64, TwoSum gives the sum's
    rounding error, and that error decides the rounding to float32 where
    the float64 sum falls halfway between two float32."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    f = s.astype(np.float32)
    f64 = f.astype(np.float64)
    other = np.nextafter(f, np.where(s > f64, np.float32(np.inf),
                                     np.float32(-np.inf)))
    o64 = other.astype(np.float64)
    halfway = (s != f64) & (s == (f64 + o64) / 2)
    toward_other = (err != 0) & (np.sign(err) == np.sign(o64 - f64))
    return np.where(halfway & toward_other, other, f)


# cv2's warps step 16 destination columns at a time (two vectors of 8
# float lanes); the columns past the last full step take its scalar code,
# whose rounding differs
_VECTOR_STEP = 16


def _source_coordinate(m0, m1, m2, w: int, h: int) -> np.ndarray:
    """m0 * x + m1 * y + m2 for every destination pixel [h, w], in
    float32 with cv2's roundings: fma(m0, x, (m1 * y + m2)) in the vector
    columns, fma(x, m0, m1 * y) + m2 in the tail."""
    m0, m1, m2 = (np.float32(v) for v in (m0, m1, m2))
    split = w // _VECTOR_STEP * _VECTOR_STEP
    x = np.arange(w, dtype=np.float32)[None, :]
    y = np.arange(h, dtype=np.float32)[:, None]
    head = _fma32(m0, x[:, :split], y * m1 + m2)
    tail = _fma32(x[:, split:], m0, y * m1) + m2
    return np.concatenate([head, tail], axis=1)


def _round(v: np.ndarray) -> np.ndarray:
    """cvRound of float32 coordinates: half to even."""
    return np.rint(v).astype(np.int64)


def invert_affine(M) -> np.ndarray:
    """cv2.invertAffineTransform(M), in its order of double operations."""
    m = [float(v) for v in np.asarray(M, np.float64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0] = a11
    m[1] *= -d
    m[3] *= -d
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m).reshape(2, 3)


def warp_affine(src: np.ndarray, M, dsize: Tuple[int, int],
                border_value: float = 0.0,
                interpolation: str = 'nearest') -> np.ndarray:
    """cv2.warpAffine(src, M, dsize, flags=cv2.INTER_NEAREST or
    cv2.INTER_LINEAR (interpolation 'nearest' or 'linear'),
    borderMode=cv2.BORDER_CONSTANT, borderValue=border_value)."""
    w, h = int(dsize[0]), int(dsize[1])
    m = invert_affine(M).astype(np.float32).reshape(6)
    sx = _source_coordinate(m[0], m[1], m[2], w, h)
    sy = _source_coordinate(m[3], m[4], m[5], w, h)
    if interpolation == 'linear':
        return _warp_linear(src, sx, sy, border_value)
    if interpolation != 'nearest':
        raise ValueError(f'interpolation {interpolation!r}')
    return _gather(src, _round(sx), _round(sy), border_value)


def invert_3x3(M) -> np.ndarray:
    """cv::invert(M, DECOMP_LU) for a 3x3 double matrix: the adjugate
    over det3; a singular matrix gives zeros."""
    s = [[float(v) for v in row] for row in np.asarray(M, np.float64)]
    d = (s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1])
         - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0])
         + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0]))
    if d == 0.0:
        return np.zeros((3, 3))
    d = 1.0 / d
    t = [(s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d,
         (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
         (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d,
         (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
         (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d,
         (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
         (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d,
         (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
         (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d]
    return np.array(t).reshape(3, 3)


def warp_perspective(src: np.ndarray, M, dsize: Tuple[int, int],
                     border_value: float = 0.0) -> np.ndarray:
    """cv2.warpPerspective(src, M, dsize, flags=cv2.INTER_NEAREST,
    borderMode=cv2.BORDER_CONSTANT, borderValue=border_value)."""
    w, h = int(dsize[0]), int(dsize[1])
    m = invert_3x3(M).astype(np.float32).reshape(9)
    X = _source_coordinate(m[0], m[1], m[2], w, h)
    Y = _source_coordinate(m[3], m[4], m[5], w, h)
    W = _source_coordinate(m[6], m[7], m[8], w, h)
    with np.errstate(divide='ignore', invalid='ignore'):
        sx, sy = X / W, Y / W
    bad = ~(np.isfinite(sx) & np.isfinite(sy))
    sx, sy = np.where(bad, -1, sx), np.where(bad, -1, sy)
    return _gather(src, _round(sx), _round(sy), border_value)


def get_rotation_matrix_2d(center: Sequence[float], angle: float,
                           scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale); the centre is a
    float32 point in cv2."""
    cx, cy = (float(np.float32(c)) for c in center)
    angle = float(angle) * (math.pi / 180)
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def rodrigues(rvec) -> np.ndarray:
    """cv2.Rodrigues(rvec)[0]: the rotation matrix of a rotation vector."""
    rx, ry, rz = (float(v) for v in np.asarray(rvec, np.float64).reshape(3))
    theta = math.sqrt(rx * rx + ry * ry + rz * rz)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    c1 = 1.0 - c
    itheta = 1.0 / theta
    rx, ry, rz = rx * itheta, ry * itheta, rz * itheta
    rrt = [rx * rx, rx * ry, rx * rz, rx * ry, ry * ry, ry * rz,
           rx * rz, ry * rz, rz * rz]
    r_x = [0.0, -rz, ry, rz, 0.0, -rx, -ry, rx, 0.0]
    eye = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    return np.array([c * e + c1 * a + s * b
                     for e, a, b in zip(eye, rrt, r_x)]).reshape(3, 3)


def _lerp(a, p0, p1) -> np.ndarray:
    """fma(a, p1 - p0, p0) in float32."""
    return _fma32(a, (p1 - p0).astype(np.float32), p0)


def _warp_linear(src, sx, sy, border_value):
    """INTER_LINEAR taps and lerp of src at float32 coordinates."""
    sh, sw = src.shape[:2]
    # far outside, every tap is border; clamp before the int conversion
    sx = np.clip(sx, -2.0 ** 30, 2.0 ** 30)
    sy = np.clip(sy, -2.0 ** 30, 2.0 ** 30)
    fx, fy = np.floor(sx), np.floor(sy)
    a = (sx - fx).astype(np.float32)
    b = (sy - fy).astype(np.float32)
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    if src.ndim == 3:
        a, b = a[..., None], b[..., None]
        border = np.zeros(src.shape[2], np.float32)
        border[0] = border_value
    else:
        border = np.float32(border_value)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh)
        v = src[np.clip(yy, 0, sh - 1), np.clip(xx, 0, sw - 1)]
        if src.ndim == 3:
            inside = inside[..., None]
        return np.where(inside, v.astype(np.float32), border)

    v0 = _lerp(a, tap(y0, x0), tap(y0, x0 + 1))
    v1 = _lerp(a, tap(y0 + 1, x0), tap(y0 + 1, x0 + 1))
    v = _lerp(b, v0, v1)
    if np.issubdtype(src.dtype, np.integer):
        info = np.iinfo(src.dtype)
        return np.clip(np.rint(v), info.min, info.max).astype(src.dtype)
    return v.astype(src.dtype)


def get_affine_transform(src, dst) -> np.ndarray:
    """cv2.getAffineTransform(src, dst) for three float32 points each:
    the 2x3 double matrix, from cv::solve's LU in its order of double
    operations."""
    src = np.asarray(src, np.float32).astype(np.float64).reshape(3, 2)
    dst = np.asarray(dst, np.float32).astype(np.float64).reshape(3, 2)
    a = [[0.0] * 6 for _ in range(6)]
    b = [0.0] * 6
    for i in range(3):
        x, y = float(src[i, 0]), float(src[i, 1])
        a[2 * i][0:3] = [x, y, 1.0]
        a[2 * i + 1][3:6] = [x, y, 1.0]
        b[2 * i], b[2 * i + 1] = float(dst[i, 0]), float(dst[i, 1])
    m = 6
    for i in range(m):
        k = max(range(i, m), key=lambda j: (abs(a[j][i]), -j))
        if abs(a[k][i]) < np.finfo(np.float64).eps * 100:
            return np.zeros((2, 3))       # singular: cv::solve gives 0
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for c in range(i + 1, m):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.array(b).reshape(2, 3)


def flip(img: np.ndarray, flip_code: int = 1) -> np.ndarray:
    """cv2.flip(img, 1): mirrored about the vertical axis, a new array."""
    if flip_code != 1:
        raise NotImplementedError('only flip_code 1 (left-right) is used')
    return np.ascontiguousarray(img[:, ::-1])


def copy_make_border(img: np.ndarray, top: int, bottom: int, left: int,
                     right: int, value: Sequence[float]) -> np.ndarray:
    """cv2.copyMakeBorder(img, top, bottom, left, right,
    cv2.BORDER_CONSTANT, value=list(value)): channel c of the border is
    value[c] saturated to img's dtype; a 2-D image takes value[0]."""
    value = list(value) + [0.0] * 4
    h, w = img.shape[:2]
    out = np.empty((h + top + bottom, w + left + right) + img.shape[2:],
                   img.dtype)
    fill = np.asarray(value[:img.shape[2] if img.ndim == 3 else 1],
                      np.float64)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        fill = np.clip(np.rint(fill), info.min, info.max)
    out[...] = fill.astype(img.dtype) if img.ndim == 3 else \
        fill[0].astype(img.dtype)
    out[top:top + h, left:left + w] = img
    return out
