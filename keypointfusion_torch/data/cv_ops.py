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

The debug renderers of utils/vis.py add four more:

  * resize_linear(src, (w, h)) is cv2.resize with its default
    INTER_LINEAR on a float32 map of at least 2 x 2: each destination
    coordinate (d + 0.5) * (w_src / w) - 0.5 in double (not
    1 / (w / w_src): the two differ where it is an integer), its
    fraction cast to float32, then a horizontal and a vertical lerp in
    float32, fma(f, p1 - p0, p0) each (the taps past an edge clamped to
    it, which makes the lerp exact). cv2 5.0 takes another path for a
    source of one row or one column, which raises here.
  * add_weighted(a, alpha, b, beta, gamma) is cv2.addWeighted on uint8:
    fma(a, alpha, fma(b, beta, gamma)) in float32, then saturated.
  * apply_colormap_jet(u8) is cv2.applyColorMap(u8, cv2.COLORMAP_JET):
    cv2 5.0's 256-entry BGR table.
  * to_u8_saturate(x) is convertTo(CV_8U), which cv2.imwrite applies to
    an image of any other depth than 8 or 16 bits (float32 among them):
    rounded half to even, saturated, and 0 where the rounded value does
    not fit an int32 (NaN and the infinities too).

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


def resize_linear(src: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(src, dsize) (INTER_LINEAR) of a float32 [H, W] map,
    H and W at least 2."""
    src = np.asarray(src)
    if src.dtype != np.float32 or src.ndim != 2 or min(src.shape) < 2:
        raise ValueError(f'resize_linear takes a float32 [H, W] map of at '
                         f'least 2 x 2, got {src.dtype} {src.shape}')
    w, h = int(dsize[0]), int(dsize[1])
    sh, sw = src.shape

    def taps(dn: int, sn: int):
        x = (np.arange(dn) + 0.5) * (sn / dn) - 0.5
        i = np.floor(x)
        return (np.clip(i, 0, sn - 1).astype(np.int64),
                np.clip(i + 1, 0, sn - 1).astype(np.int64),
                (x - i).astype(np.float32))

    x0, x1, fx = taps(w, sw)
    y0, y1, fy = taps(h, sh)
    rows = _lerp(fx[None, :], src[:, x0], src[:, x1])
    return _lerp(fy[:, None], rows[y0], rows[y1])


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float) -> np.ndarray:
    """cv2.addWeighted(a, alpha, b, beta, gamma) of two uint8 images of
    one shape."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != np.uint8 or b.dtype != np.uint8 or a.shape != b.shape:
        raise ValueError(f'add_weighted takes two uint8 images of one '
                         f'shape, got {a.dtype} {a.shape}, {b.dtype} '
                         f'{b.shape}')
    v = _fma32(a, np.float32(alpha), _fma32(b, np.float32(beta),
                                             np.float32(gamma)))
    return to_u8_saturate(v)


# cv2.applyColorMap(arange(256), COLORMAP_JET) of cv2 5.0, BGR
_JET_BGR = np.frombuffer(bytes.fromhex(
    '8000008400008800008c00009000009400009800009c0000a00000a40000a800'
    '00ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d4'
    '0000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc0000'
    'ff0000ff0400ff0800ff0c00ff1000ff1400ff1800ff1c00ff2000ff2400ff28'
    '00ff2c00ff3000ff3400ff3800ff3c00ff4000ff4400ff4800ff4c00ff5000ff'
    '5400ff5800ff5c00ff6000ff6400ff6800ff6c00ff7000ff7400ff7800ff7c00'
    'ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00ffa000ffa400ffa8'
    '00ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00ffd000ff'
    'd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00'
    'feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff'
    '2ad2ff2eceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aa'
    'ff56a6ff5aa2ff5e9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e'
    '7eff827aff8676ff8a72ff8e6eff926aff9666ff9a62ff9e5effa25affa656ff'
    'aa52ffae4effb24affb646ffba42ffbe3effc23affc636ffca32ffce2effd22a'
    'ffd626ffda22ffde1effe21affe616ffea12ffee0efff20afff606fffa01fffe'
    '00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff00dcff00d8ff00d4'
    'ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff00acff00'
    'a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff'
    '007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054'
    'ff0050ff004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff00'
    '28ff0024ff0020ff001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff'
    '0000fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000'
    'd40000d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac00'
    '00a80000a40000a000009c00009800009400009000008c000088000084000080'),
    np.uint8).reshape(256, 3)


def apply_colormap_jet(img: np.ndarray) -> np.ndarray:
    """cv2.applyColorMap(img, cv2.COLORMAP_JET) of a uint8 [H, W] (or
    [H, W, 1]) image: [H, W, 3] BGR."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f'apply_colormap_jet takes a uint8 [H, W] image, '
                         f'got {img.dtype} {img.shape}')
    return _JET_BGR[img]


def to_u8_saturate(x) -> np.ndarray:
    """Mat.convertTo(CV_8U): what cv2.imwrite makes of an image of a
    depth PNG does not take (float32 among them)."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.integer):
        return np.clip(x, 0, 255).astype(np.uint8)
    r = np.rint(x.astype(np.float64))
    # cvRound gives INT_MIN where the value does not fit (NaN too)
    with np.errstate(invalid='ignore'):
        r = np.where((r >= -2.0 ** 31) & (r < 2.0 ** 31), r, 0.0)
    return np.clip(r, 0, 255).astype(np.uint8)
