"""The native eval core of the data path (port of
keypointfusion_tpu/native/__init__.py).

csrc/host/preprocess.cc fuses an eval sample's depth chain into two C++
passes: `crop_normalize` (the cube's bounds, the nearest-resize
letterbox crop, the z-threshold and the [-1, 1] normalization, with the
crop matrix M) and `depth_to_pcl` (the valid crop pixels back-projected
to normalized camera xyz). It is built with g++ at first use into
keypointfusion_torch/_build/ (kernels/build.py:HostLibrary) and bound with
ctypes, which releases the interpreter lock during each call, so the
loader's threads run it side by side. Without g++ it raises; the JAX
package falls back to its numpy route there, and the port takes the
numpy route only when the caller asks for it
(data/datasets.py:build_rgbd_sample(use_native=False)). The results are
the JAX core's bit for bit; they are not the numpy route's, which rounds
in another order (4.2e-7 in normalized units).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from keypointfusion_torch.kernels.build import HostLibrary

_F32P = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
CORE = HostLibrary('preprocess.cc', {
    'crop_normalize': [_F32P, ctypes.c_int, ctypes.c_int, _F32P, _F32P,
                       _F32P, ctypes.c_int, _F32P, _F32P],
    'depth_to_pcl': [_F32P, ctypes.c_int, _F32P, _F32P, _F32P, _F32P,
                     ctypes.c_float, _F32P],
})
# crop_normalize's return codes
_CROP_ERRORS = {1: 'the crop centre has zero depth',
                2: 'the cube projects to an empty box'}


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def crop_normalize(depth: np.ndarray, center_uvd, cube, cam,
                   img_size: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """Fused crop, z-threshold and normalization of depth [H, W] (mm)
    around center_uvd (u, v, z mm) for cube (mm) and cam (fx, fy, fu,
    fv). Returns (crop [S, S] in [-1, 1], M [3, 3]); raises ValueError
    where the core refuses the input."""
    depth = _f32(depth)
    if depth.ndim != 2:
        raise ValueError(f'depth must be [H, W], got {depth.shape}')
    center, cube, cam = _f32(center_uvd), _f32(cube), _f32(cam)
    if center.shape != (3,) or cube.shape != (3,) or cam.shape != (4,):
        raise ValueError(f'center_uvd, cube and cam must hold 3, 3 and 4 '
                         f'values, got {center.shape} {cube.shape} '
                         f'{cam.shape}')
    out = np.empty((img_size, img_size), np.float32)
    M = np.empty((3, 3), np.float32)
    rc = CORE.function('crop_normalize')(
        depth, depth.shape[0], depth.shape[1], center, cube, cam, img_size,
        out, M)
    if rc != 0:
        raise ValueError(f'crop_normalize: '
                         f'{_CROP_ERRORS.get(rc, "failed")} (code {rc})')
    return out, M


def depth_to_pcl(crop_nl: np.ndarray, M, cam, com3d, cube,
                 flip: float = 1.0) -> np.ndarray:
    """The valid pixels of a normalized crop [S, S] (not the background
    1.0, not zero depth) as normalized camera xyz [N, 3], in row-major
    pixel order; raises ValueError for a singular M."""
    crop_nl = _f32(crop_nl)
    s = crop_nl.shape[0]
    if crop_nl.shape != (s, s):
        raise ValueError(f'crop_nl must be square, got {crop_nl.shape}')
    M, cam, com3d, cube = _f32(M), _f32(cam), _f32(com3d), _f32(cube)
    if M.shape != (3, 3) or cam.shape != (4,) or com3d.shape != (3,) \
            or cube.shape != (3,):
        raise ValueError('M, cam, com3d and cube must be [3, 3], [4], [3] '
                         'and [3]')
    out = np.empty((s * s, 3), np.float32)
    n = CORE.function('depth_to_pcl')(crop_nl, s, M, cam, com3d, cube,
                                      float(flip), out)
    if n < 0:
        raise ValueError('depth_to_pcl: the crop matrix has zero scale')
    return out[:n].copy()
