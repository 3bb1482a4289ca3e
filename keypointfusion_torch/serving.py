"""Batched streaming RGB-D inference engine (port of
keypointfusion_tpu/serving.py:StreamingEngine).

Full frames stream in (uint16 depth in mm, uint8 RGB), preprocessing (in
float32) and the KPFusion forward (bfloat16 by default, as the JAX
engine's) run on the device, and one packed [B, 2*3J+9] float32 array per
batch comes back: world-mm joints | normalized uvd joints |
crop matrix M. On the card, host arrays are staged in pinned memory and
copied with non_blocking copies, everything runs in order on the current
stream, and `process_stream` keeps a few batches in flight so the host
prepares batch k+1 while the card runs batch k.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from keypointfusion_torch.config import Config
from keypointfusion_torch.data.device_preprocess import device_preprocess
from keypointfusion_torch.geometry.camera import xyz_nl_to_uvd_nl
from keypointfusion_torch.models.kpfusion import build_kpfusion
from keypointfusion_torch.utils.device import resolve_device


class StreamingEngine:
    """Fixed-batch streaming inference: full frames in, joints out."""

    def __init__(self, cfg: Config = Config(),
                 state_dict: Optional[dict] = None, batch_size: int = 64,
                 img_hw=(480, 640), dtype: torch.dtype = torch.bfloat16,
                 use_kernels: bool = True, device=None, seed: int = 0):
        """state_dict: the port's KPFusion weights (None draws them from
        `seed`). dtype is the model's compute dtype: bfloat16 runs the
        serving modes of the kernels, float32 their exact modes.
        use_kernels sends the model through the CUDA kernels (see
        models/kpfusion.py). Runs on the CUDA card unless `device` names
        another; without a card and without device='cpu' it raises."""
        self.cfg = cfg
        self.batch_size = batch_size
        self.img_hw = tuple(img_hw)
        self.device = resolve_device(device)
        self.model = build_kpfusion(cfg, self.device, seed, use_kernels,
                                    dtype)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self._joint_num = cfg.joint_num
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(cfg.seed)

    @torch.inference_mode()
    def pipeline(self, depth_full, rgb_full, centers, cube, cam,
                 uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One batch on the engine's device: depth_full [B,H,W] and
        rgb_full [B,H,W,3] (any real dtype), centers [B,3] (u, v, z_mm),
        cube [B,3], cam [B,4] -> packed [B, 2*3J+9] float32. The point
        draws are the engine's generator's, or `uniform` [B,N]."""
        rgb, depth, pcl, frame = device_preprocess(
            depth_full.float(), rgb_full.float(), centers.float(),
            cube.float(), cam.float(), self.cfg.input_size,
            self.cfg.point_num, generator=self._generator, uniform=uniform)
        results, _ = self.model(rgb, depth, pcl, frame,
                                self.cfg.feature_para[0])
        joint_xyz = results[-1]
        joint_uvd = xyz_nl_to_uvd_nl(joint_xyz, frame)
        world = joint_xyz * frame.cube[:, None] / 2.0 + frame.center[:, None]
        b = world.shape[0]
        return torch.cat([world.reshape(b, -1).float(),
                          joint_uvd.reshape(b, -1).float(),
                          frame.M.reshape(b, -1)], dim=-1)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != 'cuda':
            return t.to(self.device)
        # PyTorch's pinned-memory cache reuses a staging block only once
        # the copy that read it has finished
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        return pinned.to(self.device, non_blocking=True)

    def submit(self, depth_full: np.ndarray, rgb_full: np.ndarray,
               centers: np.ndarray, cube: np.ndarray,
               cam: np.ndarray) -> torch.Tensor:
        """Enqueue one batch; returns the packed [B, 2*3J+9] device tensor
        (on the card, ready once the current stream reaches it)."""
        expected = (self.batch_size,) + self.img_hw
        if depth_full.shape != expected or depth_full.dtype != np.uint16:
            raise ValueError(f'depth must be uint16 {expected}, got '
                             f'{depth_full.dtype} {depth_full.shape}')
        if rgb_full.shape != expected + (3,) or rgb_full.dtype != np.uint8:
            raise ValueError(f'rgb must be uint8 {expected + (3,)}, got '
                             f'{rgb_full.dtype} {rgb_full.shape}')
        # uint16 travels as its int16 bit pattern (every PyTorch version
        # copies int16) and is widened on the device
        depth = self._to_device(depth_full.view(np.int16)).int() & 0xFFFF
        return self.pipeline(depth, self._to_device(rgb_full),
                             self._to_device(centers.astype(np.float32)),
                             self._to_device(cube.astype(np.float32)),
                             self._to_device(cam.astype(np.float32)))

    def _unpack(self, packed: np.ndarray) -> Dict[str, np.ndarray]:
        j = self._joint_num
        b = packed.shape[0]
        return {'joint_xyz_mm': packed[:, :3 * j].reshape(b, j, 3),
                'joint_uvd': packed[:, 3 * j:6 * j].reshape(b, j, 3),
                'M': packed[:, 6 * j:].reshape(b, 3, 3)}

    def _fetch_async(self, packed: torch.Tensor):
        if self.device.type != 'cuda':
            return packed.numpy(), None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host.numpy(), done

    def process_stream(self, batches: Iterator[Dict[str, np.ndarray]],
                       depth: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """Keeps up to `depth` batches in flight; yields each batch's
        unpacked joints in submission order."""
        pending = collections.deque()
        for batch in batches:
            if len(pending) == depth:
                yield self._wait(*pending.popleft())
            pending.append(self._fetch_async(self.submit(
                batch['depth'], batch['rgb'], batch['centers'],
                batch['cube'], batch['cam'])))
        while pending:
            yield self._wait(*pending.popleft())

    def _wait(self, host: np.ndarray, done) -> Dict[str, np.ndarray]:
        if done is not None:
            done.synchronize()
        return self._unpack(host.copy())
