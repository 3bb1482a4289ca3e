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

`devices` is the JAX engine's `mesh=`: one replica of the model per
listed device (a device may be listed more than once), each answering its
contiguous slice of every batch on a CUDA stream of its own, the packed
output gathered on the engine's device in row order. The engine stays
single-controller, as JAX's is. The point draws come once per batch from
the engine's generator, for the whole batch, and are then split, as JAX
draws one replicated key over the whole batch: a row's answer does not
depend on the number of replicas.
"""

from __future__ import annotations

import collections
import copy
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from keypointfusion_torch.config import Config
from keypointfusion_torch.data.device_preprocess import device_preprocess
from keypointfusion_torch.geometry.camera import xyz_nl_to_uvd_nl
from keypointfusion_torch.models.kpfusion import build_kpfusion
from keypointfusion_torch.utils.device import resolve_device
from keypointfusion_torch.utils.profiling import span


class StreamingEngine:
    """Fixed-batch streaming inference: full frames in, joints out."""

    def __init__(self, cfg: Config = Config(),
                 state_dict: Optional[dict] = None, batch_size: int = 64,
                 img_hw=(480, 640), dtype: torch.dtype = torch.bfloat16,
                 use_kernels: bool = True, device=None, seed: int = 0,
                 devices: Optional[Sequence] = None):
        """state_dict: the port's KPFusion weights (None draws them from
        `seed`). dtype is the model's compute dtype: bfloat16 runs the
        serving modes of the kernels, float32 their exact modes.
        use_kernels sends the model through the CUDA kernels (see
        models/kpfusion.py). Runs on the CUDA card unless `device` names
        another; without a card and without device='cpu' it raises.
        `devices`: one replica per entry (None: one, on `device`);
        batch_size must divide by their number. The first replica on
        `device` is `self.model`, the others copies of it made here. The
        inputs arrive on `device` and the output is gathered there."""
        self.cfg = cfg
        self.batch_size = batch_size
        self.img_hw = tuple(img_hw)
        self.device = resolve_device(device)
        replica_devices = [self.device] if devices is None else [
            resolve_device(d) for d in devices]
        if not replica_devices:
            raise ValueError('devices is empty')
        if batch_size % len(replica_devices):
            raise ValueError(
                f'batch_size {batch_size} not divisible by the number of '
                f'replicas {len(replica_devices)}')
        self.model = build_kpfusion(cfg, self.device, seed, use_kernels,
                                    dtype)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.replicas = [_Replica(self.model, d, i == 0 and d == self.device)
                         for i, d in enumerate(replica_devices)]
        self._joint_num = cfg.joint_num
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(cfg.seed)

    @torch.inference_mode()
    def pipeline(self, depth_full, rgb_full, centers, cube, cam,
                 uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One batch on the engine's device: depth_full [B,H,W] and
        rgb_full [B,H,W,3] (any real dtype), centers [B,3] (u, v, z_mm),
        cube [B,3], cam [B,4] -> packed [B, 2*3J+9] float32. The point
        draws are `uniform` [B,N], or the engine's generator's for the
        whole batch; each replica answers its rows."""
        if uniform is None:
            uniform = torch.rand((depth_full.shape[0], self.cfg.point_num),
                                 generator=self._generator,
                                 device=self.device)
        inputs = (depth_full, rgb_full, centers, cube, cam, uniform)
        if len(self.replicas) == 1:
            return self.replicas[0].answer(self.cfg, *inputs)
        per = depth_full.shape[0] // len(self.replicas)
        if self.device.type != 'cuda':
            return torch.cat([
                r.answer(self.cfg, *(t[i * per:(i + 1) * per]
                                     for t in inputs)).to(self.device)
                for i, r in enumerate(self.replicas)])
        main = torch.cuda.current_stream(self.device)
        outs = []
        for i, r in enumerate(self.replicas):
            r.stream.wait_stream(main)
            with torch.cuda.stream(r.stream):
                rows = [t[i * per:(i + 1) * per] for t in inputs]
                for t in rows:
                    t.record_stream(r.stream)
                outs.append(r.answer(self.cfg, *(
                    t.to(r.device, non_blocking=True) for t in rows)))
        parts = []
        for r, out in zip(self.replicas, outs):
            main.wait_stream(r.stream)
            out.record_stream(main)
            parts.append(out.to(self.device, non_blocking=True))
        return torch.cat(parts)

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
        (on the card, ready once the current stream reaches it). Spans:
        `kpf.engine.submit`, the whole host call; inside it
        `kpf.engine.stage`, the five arrays' host staging (contiguity, the
        pinned allocation, the host copy, the copies' enqueue)."""
        with span('kpf.engine.submit'):
            expected = (self.batch_size,) + self.img_hw
            if depth_full.shape != expected or depth_full.dtype != np.uint16:
                raise ValueError(f'depth must be uint16 {expected}, got '
                                 f'{depth_full.dtype} {depth_full.shape}')
            if rgb_full.shape != expected + (3,) or \
                    rgb_full.dtype != np.uint8:
                raise ValueError(f'rgb must be uint8 {expected + (3,)}, got '
                                 f'{rgb_full.dtype} {rgb_full.shape}')
            # uint16 travels as its int16 bit pattern (every PyTorch
            # version copies int16) and is widened on the device
            with span('kpf.engine.stage'):
                staged = [self._to_device(a) for a in (
                    depth_full.view(np.int16), rgb_full,
                    centers.astype(np.float32), cube.astype(np.float32),
                    cam.astype(np.float32))]
            return self.pipeline(staged[0].int() & 0xFFFF, *staged[1:])

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


class _Replica:
    """One copy of the engine's model on one device, and the CUDA stream
    it runs on (the engine's model itself for the first replica on the
    engine's device)."""

    def __init__(self, model, device: torch.device, own: bool):
        self.device = device
        if own:
            self.model = model
        else:
            self.model = copy.deepcopy(model).to(device)
        self.stream = (torch.cuda.Stream(device) if device.type == 'cuda'
                       else None)

    def answer(self, cfg: Config, depth_full, rgb_full, centers, cube, cam,
               uniform) -> torch.Tensor:
        """Packed [b, 2*3J+9] float32 for rows on this replica's device,
        on the current stream. Span `kpf.engine.preprocess`: the call of
        device_preprocess (the crops, their normalization, the point
        draw), its arguments' casts outside it."""
        frames = (depth_full.float(), rgb_full.float(), centers.float(),
                  cube.float(), cam.float())
        with span('kpf.engine.preprocess'):
            rgb, depth, pcl, frame = device_preprocess(
                *frames, cfg.input_size, cfg.point_num, uniform=uniform)
        results, _ = self.model(rgb, depth, pcl, frame, cfg.feature_para[0])
        joint_xyz = results[-1]
        joint_uvd = xyz_nl_to_uvd_nl(joint_xyz, frame)
        world = joint_xyz * frame.cube[:, None] / 2.0 + frame.center[:, None]
        b = world.shape[0]
        return torch.cat([world.reshape(b, -1).float(),
                          joint_uvd.reshape(b, -1).float(),
                          frame.M.reshape(b, -1)], dim=-1)
