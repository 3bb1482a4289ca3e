"""Grouped DESA MLP + max-pool (K3), CUDA kernel and plain version, and
the DESA forward built on it.

Port of keypointfusion_tpu/kernels/desa_pallas.py. `grouped_mlp_pool`
(the JAX grouped_mlp_pool, its pl.pallas_call at line 97) takes one
radius's pre-gathered groups and BN-folded weights, all float32:
    h   = relu((rel Wl + bl) + ((grouped - node) Wf + bf))
    h   = relu(h W2 + b2)
    out = max of h over the slots where |rel|^2 < 1, or slot 0
The kept slots are recomputed from rel, which the caller divided by the
radius; the JAX function ignores its `valid` argument the same way, so
this one has none. Near the ball's edge |rel/r|^2 < 1 and d2 < r^2 may
disagree, so K3 is its own function and not K1's gather path.

`desa_apply_inference` (the JAX desa_apply_inference) runs a port DESA
module through it: d2, per radius `ball_query_group`, `group_features`,
the three folded layers and K3, then relu([out_0|out_1|out_2|node] Wfu +
bfu) as one torch.matmul, as the JAX function leaves it to XLA. The JAX
package has no model path through K3 (K1 replaced it); this is its only
entry point. The kernel is csrc/grouped_mlp_pool.cu: each product as
three TF32 tensor-core products with float32 sums, the weights split into
TF32 hi and lo once per block; `grouped_mlp_pool_emulated` runs that
arithmetic on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from keypointfusion_torch.kernels.build import CudaKernel, check_tensor
from keypointfusion_torch.kernels.desa_dense import _mm_tf32
from keypointfusion_torch.models.desa import DESA, fold_conv_bn
from keypointfusion_torch.ops.ball_query import (
    ball_query_group, group_features,
)
from keypointfusion_torch.ops.pairwise import pairwise_sqdist

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel('grouped_mlp_pool', 'grouped_mlp_pool.cu',
                    'kpf_grouped_mlp_pool', [_P] * 10 + [_I] * 3 + [_P])
INFO_ARGTYPES = [_P] * 4             # kpf_grouped_mlp_pool_info
CHANNELS = 128           # the kernel's products are 128 x 128
WARP_ROWS = 16           # rows of a group per warp: the kernel pads to it


def grouped_mlp_pool_plain(rel_xyz, grouped_feat, node_feat, wl, bl, wf, bf,
                           w2, b2):
    """rel_xyz [B,J,S,3] (already / r), grouped_feat [B,J,S,C], node_feat
    [B,J,C], Dense-layout weights wl [3,C], wf [C,C], w2 [C,C], biases [C]
    -> [B,J,C] float32, in plain PyTorch."""
    rel = rel_xyz.float()
    loc = rel @ wl + bl
    feat = (grouped_feat.float() - node_feat.float()[:, :, None]) @ wf + bf
    h = torch.relu(loc + feat)
    h = torch.relu(h @ w2 + b2)
    d2 = rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1] \
        + rel[..., 2] * rel[..., 2]
    keep = d2 < 1.0
    keep[..., 0] = True
    return torch.where(keep[..., None], h,
                       torch.full_like(h, -float('inf'))).amax(dim=2)


def grouped_mlp_pool_emulated(rel_xyz, grouped_feat, node_feat, wl, bl, wf,
                              bf, w2, b2, tf32_passes=3,
                              rows: int = WARP_ROWS):
    """The kernel's arithmetic in plain PyTorch, for the CPU tests: each
    group's slots padded with zero rows to a multiple of `rows` (the
    kernel's warp tile), both products from TF32 operands with float32
    sums (`tf32_passes` 3, the kernel's; 1, a control that drops the
    split; None, float32 products), and the max taken from 0 over the kept
    slots, where padded rows and slots outside the ball count as 0. Not
    bit for bit: the kernel adds each k-step's three products to its sum
    in turn."""
    mm = torch.matmul if tf32_passes is None else \
        functools.partial(_mm_tf32, passes=tf32_passes)
    rel, grouped = rel_xyz.float(), grouped_feat.float()
    s = rel.shape[2]
    pad = -s % rows
    rel = torch.nn.functional.pad(rel, (0, 0, 0, pad))
    grouped = torch.nn.functional.pad(grouped, (0, 0, 0, pad))
    loc = rel @ wl + bl
    feat = mm(grouped - node_feat.float()[:, :, None], wf) + bf
    h = torch.relu(loc + feat)
    h = torch.relu(mm(h, w2) + b2)
    return masked_max_from_zero(h, rel, s)


def masked_max_from_zero(h, rel, s: int):
    """The max of h [B,J,S',C] (every value >= 0) over the slots t < s
    with |rel_t|^2 < 1 or t = 0, the others counted as 0, as the kernel
    takes it; equal bit for bit to the max over the kept slots alone,
    since slot 0 is kept and no value is below 0."""
    d2 = rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1] \
        + rel[..., 2] * rel[..., 2]
    slot = torch.arange(rel.shape[2], device=rel.device)
    keep = ((d2 < 1.0) | (slot == 0)) & (slot < s)
    return torch.where(keep[..., None], h, torch.zeros_like(h)).amax(dim=2)


def kernel_info(library=None):
    """(groups per block and step, dynamic shared memory bytes per block,
    blocks that fit on one SM, threads per block) of the K3 kernel build
    (or of `library`, another build of its source), as it and the CUDA
    runtime report them."""
    if library is None:
        KERNEL.load()
        library = KERNEL.library
    fn = getattr(ctypes.CDLL(str(library)), KERNEL.symbol + '_info')
    fn.argtypes = INFO_ARGTYPES
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(4)]
    rc = fn(*(ctypes.addressof(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f'{KERNEL.name} info failed with cudaError {rc}')
    return tuple(v.value for v in vals)


def grouped_mlp_pool(rel_xyz, grouped_feat, node_feat, wl, bl, wf, bf, w2,
                     b2):
    """The K3 entry point. CPU tensors take the plain version; CUDA
    tensors launch the kernel (and raise on anything it does not take)."""
    if rel_xyz.device.type == 'cpu':
        return grouped_mlp_pool_plain(rel_xyz, grouped_feat, node_feat, wl,
                                      bl, wf, bf, w2, b2)
    if rel_xyz.device.type != 'cuda':
        raise ValueError(f'unsupported device {rel_xyz.device}')
    b, j, s, c = grouped_feat.shape
    dev = rel_xyz.device
    if c != CHANNELS:
        raise ValueError(f'the kernel takes C={CHANNELS}, got C={c}')
    if s < 1:
        raise ValueError('the kernel needs at least one slot')
    for t, name, shape in ((rel_xyz, 'rel_xyz', (b, j, s, 3)),
                           (grouped_feat, 'grouped_feat', (b, j, s, c)),
                           (node_feat, 'node_feat', (b, j, c)),
                           (wl, 'wl', (3, c)), (bl, 'bl', (c,)),
                           (wf, 'wf', (c, c)), (bf, 'bf', (c,)),
                           (w2, 'w2', (c, c)), (b2, 'b2', (c,))):
        check_tensor(t, name, shape, dev)
        if name in ('grouped_feat', 'node_feat', 'wf', 'w2') \
                and t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned (the kernel '
                             f'copies 16 bytes at a time)')
    out = torch.empty((b, j, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(rel_xyz.data_ptr(), grouped_feat.data_ptr(),
                      node_feat.data_ptr(), wl.data_ptr(), bl.data_ptr(),
                      wf.data_ptr(), bf.data_ptr(), w2.data_ptr(),
                      b2.data_ptr(), out.data_ptr(), b, j, s, stream)
    return out


def desa_apply_inference(module: DESA, pcl_feat, node_feat, pcl_xyz,
                         node_xyz, use_kernel: bool = True):
    """A port DESA (eval) on pcl_feat [B,N,C], node_feat [B,J,C], pcl_xyz
    [B,N,3], node_xyz [B,J,3] -> [B,J,C] float32, through K3 once per
    radius; use_kernel=False takes K3's plain version on any device."""
    pool = grouped_mlp_pool if use_kernel else grouped_mlp_pool_plain
    pcl_feat, node_feat = pcl_feat.float(), node_feat.float()
    support_xyz = torch.cat([pcl_xyz, node_xyz], dim=1).float()
    support_feat = torch.cat([pcl_feat, node_feat], dim=1)
    d2 = pairwise_sqdist(node_xyz, support_xyz)
    outs = []
    for i, (r, s) in enumerate(zip(module.radius, module.num_samples)):
        idx, _, rel = ball_query_group(support_xyz, node_xyz.float(), r, s,
                                       d2=d2)
        grouped = group_features(support_feat, idx)
        wl, bl = fold_conv_bn(module.conv_l0_blocks[i],
                              module.bn_l0_blocks[i])
        wf, bf = fold_conv_bn(module.conv_f0_blocks[i],
                              module.bn_f0_blocks[i])
        w2, b2 = fold_conv_bn(module.conv_blocks[i][0],
                              module.bn_blocks[i][0])
        outs.append(pool(
            (rel / r).contiguous(), grouped.contiguous(),
            node_feat.contiguous(), wl.contiguous(), bl, wf.contiguous(), bf,
            w2.contiguous(), b2))
    wfu, bfu = fold_conv_bn(module.fusion[0], module.fusion[1])
    fused = torch.cat(outs + [node_feat], dim=-1)
    return torch.relu(fused @ wfu + bfu)
