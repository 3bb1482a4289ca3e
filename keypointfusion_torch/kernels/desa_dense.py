"""Whole-DESA eval kernel (K1), CUDA kernels and plain versions.

Port of keypointfusion_tpu/kernels/desa_dense_pallas.py:desa_dense_fused in
its two modes, in gather form, each a kernel of its own. 'highest' (float32
model; csrc/desa_dense.cu): for every joint j of batch element b, over the
support set = the N cloud points followed by the J joints, and for each
radius r_i:
  * d2 by the expansion (ops/pairwise.py);
  * the group: the first S_i support points with d2 < r_i^2 in storage
    order, or the closest point when the ball is empty;
  * h1 = relu((f_m - f_j) Wf_i + ((x_m - x_j)/r_i) Wl_i + b1_i),
    h2 = relu(h1 W2_i + b2_i), out_i = max of h2 over the group;
then relu([out_0 | out_1 | out_2 | f_j] Wfu + bfu). Every BatchNorm is
folded into the Dense before it (`fold_bn`). The dense form of the JAX
package (every support point through the MLP, masked) exists because the
TPU has no fast gather; its masked-max set is exactly this group.

'default' (bfloat16 serving; csrc/desa_dense_serving.cu) is what the JAX
kernel computes in interpret mode (its lines 94-166, 184-250): the same d2
and groups, but the split form of the first layer, with bfloat16 operands
where the JAX kernel casts to bfloat16 and float32 sums:
  A_m = bf16(f_m) bf16(Wf_i) + (x_m Wl_i) * (1/r_i)     per support point
  b_j = f_j Wf_i + (x_j Wl_i) * (1/r_i) - b1_i           float32 throughout
  h1 = relu(A_m - b_j),  h2 = relu(bf16(h1) bf16(W2_i) + b2_i)
  out = relu(bf16([out_0 | out_1 | out_2 | f_j]) bf16(Wfu) + bfu)
The features arrive in bfloat16 (the model's dtype), so f_m and f_j are
bfloat16 values. The coordinate products stay float32: the JAX kernel
writes them at Precision.DEFAULT with float32 operands, which XLA's CPU
build runs in float32 (measured: DEFAULT and HIGHEST give the same error
on a float32 product), while a TPU rounds them to bfloat16. Both modes
return float32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from keypointfusion_torch.kernels.build import CudaKernel, check_tensor
from keypointfusion_torch.ops.ball_query import ball_query_slots
from keypointfusion_torch.ops.pairwise import pairwise_sqdist

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_P] * 7 + [_F] * 6 + [_I] * 3 + [_P] + [_I] * 3 + [_P]
KERNEL = CudaKernel('desa_dense', 'desa_dense.cu', 'kpf_desa_dense',
                    _ARGTYPES)
SERVING_KERNEL = CudaKernel('desa_dense_serving', 'desa_dense_serving.cu',
                            'kpf_desa_dense_serving', _ARGTYPES)
CHANNELS = 128           # the kernel's block is one thread per channel
MAX_SAMPLES = 64         # group slots the kernel holds per radius
MAX_SUPPORT = 6144       # support points whose d2 fit in shared memory


class DesaWeights(NamedTuple):
    """BN-folded DESA weights, Dense layout [in, out], float32.
    wf [R,C,C], wl [R,3,C], b1 [R,C] (= folded bias of the loc layer plus
    that of the feature layer), w2 [R,C,C], b2 [R,C], wfu [(R+1)C, C],
    bfu [C], for R radii."""
    wf: torch.Tensor
    wl: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    wfu: torch.Tensor
    bfu: torch.Tensor


def fold_bn(kernel, bias, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold an eval BatchNorm into the Dense before it:
    BN(x W + b) == x W' + b'. kernel [in, out]; the rest [out]. A port of
    keypointfusion_tpu/kernels/desa_pallas.py:fold_bn."""
    scale = gamma / torch.sqrt(var + eps)
    return kernel * scale[None, :], (bias - mean) * scale + beta


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, as float32."""
    return t.to(torch.bfloat16).float()


def desa_dense_plain(pcl_feat, node_feat, pcl_xyz, node_xyz,
                     w: DesaWeights, radius: Sequence[float],
                     num_samples: Sequence[int], mode: str = 'highest'):
    """pcl_feat [B,N,C], node_feat [B,J,C], pcl_xyz [B,N,3],
    node_xyz [B,J,3] -> [B,J,C] float32, in plain PyTorch (gather form)."""
    if mode == 'default':
        return _desa_serving_plain(pcl_feat, node_feat, pcl_xyz, node_xyz, w,
                                   radius, num_samples)
    if mode != 'highest':
        raise ValueError(f'unknown mode {mode!r}')
    b, j, c = node_feat.shape
    sup_xyz = torch.cat([pcl_xyz, node_xyz], dim=1).float()
    sup_feat = torch.cat([pcl_feat, node_feat], dim=1).float()
    d2 = pairwise_sqdist(node_xyz, sup_xyz)                  # [B,J,M]
    rows = torch.arange(b, device=d2.device)[:, None, None]
    outs = []
    for i, (r, s) in enumerate(zip(radius, num_samples)):
        idx, valid = ball_query_slots(d2, r, s)              # [B,J,S]
        rel = (sup_xyz[rows, idx] - node_xyz[:, :, None, :]) / r
        diff = sup_feat[rows, idx] - node_feat[:, :, None, :]
        h1 = torch.relu(diff @ w.wf[i] + rel @ w.wl[i] + w.b1[i])
        h2 = torch.relu(h1 @ w.w2[i] + w.b2[i])
        h2 = torch.where(valid[..., None], h2,
                         torch.full_like(h2, -float('inf')))
        outs.append(h2.amax(dim=2))
    fused = torch.cat(outs + [node_feat.float()], dim=-1)
    return torch.relu(fused @ w.wfu + w.bfu)


def _desa_serving_plain(pcl_feat, node_feat, pcl_xyz, node_xyz,
                        w: DesaWeights, radius, num_samples):
    """The 'default' mode (module docstring), in plain PyTorch."""
    b = node_feat.shape[0]
    node_xyz = node_xyz.float()
    sup_xyz = torch.cat([pcl_xyz.float(), node_xyz], dim=1)
    node_f = _bf16(node_feat)
    sup_feat = torch.cat([_bf16(pcl_feat), node_f], dim=1)
    d2 = pairwise_sqdist(node_xyz, sup_xyz)                  # [B,J,M]
    rows = torch.arange(b, device=d2.device)[:, None, None]
    outs = []
    for i, (r, s) in enumerate(zip(radius, num_samples)):
        idx, valid = ball_query_slots(d2, r, s)              # [B,J,S]
        inv_r = 1.0 / r
        a = sup_feat @ _bf16(w.wf[i]) + (sup_xyz @ w.wl[i]) * inv_r
        b_j = node_f @ w.wf[i] + (node_xyz @ w.wl[i]) * inv_r - w.b1[i]
        h1 = torch.relu(a[rows, idx] - b_j[:, :, None, :])
        h2 = torch.relu(_bf16(h1) @ _bf16(w.w2[i]) + w.b2[i])
        h2 = torch.where(valid[..., None], h2,
                         torch.full_like(h2, -float('inf')))
        outs.append(h2.amax(dim=2))
    fused = _bf16(torch.cat(outs + [node_f], dim=-1))
    return torch.relu(fused @ _bf16(w.wfu) + w.bfu)


def desa_dense(pcl_feat, node_feat, pcl_xyz, node_xyz, w: DesaWeights,
               radius: Sequence[float] = (0.1, 0.2, 0.4),
               num_samples: Sequence[int] = (64, 64, 64),
               mode: str = 'highest'):
    """The K1 entry point. CPU tensors take the plain version; CUDA
    tensors launch the mode's kernel (and raise on anything it does not
    take). 'highest' takes float32 features, 'default' bfloat16."""
    if pcl_feat.device.type == 'cpu':
        return desa_dense_plain(pcl_feat, node_feat, pcl_xyz, node_xyz, w,
                                radius, num_samples, mode)
    if pcl_feat.device.type != 'cuda':
        raise ValueError(f'unsupported device {pcl_feat.device}')
    if mode not in ('highest', 'default'):
        raise ValueError(f'unknown mode {mode!r}')
    feat_dtype = torch.float32 if mode == 'highest' else torch.bfloat16
    b, n, c = pcl_feat.shape
    j = node_feat.shape[1]
    dev = pcl_feat.device
    if len(radius) != 3 or len(num_samples) != 3:
        raise ValueError('the kernel takes exactly 3 radii')
    if c != CHANNELS:
        raise ValueError(f'the kernel takes C={CHANNELS}, got C={c}')
    if not all(1 <= s <= MAX_SAMPLES for s in num_samples):
        raise ValueError(f'num_samples must lie in [1, {MAX_SAMPLES}]')
    if n + j > MAX_SUPPORT:
        raise ValueError(f'support of {n + j} points exceeds {MAX_SUPPORT}')
    check_tensor(pcl_feat, 'pcl_feat', (b, n, c), dev, feat_dtype)
    check_tensor(node_feat, 'node_feat', (b, j, c), dev, feat_dtype)
    for t, name, shape in ((pcl_xyz, 'pcl_xyz', (b, n, 3)),
                           (node_xyz, 'node_xyz', (b, j, 3)),
                           (w.wf, 'wf', (3, c, c)), (w.wl, 'wl', (3, 3, c)),
                           (w.b1, 'b1', (3, c)), (w.w2, 'w2', (3, c, c)),
                           (w.b2, 'b2', (3, c)), (w.wfu, 'wfu', (4 * c, c)),
                           (w.bfu, 'bfu', (c,))):
        check_tensor(t, name, shape, dev)
    out = torch.empty((b, j, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel = KERNEL if mode == 'highest' else SERVING_KERNEL
        kernel.launch(pcl_feat.data_ptr(), node_feat.data_ptr(),
                      pcl_xyz.data_ptr(), node_xyz.data_ptr(),
                      w.wf.data_ptr(), w.wl.data_ptr(), w.b1.data_ptr(),
                      w.w2.data_ptr(), w.b2.data_ptr(), w.wfu.data_ptr(),
                      w.bfu.data_ptr(),
                      # r (1/r in 'default') and r*r rounded once to
                      # float32, as the plain version's `/ r` (`* inv_r`)
                      # and `< r * r` round them
                      *(float(r) if mode == 'highest' else 1.0 / r
                        for r in radius),
                      *(float(r * r) for r in radius),
                      *(int(s) for s in num_samples),
                      out.data_ptr(), b, n, j, stream)
    return out
