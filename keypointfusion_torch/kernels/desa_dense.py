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
TPU has no fast gather; its masked-max set is exactly this group. The
kernel runs each product of the MLP and of the fusion as three TF32
products summed in float32 (split x = hi + lo, lo_a hi_b + hi_a lo_b +
hi_a hi_b), as the TPU emulates float32 in bfloat16 passes;
`_desa_highest_plain(tf32_passes=...)` emulates that arithmetic bit by bit
(one pass is the control that must fail the limit). Its weights come
packed (`highest_weights`), which models/desa.py keeps per module.

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
return float32. The joint term b_j is a plain product outside the kernel
(`serving_joint_term`), as JAX computes it outside its Pallas kernel
(desa_dense_pallas.py:201-206); the kernel takes its bfloat16 weights
ready packed (`serving_weights`), which models/desa.py keeps per module.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from keypointfusion_torch.kernels.build import CudaKernel, check_tensor
from keypointfusion_torch.ops.ball_query import ball_query_slots
from keypointfusion_torch.ops.pairwise import pairwise_sqdist

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# features and coordinates, the seven tensors of the pack, r and r*r (or
# 1/r and r*r) and slots per radius, out, sizes and stream
_ARGTYPES = [_P] * 4 + [_P] * 7 + [_F] * 6 + [_I] * 3 + [_P] + [_I] * 3 + [_P]
KERNEL = CudaKernel('desa_dense', 'desa_dense.cu', 'kpf_desa_dense',
                    _ARGTYPES)
# the same argument types: the joint term b_j and six packed weights
SERVING_KERNEL = CudaKernel('desa_dense_serving', 'desa_dense_serving.cu',
                            'kpf_desa_dense_serving', _ARGTYPES)
# kpf_desa_dense_serving_groups (`serving_groups`): coordinates, r*r and
# slots per radius, sel, nsel, sizes and stream
GROUPS_ARGTYPES = [_P] * 2 + [_F] * 3 + [_I] * 3 + [_P] * 2 + [_I] * 3 + [_P]
# kpf_desa_dense_info and kpf_desa_dense_serving_info (`kernel_info`):
# three int pointers
INFO_ARGTYPES = [_P] * 3
CHANNELS = 128           # the kernels' blocks are 128 threads
MAX_SAMPLES = 64         # group slots the kernels hold per radius
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


class ServingWeights(NamedTuple):
    """DesaWeights as the 'default' mode reads them, made and checked once
    by `serving_weights`. For the kernel, each matrix rounded to bfloat16
    and stored [out, in]: wf_t [R,C,C], w2_t [R,C,C], wfu_t [R+1,C,C]
    (chunk q = wfu[qC:(q+1)C] transposed); wl [R,3,C], b2 [R,C] and bfu [C]
    float32. For the joint term, float32 with the radii side by side
    (columns iC..(i+1)C are radius i's): wf_cat [C,R*C], wl_cat [3,R*C],
    and b1 [R,C]."""
    wf_t: torch.Tensor
    w2_t: torch.Tensor
    wfu_t: torch.Tensor
    wl: torch.Tensor
    b2: torch.Tensor
    bfu: torch.Tensor
    wf_cat: torch.Tensor
    wl_cat: torch.Tensor
    b1: torch.Tensor


def serving_weights(w: DesaWeights) -> ServingWeights:
    """w packed for the 'default' mode (ServingWeights). Raises on weights
    that are not contiguous float32 of one device and DesaWeights' shapes
    for 3 radii."""
    c = w.wf.shape[-1]
    _check_weights(w, c, w.wf.device)
    pack = lambda m: m.transpose(-1, -2).to(torch.bfloat16).contiguous()
    side = lambda m: m.transpose(0, 1).reshape(m.shape[1], -1).contiguous()
    out = ServingWeights(wf_t=pack(w.wf), w2_t=pack(w.w2),
                         wfu_t=pack(w.wfu.reshape(-1, c, c)), wl=w.wl,
                         b2=w.b2, bfu=w.bfu, wf_cat=side(w.wf),
                         wl_cat=side(w.wl), b1=w.b1)
    _check_aligned(out)
    return out


class HighestWeights(NamedTuple):
    """DesaWeights as the 'highest' kernel reads them, made and checked
    once by `highest_weights`, float32: each matrix stored [out, in],
    wf_t [R,C,C], w2_t [R,C,C] with its input channels in the order
    (0, 2, 4, 6, 1, 3, 5, 7) within every 8 (so h1 passes from one product
    to the next in registers, csrc/desa_mma.cuh), wfu_t [R+1,C,C] (chunk q
    = wfu[qC:(q+1)C] transposed); wl [R,3,C], b1 [R,C], b2 [R,C], bfu [C]
    as folded. The field order is the kernel's argument order."""
    wf_t: torch.Tensor
    w2_t: torch.Tensor
    wfu_t: torch.Tensor
    wl: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    bfu: torch.Tensor


_W2_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _w2_k_order(c: int, device) -> torch.Tensor:
    """Position q of a packed W2 row holds input channel [q]."""
    order = torch.tensor(_W2_K_ORDER, device=device)
    return (torch.arange(0, c, 8, device=device)[:, None] + order).flatten()


def highest_weights(w: DesaWeights) -> HighestWeights:
    """w packed for the 'highest' kernel (HighestWeights). Raises on
    weights that are not contiguous float32 of one device and DesaWeights'
    shapes for 3 radii."""
    c = w.wf.shape[-1]
    _check_weights(w, c, w.wf.device)
    pack = lambda m: m.transpose(-1, -2).contiguous()
    out = HighestWeights(
        wf_t=pack(w.wf), w2_t=pack(w.w2[:, _w2_k_order(c, w.w2.device)]),
        wfu_t=pack(w.wfu.reshape(-1, c, c)), wl=w.wl, b1=w.b1, b2=w.b2,
        bfu=w.bfu)
    _check_aligned(out)
    return out


def _unpack_highest(pack: HighestWeights) -> DesaWeights:
    """The folded weights a HighestWeights was made from, bit for bit."""
    c = pack.wf_t.shape[-1]
    back = torch.argsort(_w2_k_order(c, pack.w2_t.device))
    return DesaWeights(
        wf=pack.wf_t.transpose(-1, -2), wl=pack.wl, b1=pack.b1,
        w2=pack.w2_t.transpose(-1, -2)[:, back], b2=pack.b2,
        wfu=pack.wfu_t.transpose(-1, -2).reshape(-1, c), bfu=pack.bfu)


def _check_aligned(pack) -> None:
    for name, t in zip(pack._fields, pack):
        if t.data_ptr() % 16:       # the kernels copy 16 bytes at a time
            raise ValueError(f'{name} must be 16-byte aligned')


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
                     w, radius: Sequence[float],
                     num_samples: Sequence[int], mode: str = 'highest'):
    """pcl_feat [B,N,C], node_feat [B,J,C], pcl_xyz [B,N,3],
    node_xyz [B,J,3] -> [B,J,C] float32, in plain PyTorch (gather form).
    w is a DesaWeights, or the mode's pack of it (HighestWeights,
    ServingWeights)."""
    if mode == 'default':
        return _desa_serving_plain(pcl_feat, node_feat, pcl_xyz, node_xyz, w,
                                   radius, num_samples)
    if mode != 'highest':
        raise ValueError(f'unknown mode {mode!r}')
    if isinstance(w, HighestWeights):
        w = _unpack_highest(w)
    return _desa_highest_plain(pcl_feat, node_feat, pcl_xyz, node_xyz, w,
                               radius, num_samples)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 fraction bits) as cvt.rna rounds it: to
    nearest, ties away from zero; float32."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b from TF32 operands with float32 sums: hi_a hi_b (1 pass), or
    lo_a hi_b + hi_a lo_b + hi_a hi_b with lo = tf32(x - hi) (3 passes,
    small terms first; the kernel adds the same products k-step by k-step,
    csrc/desa_mma.cuh:mma_tf32x3). Every product of two TF32 values is
    exact in float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    if passes != 3:
        raise ValueError(f'passes must be 1 or 3, got {passes}')
    return (_tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi)) + a_hi @ b_hi


def _desa_highest_plain(pcl_feat, node_feat, pcl_xyz, node_xyz,
                        w: DesaWeights, radius, num_samples,
                        tf32_passes=None):
    """The 'highest' mode (module docstring) in plain PyTorch. With
    `tf32_passes` (3 or 1) every product of the MLP and of the fusion
    takes TF32 operands (`_mm_tf32`): 3 is the kernel's arithmetic, 1 a
    control that a check of the kernel must tell apart."""
    mm = torch.matmul if tf32_passes is None else \
        functools.partial(_mm_tf32, passes=tf32_passes)
    b = node_feat.shape[0]
    sup_xyz = torch.cat([pcl_xyz, node_xyz], dim=1).float()
    sup_feat = torch.cat([pcl_feat, node_feat], dim=1).float()
    d2 = pairwise_sqdist(node_xyz, sup_xyz)                  # [B,J,M]
    rows = torch.arange(b, device=d2.device)[:, None, None]
    outs = []
    for i, (r, s) in enumerate(zip(radius, num_samples)):
        idx, valid = ball_query_slots(d2, r, s)              # [B,J,S]
        rel = (sup_xyz[rows, idx] - node_xyz[:, :, None, :]) / r
        diff = sup_feat[rows, idx] - node_feat[:, :, None, :]
        h1 = torch.relu(mm(diff, w.wf[i]) + rel @ w.wl[i] + w.b1[i])
        h2 = torch.relu(mm(h1, w.w2[i]) + w.b2[i])
        h2 = torch.where(valid[..., None], h2,
                         torch.full_like(h2, -float('inf')))
        outs.append(h2.amax(dim=2))
    fused = torch.cat(outs + [node_feat.float()], dim=-1)
    return torch.relu(mm(fused, w.wfu) + w.bfu)


def serving_joint_term(node_feat, node_xyz, pack: ServingWeights,
                       radius: Sequence[float]) -> torch.Tensor:
    """b_j = bf16(f_j) Wf_i + (x_j Wl_i) * (1/r_i) - b1_i for every joint
    and radius: [B,J,R,C] float32, float32 weights and products, one
    product per operand over all radii (JAX's b_i,
    desa_dense_pallas.py:202-206, with its two biases summed in b1)."""
    r, c = pack.b1.shape
    f = _bf16(node_feat) @ pack.wf_cat
    x = node_xyz.float() @ pack.wl_cat
    shape = f.shape[:-1] + (r, c)
    inv_r = _inv_radii(tuple(radius), f.device)
    return f.view(shape) + x.view(shape) * inv_r[:, None] - pack.b1


@functools.lru_cache(maxsize=None)
def _inv_radii(radius: tuple, device: torch.device) -> torch.Tensor:
    """float32(1/r) per radius on `device`, made once: a copy to the card
    on every call would wait for the stream. A normal tensor even when
    first asked for under inference_mode."""
    with torch.inference_mode(False):
        return torch.tensor([1.0 / r for r in radius], device=device)


def _desa_serving_plain(pcl_feat, node_feat, pcl_xyz, node_xyz, w,
                        radius, num_samples, keep_float32=()):
    """The 'default' mode (module docstring), in plain PyTorch; w is a
    DesaWeights or its ServingWeights. `keep_float32` names roundings of
    the contract to leave out, 'h1' or 'fusion' (the fusion input): a
    control that a check of the kernel must tell apart."""
    pack = w if isinstance(w, ServingWeights) else serving_weights(w)
    round_h1 = _bf16 if 'h1' not in keep_float32 else lambda t: t
    round_cat = _bf16 if 'fusion' not in keep_float32 else lambda t: t
    b = node_feat.shape[0]
    node_xyz = node_xyz.float()
    sup_xyz = torch.cat([pcl_xyz.float(), node_xyz], dim=1)
    node_f = _bf16(node_feat)
    sup_feat = torch.cat([_bf16(pcl_feat), node_f], dim=1)
    d2 = pairwise_sqdist(node_xyz, sup_xyz)                  # [B,J,M]
    b_j = serving_joint_term(node_feat, node_xyz, pack, radius)  # [B,J,R,C]
    rows = torch.arange(b, device=d2.device)[:, None, None]
    outs = []
    for i, (r, s) in enumerate(zip(radius, num_samples)):
        idx, valid = ball_query_slots(d2, r, s)              # [B,J,S]
        inv_r = 1.0 / r
        a = sup_feat @ pack.wf_t[i].float().t() \
            + (sup_xyz @ pack.wl[i]) * inv_r
        h1 = torch.relu(a[rows, idx] - b_j[:, :, i, None, :])
        h2 = torch.relu(round_h1(h1) @ pack.w2_t[i].float().t()
                        + pack.b2[i])
        h2 = torch.where(valid[..., None], h2,
                         torch.full_like(h2, -float('inf')))
        outs.append(h2.amax(dim=2))
    fused = round_cat(torch.cat(outs + [node_f], dim=-1))
    wfu = pack.wfu_t.float().transpose(1, 2).reshape(-1, pack.wfu_t.shape[-1])
    return torch.relu(fused @ wfu + pack.bfu)


def _check_inputs(pcl_feat, node_feat, pcl_xyz, node_xyz, radius,
                  num_samples, feat_dtype):
    """Raise on what the kernels do not take; returns (B, N, J, C)."""
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
    check_tensor(pcl_xyz, 'pcl_xyz', (b, n, 3), dev)
    check_tensor(node_xyz, 'node_xyz', (b, j, 3), dev)
    return b, n, j, c


def _check_weights(w: DesaWeights, c: int, dev) -> None:
    for t, name, shape in ((w.wf, 'wf', (3, c, c)), (w.wl, 'wl', (3, 3, c)),
                           (w.b1, 'b1', (3, c)), (w.w2, 'w2', (3, c, c)),
                           (w.b2, 'b2', (3, c)), (w.wfu, 'wfu', (4 * c, c)),
                           (w.bfu, 'bfu', (c,))):
        check_tensor(t, name, shape, dev)


def desa_dense(pcl_feat, node_feat, pcl_xyz, node_xyz, w,
               radius: Sequence[float] = (0.1, 0.2, 0.4),
               num_samples: Sequence[int] = (64, 64, 64),
               mode: str = 'highest'):
    """The K1 entry point. CPU tensors take the plain version; CUDA
    tensors launch the mode's kernel (and raise on anything it does not
    take). 'highest' takes float32 features, 'default' bfloat16. w is a
    DesaWeights, or the mode's pack of it (HighestWeights, ServingWeights;
    a DesaWeights is packed on each call)."""
    if pcl_feat.device.type == 'cpu':
        return desa_dense_plain(pcl_feat, node_feat, pcl_xyz, node_xyz,
                                w, radius, num_samples, mode)
    if pcl_feat.device.type != 'cuda':
        raise ValueError(f'unsupported device {pcl_feat.device}')
    if mode == 'default':
        pack = w if isinstance(w, ServingWeights) else serving_weights(w)
        return desa_dense_serving(pcl_feat, node_feat, pcl_xyz, node_xyz,
                                  pack, radius, num_samples)
    if mode != 'highest':
        raise ValueError(f'unknown mode {mode!r}')
    pack = w if isinstance(w, HighestWeights) else highest_weights(w)
    return desa_dense_highest(pcl_feat, node_feat, pcl_xyz, node_xyz, pack,
                              radius, num_samples)


def _check_launch(pcl_feat, node_feat, pcl_xyz, node_xyz, wf_t, radius,
                  num_samples, feat_dtype):
    """What a K1 kernel takes, checked before a launch: CUDA tensors, the
    inputs' shapes and types, 16-byte aligned feature rows, and the pack's
    width and device (the pack itself was checked when it was made).
    Returns (B, N, J, C)."""
    if pcl_feat.device.type != 'cuda':
        raise ValueError(f'the kernel takes CUDA tensors, got '
                         f'{pcl_feat.device}')
    b, n, j, c = _check_inputs(pcl_feat, node_feat, pcl_xyz, node_xyz,
                               radius, num_samples, feat_dtype)
    dev = pcl_feat.device
    if wf_t.shape[-1] != c or wf_t.device != dev:
        raise ValueError(f'the weights are C={wf_t.shape[-1]} on '
                         f'{wf_t.device}, the features C={c} on {dev}')
    for t, name in ((pcl_feat, 'pcl_feat'), (node_feat, 'node_feat')):
        if t.data_ptr() % 16:       # rows are copied 16 bytes at a time
            raise ValueError(f'{name} must be 16-byte aligned')
    return b, n, j, c


def desa_dense_highest(pcl_feat, node_feat, pcl_xyz, node_xyz,
                       pack: HighestWeights,
                       radius: Sequence[float] = (0.1, 0.2, 0.4),
                       num_samples: Sequence[int] = (64, 64, 64)):
    """K1 'highest' on CUDA tensors: one launch of csrc/desa_dense.cu."""
    b, n, j, c = _check_launch(pcl_feat, node_feat, pcl_xyz, node_xyz,
                               pack.wf_t, radius, num_samples, torch.float32)
    dev = pcl_feat.device
    out = torch.empty((b, j, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(pcl_feat.data_ptr(), node_feat.data_ptr(),
                      pcl_xyz.data_ptr(), node_xyz.data_ptr(),
                      *(t.data_ptr() for t in pack),
                      # r and r*r rounded once to float32, as the plain
                      # version's `/ r` and `< r * r` round them
                      *(float(r) for r in radius),
                      *(float(r * r) for r in radius),
                      *(int(s) for s in num_samples),
                      out.data_ptr(), b, n, j, stream)
    return out


def desa_dense_serving(pcl_feat, node_feat, pcl_xyz, node_xyz,
                       pack: ServingWeights,
                       radius: Sequence[float] = (0.1, 0.2, 0.4),
                       num_samples: Sequence[int] = (64, 64, 64)):
    """K1 'default' on CUDA tensors: the joint term
    (`serving_joint_term`), then one launch of csrc/desa_dense_serving.cu."""
    b, n, j, c = _check_launch(pcl_feat, node_feat, pcl_xyz, node_xyz,
                               pack.wf_t, radius, num_samples, torch.bfloat16)
    dev = pcl_feat.device
    joint_term = serving_joint_term(node_feat, node_xyz, pack, radius)
    out = torch.empty((b, j, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        SERVING_KERNEL.launch(
            pcl_feat.data_ptr(), node_feat.data_ptr(), pcl_xyz.data_ptr(),
            node_xyz.data_ptr(), joint_term.data_ptr(),
            *(t.data_ptr() for t in (pack.wf_t, pack.wl, pack.w2_t, pack.b2,
                                     pack.wfu_t, pack.bfu)),
            # 1/r and r*r rounded once to float32, as the plain version's
            # `* inv_r` and `< r * r` round them
            *(1.0 / r for r in radius), *(float(r * r) for r in radius),
            *(int(s) for s in num_samples),
            out.data_ptr(), b, n, j, stream)
    return out


def serving_groups(pcl_xyz, node_xyz,
                   radius: Sequence[float] = (0.1, 0.2, 0.4),
                   num_samples: Sequence[int] = (64, 64, 64)):
    """The groups the 'default' kernel selects, from its own code
    (kpf_desa_dense_serving_groups, which runs only that part and counts
    no launch): sel [B,J,R,64] int16, the support indices in slot order
    and -1 past the group, and nsel [B,J,R] int32. On CUDA tensors."""
    n, j = pcl_xyz.shape[1], node_xyz.shape[1]
    if len(radius) != 3 or len(num_samples) != 3:
        raise ValueError('the kernel takes exactly 3 radii')
    if not all(1 <= s <= MAX_SAMPLES for s in num_samples):
        raise ValueError(f'num_samples must lie in [1, {MAX_SAMPLES}]')
    if n + j > MAX_SUPPORT:
        raise ValueError(f'support of {n + j} points exceeds {MAX_SUPPORT}')
    if pcl_xyz.device.type != 'cuda':
        raise ValueError(f'the kernel takes CUDA tensors, got '
                         f'{pcl_xyz.device}')
    b, dev = pcl_xyz.shape[0], pcl_xyz.device
    check_tensor(pcl_xyz, 'pcl_xyz', (b, n, 3), dev)
    check_tensor(node_xyz, 'node_xyz', (b, j, 3), dev)
    sel = torch.empty((b, j, 3, MAX_SAMPLES), dtype=torch.int16, device=dev)
    nsel = torch.empty((b, j, 3), dtype=torch.int32, device=dev)
    fn = _library_fn('kpf_desa_dense_serving_groups', GROUPS_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(pcl_xyz.data_ptr(), node_xyz.data_ptr(),
                *(float(r * r) for r in radius),
                *(int(s) for s in num_samples), sel.data_ptr(),
                nsel.data_ptr(), b, n, j,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'desa_dense_serving groups failed with '
                           f'cudaError {rc}')
    return sel, nsel


def _library_fn(symbol: str, argtypes, kernel=SERVING_KERNEL,
                library=None):
    """Another C entry point of a K1 kernel's library (or of `library`)."""
    if library is None:
        kernel.load()
        library = kernel.library
    fn = getattr(ctypes.CDLL(str(library)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def kernel_info(mode: str = 'highest', library=None):
    """(joints per block, dynamic shared memory bytes per block, blocks
    that fit on one SM) of the mode's K1 kernel build, as it and the CUDA
    runtime report them."""
    kernel = KERNEL if mode == 'highest' else SERVING_KERNEL
    fn = _library_fn(kernel.symbol + '_info', INFO_ARGTYPES, kernel, library)
    vals = [ctypes.c_int() for _ in range(3)]
    rc = fn(*(ctypes.addressof(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f'{kernel.name} info failed with cudaError {rc}')
    return tuple(v.value for v in vals)
