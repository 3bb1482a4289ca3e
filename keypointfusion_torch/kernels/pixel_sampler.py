"""Fused point -> pixel feature sampler (K2), CUDA kernels and plain versions.

Port of keypointfusion_tpu/kernels/pixel_sampler_pallas.py:
sample_pixel_features_fused, in its two modes, each a kernel of its own:

'highest' (float32 model; csrc/pixel_sampler.cu): per cloud point, float32
d2 to every back-projected pixel centre by the expansion (ops/pairwise.py),
the 4 nearest with the lowest index winning ties, weights 1/(d2+1e-8)
normalized by their sum + 1e-8, and the weighted sum of those 4 pixels'
feature rows. Returns float32. Its kernel finds the 4 nearest otherwise
than the plain version's stable sort (the 4 smallest distinct values by
warp reductions on the values' bits, then the candidates at or below the
4th in index order through a 4-slot list); `_highest_plain_lanes` runs
its steps on the CPU, and the tests hold it to the plain version.

'default' (bfloat16 serving; csrc/pixel_sampler_serving.cu): what the JAX
kernel computes in interpret mode (its lines 66-83, 134-156, 176-195):
  * d2 as the sum of squared coordinate differences, rounded as XLA's CPU
    build contracts `((0 + dx*dx) + dy*dy) + dz*dz` (measured, bit for
    bit): fma(dz, dz, fma(dx, dx, dy*dy));
  * a threshold, not a top-4: t0 = min d2 and t_{i+1} = min{d2 > t_i}, so
    t3 is the 4th smallest DISTINCT value (1e30 when a row has fewer than
    4), and every pixel with d2 <= t3 is selected. Exact ties admit whole
    rings, so a point may select many more than 4 pixels;
  * w = bf16(1/(d2 + 1e-8)); the features are bfloat16; the products are
    summed in float32 and so is the normalizer, sum(w) + 1e-8;
  * out = bf16(sum / normalizer). Returns bfloat16.
Here the sums run over the selected pixels in index order, in the kernel
and in its plain version alike, so the two agree bit for bit; XLA's dense
product sums them in its own order (one bfloat16 ulp at most after the
final rounding). The serving kernel finds the threshold and the selection
otherwise than the plain version (per-lane minima reduced over the warp on
the values' bits, ballots by chunk, rows added a few at a time);
`_serving_plain_lanes` runs its steps on the CPU, and the tests hold it to
the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from keypointfusion_torch.geometry.pcl import (
    inverse_distance_weights, sample_pixel_features, topk_smallest,
)
from keypointfusion_torch.kernels.build import CudaKernel, check_tensor
from keypointfusion_torch.ops.pairwise import fma, pairwise_sqdist, sqnorm3

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel('pixel_sampler', 'pixel_sampler.cu', 'kpf_pixel_sampler',
                    [_P, _P, _P, _P, _I, _I, _I, _I, _P])
SERVING_KERNEL = CudaKernel(
    'pixel_sampler_serving', 'pixel_sampler_serving.cu',
    'kpf_pixel_sampler_serving', [_P, _P, _P, _P, _I, _I, _I, _I, _P])
INFO_ARGTYPES = [_I, _I] + [_P] * 5     # both kernels' `_info` entry points
K_NEAREST = 4            # the only k the kernels take
MAX_HW = 2048            # pixels staged in shared memory per batch element
MAX_SERVING_C = 384      # channels a lane of the serving kernel accumulates
NO_THRESHOLD = 1e30      # the JAX kernel's BIG
_INF_BITS = 0x7f800000   # float32 +inf
_TOP_BITS = 0x7fffffff   # the largest bits a float32 >= +0 (or NaN) has
_ALL_BITS = 2 ** 32 - 1  # above every value's bits


def serving_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B,N,3], b [B,M,3] -> [B,N,M] float32 sums of squared differences,
    rounded as fma(dz, dz, fma(dx, dx, dy*dy))."""
    dx, dy, dz = (a.float()[:, :, None, i] - b.float()[:, None, :, i]
                  for i in range(3))
    return fma(dz, dz, fma(dx, dx, dy * dy))


def serving_threshold(d2: torch.Tensor, k: int = K_NEAREST) -> torch.Tensor:
    """The k-th smallest distinct value of each row of d2 [..., M] (1e30
    when a row has fewer than k), keepdim."""
    big = torch.full_like(d2, NO_THRESHOLD)
    thresh = d2.amin(-1, keepdim=True)
    for _ in range(k - 1):
        thresh = torch.where(d2 <= thresh, big, d2).amin(-1, keepdim=True)
    return thresh


def _least_above(bits: torch.Tensor, t: torch.Tensor,
                 nothing: int = _INF_BITS) -> torch.Tensor:
    """The kernels' step t -> the least value above t, on float32 bit
    patterns as int64 [..., lanes, chunks] (d2 >= 0, so the bits order as
    the floats): each lane's unsigned min of bits - t - 1 (mod 2^32, where
    the values at or below t wrap past 2^31), the min over the lanes, and
    `nothing` when nothing lies above t (+inf's bits in the serving
    kernel, _TOP_BITS in the 'highest' one)."""
    above = t + 1
    u = ((bits - above[..., None, None]) % 2 ** 32).amin(-1).amin(-1)
    return torch.where(u < 2 ** 31, u + above, torch.full_like(u, nothing))


def _serving_plain_lanes(pcl_xyz, img_xyz, flat_feat, lanes: int = 32,
                         rows_in_flight: int = 2):
    """sample_pixel_features_plain(mode='default') by the serving kernel's
    own steps (csrc/pixel_sampler_serving.cu), in plain PyTorch: lane l of
    a point's warp holds d2 of the pixels l + lanes*i, the pixels padded
    with +inf to whole groups of 8 chunks; the threshold is the min over
    the lanes' mins, then three times the least value above it, on the
    values' bits (`_least_above`); a ballot per chunk, in index order,
    gives the selected pixels, whose rows are taken `rows_in_flight` at a
    time (gathered, then added in order). Returns the same bits as the
    plain version."""
    d2 = serving_sqdist(pcl_xyz, img_xyz)                   # [B,N,HW]
    b, n, hw = d2.shape
    group = 8 * lanes
    span = -(-hw // group) * group
    d2 = torch.nn.functional.pad(d2, (0, span - hw), value=float('inf'))
    by_lane = d2.reshape(b, n, span // lanes, lanes).transpose(-1, -2)
    bits = by_lane.contiguous().view(torch.int32).long()   # [B,N,lanes,i]
    t = bits.amin(-1).amin(-1)
    for _ in range(3):
        t = _least_above(bits, t)
    t = t.int().view(torch.float32)
    thresh = torch.where(torch.isinf(t), torch.full_like(t, NO_THRESHOLD), t)

    # ballots chunk by chunk, lowest lane first: pixel index order
    selected = d2 <= thresh[..., None]
    w = torch.where(selected, (1.0 / (d2 + 1e-8)).to(torch.bfloat16).float(),
                    torch.zeros_like(d2))
    count = selected.sum(-1)
    arange = torch.arange(span)
    queue = torch.sort(torch.where(selected, arange, span + arange),
                       -1)[0] % span
    feat = flat_feat.to(torch.bfloat16)
    rows = torch.arange(b)[:, None]
    acc = torch.zeros((b, n, feat.shape[-1]))
    total = torch.zeros((b, n))
    most = int(count.max())
    for first in range(0, most, rows_in_flight):
        slots = range(first, min(first + rows_in_flight, most))
        gathered = [feat[rows, queue[..., s].clamp_max(hw - 1)].float()
                    for s in slots]
        for s, f in zip(slots, gathered):
            valid = s < count
            ws = torch.gather(w, -1, queue[..., s, None])[..., 0]
            total = torch.where(valid, total + ws, total)
            acc = torch.where(valid[..., None], acc + ws[..., None] * f, acc)
    return (acc / (total[..., None] + 1e-8)).to(torch.bfloat16)


def _highest_plain_lanes(pcl_xyz, img_xyz, flat_feat, lanes: int = 32):
    """sample_pixel_features_plain(mode='highest') by its kernel's own
    steps (csrc/pixel_sampler.cu), in plain PyTorch: the pixel centres
    padded to whole groups of 8 chunks with the origin at |x|^2 = +inf
    (d2 +inf, never NaN); d2 by the expansion, clamped at 0 on its bits;
    lane l of a point's warp holds the pixels l + lanes*i; t0 = the min
    over the lanes' mins, then t1, t2, t3, each the least value above the
    last (`_least_above`; every pixel a candidate when fewer than 4
    distinct values exist); the candidates (d2 <= t3) in index order.
    Up to `lanes` candidates: candidate r's class k (d2 == t_k) and its
    slot, the candidates of the lower classes and then those of its class
    before it. More: each enters a 4-slot list on a strictly smaller d2,
    the walk stopping at the first chunk reached once the 4th slot holds
    t0. Then the weights and the rows in slot order. Returns the same bits
    as the plain version."""
    b, n, _ = pcl_xyz.shape
    hw = img_xyz.shape[1]
    group = 8 * lanes
    span = -(-hw // group) * group
    img = torch.nn.functional.pad(img_xyz.float(), (0, 0, 0, span - hw))
    sq = torch.nn.functional.pad(sqnorm3(img_xyz.float()), (0, span - hw),
                                 value=float('inf'))
    p = pcl_xyz.float()
    px, py, pz = (p[:, :, None, i] for i in range(3))
    qx, qy, qz = (img[:, None, :, i] for i in range(3))
    cross = fma(pz, qz, fma(py, qy, px * qx))
    d2 = (sqnorm3(p)[:, :, None] + sq[:, None, :]) - 2.0 * cross
    bits = d2.view(torch.int32).clamp_min(0).long()        # [B,N,span]
    by_lane = bits.reshape(b, n, span // lanes, lanes).transpose(-1, -2)
    ts = [by_lane.amin(-1).amin(-1)]
    for _ in range(3):
        ts.append(_least_above(by_lane, ts[-1], _TOP_BITS))
    t0, t1, t2, t3 = ts

    # the candidates, lowest index first (chunk by chunk, lowest lane first)
    cand = bits <= t3[..., None]
    count = cand.sum(-1)
    arange = torch.arange(span)
    queue = torch.sort(torch.where(cand, arange, span + arange),
                       -1)[0] % span

    # up to `lanes` candidates: slots by class, then index
    m = queue[..., :lanes]
    has = torch.arange(m.shape[-1]) < count[..., None]
    v = torch.gather(bits, -1, m)
    cls = sum((v > t[..., None]).long() for t in (t0, t1, t2))
    cls = torch.where(has, cls, torch.full_like(cls, K_NEAREST))
    before = torch.arange(m.shape[-1])[:, None] < torch.arange(
        m.shape[-1])[None, :]                              # [r', r]
    lower = cls[..., :, None] < cls[..., None, :]
    tie = (cls[..., :, None] == cls[..., None, :]) & before
    rank = (lower | tie).sum(-2)                           # [B,N,lanes]
    slot = torch.where(has, rank, torch.full_like(rank, lanes))
    order = torch.argsort(slot, -1)[..., :K_NEAREST]
    lv = torch.gather(v, -1, order)
    li = torch.gather(m, -1, order)

    # more: the walk into a 4-slot list
    many = count > lanes
    if bool(many.any()):
        wv = torch.full((b, n, K_NEAREST), _ALL_BITS, dtype=torch.int64)
        wi = torch.zeros((b, n, K_NEAREST), dtype=torch.int64)
        done = ~many
        chunk = torch.full((b, n), -1, dtype=torch.int64)
        for s in range(int(count.max())):
            ms = queue[..., s]
            live = s < count
            new_chunk = live & (ms // lanes != chunk)
            done = torch.where(new_chunk & many, wv[..., -1] == t0, done)
            chunk = torch.where(live, ms // lanes, chunk)
            vs = torch.gather(bits, -1, ms[..., None])[..., 0]
            enter = live & ~done & (vs < wv[..., -1])
            wv[..., -1] = torch.where(enter, vs, wv[..., -1])
            wi[..., -1] = torch.where(enter, ms, wi[..., -1])
            for k in range(K_NEAREST - 1, 0, -1):
                swap = enter & (wv[..., k] < wv[..., k - 1])
                for x in (wv, wi):
                    hi, lo = x[..., k].clone(), x[..., k - 1].clone()
                    x[..., k] = torch.where(swap, lo, hi)
                    x[..., k - 1] = torch.where(swap, hi, lo)
            if bool(done.all()):
                break
        lv = torch.where(many[..., None], wv, lv)
        li = torch.where(many[..., None], wi, li)
    dist = lv.int().view(torch.float32)
    return sample_pixel_features(flat_feat, inverse_distance_weights(dist),
                                 li)


def kernel_info(mode: str, hw: int, c: int, library=None):
    """(points per block, dynamic shared memory bytes per block, blocks
    that fit on one SM, threads per block, rows in flight per warp) of the
    mode's kernel launch for (hw, c), as it and the CUDA runtime report
    them; `library` another build of the same source."""
    kernel = SERVING_KERNEL if mode == 'default' else KERNEL
    if library is None:
        kernel.load()
        library = kernel.library
    fn = getattr(ctypes.CDLL(str(library)), kernel.symbol + '_info')
    fn.argtypes = INFO_ARGTYPES
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(5)]
    rc = fn(hw, c, *(ctypes.addressof(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f'{kernel.name} info failed with cudaError {rc}')
    return tuple(v.value for v in vals)


def sample_pixel_features_plain(pcl_xyz, img_xyz, flat_feat, k: int = 4,
                                mode: str = 'highest'):
    """pcl_xyz [B,N,3], img_xyz [B,HW,3], flat_feat [B,HW,C] -> [B,N,C]
    (float32 in 'highest', bfloat16 in 'default'), in plain PyTorch."""
    if mode == 'highest':
        dist, idx = topk_smallest(pairwise_sqdist(pcl_xyz, img_xyz), k)
        return sample_pixel_features(flat_feat, inverse_distance_weights(dist),
                                     idx)
    if mode != 'default':
        raise ValueError(f'unknown mode {mode!r}')
    d2 = serving_sqdist(pcl_xyz, img_xyz)                   # [B,N,HW]
    selected = d2 <= serving_threshold(d2, k)
    w = (1.0 / (d2 + 1e-8)).to(torch.bfloat16).float()
    w = torch.where(selected, w, torch.zeros_like(w))
    # the selected pixels in index order, as [B,N,S] slots (S = the most
    # any point selects); empty slots carry weight 0
    hw = d2.shape[-1]
    arange = torch.arange(hw, device=d2.device)
    order = torch.sort(torch.where(selected, arange, hw + arange), -1)[0]
    slots = int(selected.sum(-1).max())
    idx = order[..., :slots] % hw
    w = torch.gather(w, -1, idx)
    feat = flat_feat.to(torch.bfloat16).float()
    rows = torch.arange(d2.shape[0], device=d2.device)[:, None]
    total = w[..., 0]
    out = w[..., 0, None] * feat[rows, idx[..., 0]]
    for s in range(1, slots):
        total = total + w[..., s]
        out = out + w[..., s, None] * feat[rows, idx[..., s]]
    return (out / (total[..., None] + 1e-8)).to(torch.bfloat16)


def sample_pixel_features_fused(pcl_xyz, img_xyz, flat_feat, k: int = 4,
                                mode: str = 'highest'):
    """The K2 entry point. CPU tensors take the plain version; CUDA
    tensors launch the mode's kernel (and raise on anything it does not
    take). 'default' takes bfloat16 features."""
    if pcl_xyz.device.type == 'cpu':
        return sample_pixel_features_plain(pcl_xyz, img_xyz, flat_feat, k,
                                           mode)
    if pcl_xyz.device.type != 'cuda':
        raise ValueError(f'unsupported device {pcl_xyz.device}')
    if mode not in ('highest', 'default'):
        raise ValueError(f'unknown mode {mode!r}')
    b, n, _ = pcl_xyz.shape
    hw, c = flat_feat.shape[1], flat_feat.shape[2]
    dev = pcl_xyz.device
    serving = mode == 'default'
    check_tensor(pcl_xyz, 'pcl_xyz', (b, n, 3), dev)
    check_tensor(img_xyz, 'img_xyz', (b, hw, 3), dev)
    check_tensor(flat_feat, 'flat_feat', (b, hw, c), dev,
                 torch.bfloat16 if serving else torch.float32)
    if k != K_NEAREST:
        raise ValueError(f'the kernel selects k={K_NEAREST}, got k={k}')
    if not K_NEAREST <= hw <= MAX_HW:
        raise ValueError(f'HW={hw} outside [{K_NEAREST}, {MAX_HW}]')
    if serving and c > MAX_SERVING_C:
        raise ValueError(f'C={c} exceeds {MAX_SERVING_C}')
    out = torch.empty((b, n, c), dtype=flat_feat.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        (SERVING_KERNEL if serving else KERNEL).launch(
            pcl_xyz.data_ptr(), img_xyz.data_ptr(), flat_feat.data_ptr(),
            out.data_ptr(), b, n, hw, c, stream)
    return out
