"""BatchNorm with the JAX package's precision policy.

The JAX package's TorchBatchNorm (keypointfusion_tpu/models/norm.py)
re-implements torch's BatchNorm semantics in flax; here torch's own
BatchNorm is the implementation. In eval it normalizes with the running
statistics and eps 1e-5, in float32 whatever the input's dtype, and
returns the layer's compute dtype (models/layers.py): torch's batch_norm
takes a bfloat16 input with float32 parameters, computes in float32 and
rounds once, as the JAX layer does, without a cast pass on either side. A
float32 input in a bfloat16 layer (ConvNeXt's float32 residual stream
entering the decoder) is normalized in float32 and the result rounded,
as in JAX, not rounded first.
Train mode is torch's own, which TorchBatchNorm copies: it normalizes with
the biased batch variance and updates the running variance with the
unbiased one, momentum 0.1 (flax's 0.9, the weight of the old value); the
cast to float32 is differentiable, so the gradient reaches a bfloat16
input. `weighted_batch_norm` and `WeightedTorchBatchNorm` are the JAX
package's WeightedTorchBatchNorm: statistics over a weighted multiset.

Global-batch statistics (sync BatchNorm): inside
`global_batch_statistics(model, group)`, every BatchNorm of the model in
train mode takes its statistics over the rows of every rank of `group`,
which is what the JAX package's BatchNorm computes under a sharded jit
(GSPMD reduces over the global batch). They are taken in two passes, as
JAX takes them: the sum and the count all-reduced, the mean, then the
squared deviations from it all-reduced; the running variance takes
Bessel's factor over the global count. The all-reduces are
torch.distributed.nn's, whose backward all-reduces the gradient, so each
rank's backward carries the other ranks' share of the statistics'
gradient. nn.SyncBatchNorm is not used: converting to it would drop these
classes' compute-dtype policy and the [..., C] layout. Without a group,
or with a world of 1, the code paths above run unchanged.
"""

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch import nn


def sync_group(bn: nn.Module):
    """The process group over whose ranks `bn` takes its train-mode
    statistics, or None (its own rows): set only inside
    global_batch_statistics, and only for a world above 1."""
    return getattr(bn, 'sync_group', None) if bn.training else None


@contextlib.contextmanager
def global_batch_statistics(model: nn.Module, group):
    """Every BatchNorm of `model` takes train-mode statistics over the
    global batch of `group`'s ranks while the context lasts. Hold it over
    the forward and the backward: a recomputed forward (cfg.remat) runs
    inside the backward. With group None or a world of 1 it changes
    nothing."""
    norms = []
    if group is not None and dist.get_world_size(group) > 1:
        norms = [m for m in model.modules()
                 if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.sync_group = group
    try:
        yield
    finally:
        for m in norms:
            del m.sync_group


def global_batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
                      group, weights: Optional[torch.Tensor] = None,
                      channel_dim: int = -1) -> torch.Tensor:
    """Train-mode BatchNorm of x with statistics over the rows of every
    rank of `group`, in the dtype of `bn`'s parameters, running
    statistics updated in place. Channels on `channel_dim`; `weights`
    (broadcast to x's shape without the channel axis, which must then be
    last) weight each row as in weighted_batch_norm."""
    dt = bn.weight.dtype
    xf = x.to(dt)
    cd = channel_dim % xf.ndim
    c = xf.shape[cd]
    dims = [d for d in range(xf.ndim) if d != cd]
    shape = [1] * xf.ndim
    shape[cd] = c
    if weights is None:
        w = None
        count = xf.new_full((1,), xf.numel() // c)
        local = torch.cat([xf.sum(dims), count])
    else:
        if cd != xf.ndim - 1:
            raise ValueError('weighted statistics take channels last')
        w = weights.detach().to(dt).expand(x.shape[:-1])[..., None]
        local = torch.cat([(w * xf).sum(dims), w.sum().reshape(1)])
    total = dist_nn.all_reduce(local, group=group)
    n = total[c]
    mean = total[:c] / n
    xc = xf - mean.reshape(shape)
    sq = xc * xc if w is None else w * (xc * xc)
    var = dist_nn.all_reduce(sq.sum(dims), group=group) / n
    with torch.no_grad():
        m = bn.momentum
        bessel = n / torch.clamp_min(n - 1, 1)
        bn.running_mean.mul_(1 - m).add_(m * mean)
        bn.running_var.mul_(1 - m).add_(m * var * bessel)
        bn.num_batches_tracked.add_(1)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return xc * scale.reshape(shape) + bn.bias.reshape(shape)


class BatchNorm2d(nn.BatchNorm2d):
    """NCHW BatchNorm."""
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = sync_group(self)
        if group is not None:
            return global_batch_norm(x, self, group, channel_dim=1).to(
                self.compute_dtype)
        if x.dtype == torch.float32:
            return super().forward(x).to(self.compute_dtype)
        return super().forward(x.to(self.compute_dtype))


class TorchBatchNorm(nn.BatchNorm1d):
    """nn.BatchNorm1d applied to x [..., C]: statistics over every axis
    but the last. The state_dict names are BatchNorm1d's, as in the
    reference's Conv1d + BatchNorm1d embeddings."""
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(-1, shape[-1]).to(self.compute_dtype)
        group = sync_group(self)
        if group is not None:
            return global_batch_norm(x, self, group).to(
                self.compute_dtype).reshape(shape)
        return super().forward(x).reshape(shape)


def weighted_batch_norm(x: torch.Tensor, weights: torch.Tensor,
                        bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Train-mode BatchNorm of x [..., C] over a weighted multiset, in
    the dtype of `bn`'s parameters (float32), with `bn`'s affine parameters and running statistics
    (updated in place, as torch's BatchNorm updates them): the statistics
    are sum(w x) / sum(w) and the weighted biased variance, the running
    variance takes the Bessel factor n / (n - 1) with n = sum(w). weights
    broadcast to x.shape[:-1]; no gradient flows into them. Inside
    global_batch_statistics the sums run over every rank's rows."""
    group = sync_group(bn)
    if group is not None:
        return global_batch_norm(x, bn, group, weights)
    c, dt = x.shape[-1], bn.weight.dtype
    xf = x.to(dt).reshape(-1, c)
    w = weights.detach().to(dt).expand(x.shape[:-1]).reshape(-1)
    n = w.sum()
    mean = (w @ xf) / n
    xc = xf - mean
    var = (w @ (xc * xc)) / n
    with torch.no_grad():
        m = bn.momentum
        bessel = n / torch.clamp_min(n - 1, 1)
        bn.running_mean.mul_(1 - m).add_(m * mean)
        bn.running_var.mul_(1 - m).add_(m * var * bessel)
        bn.num_batches_tracked.add_(1)
    y = xc * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    return y.reshape(x.shape)


class WeightedTorchBatchNorm(TorchBatchNorm):
    """TorchBatchNorm whose train-mode statistics may be weighted
    (weighted_batch_norm); without weights, or in eval, it is
    TorchBatchNorm. The same parameters and buffers, so the same
    state_dict. DESA's dense train path (models/desa.py) weights each
    support point by its slot count in the gather path's groups, which
    gives the gather path's statistics."""

    def forward(self, x: torch.Tensor,
                weights: torch.Tensor = None) -> torch.Tensor:
        if weights is None or not self.training:
            return super().forward(x)
        return weighted_batch_norm(x, weights, self).to(self.compute_dtype)
