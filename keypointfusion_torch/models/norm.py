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
"""

import torch
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """NCHW BatchNorm."""
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        return super().forward(x).reshape(shape)


def weighted_batch_norm(x: torch.Tensor, weights: torch.Tensor,
                        bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Train-mode BatchNorm of x [..., C] over a weighted multiset, in
    the dtype of `bn`'s parameters (float32), with `bn`'s affine parameters and running statistics
    (updated in place, as torch's BatchNorm updates them): the statistics
    are sum(w x) / sum(w) and the weighted biased variance, the running
    variance takes the Bessel factor n / (n - 1) with n = sum(w). weights
    broadcast to x.shape[:-1]; no gradient flows into them."""
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
