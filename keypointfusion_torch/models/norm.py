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
input.
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
