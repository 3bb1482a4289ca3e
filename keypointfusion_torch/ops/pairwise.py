"""Pairwise squared distances by the ||a||^2 + ||b||^2 - 2ab expansion.

Port of keypointfusion_tpu/ops/pairwise.py. Ball membership (DESA) and the
exact top-k (pixel sampler) compare these values, so every version rounds
them alike, in this order:
    |a|^2 = (a0*a0 + a1*a1) + a2*a2          (each step rounded)
    a.b   = fma(a2, b2, fma(a1, b1, a0*b0))  (fused multiply-adds)
    d2    = max((|a|^2 + |b|^2) - 2*(a.b), 0)
which is how XLA on the CPU evaluates the JAX function (measured: equal
to the last bit), and how the CUDA kernels evaluate it (__fmaf_rn). Ties
and thresholds then fall the same way in the kernels, in this plain
version and in the JAX reference.
"""

import torch


def sqnorm3(x: torch.Tensor) -> torch.Tensor:
    """x [..., 3] -> (x0*x0 + x1*x1) + x2*x2, left to right."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] \
        + x[..., 2] * x[..., 2]


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    """x [..., C] -> the sum of squares, left to right (sqnorm3 for C=3)."""
    out = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i] * x[..., i]
    return out


def fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x*y + z with one rounding to float32, through float64: the float64
    product of two float32 values is exact, and rounding the float64 sum
    to float32 differs from a single rounding only when it lands exactly
    halfway between two float32 values."""
    return (x.double() * y.double() + z.double()).float()


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B,N,C], b [B,M,C] -> [B,N,M] squared Euclidean distances (>= 0),
    float32. C is 3 for points; the order above holds for any C (2 for
    pixel coordinates, geometry/sampling.py), left to right."""
    a = a.float()
    b = b.float()
    cross = a[:, :, None, 0] * b[:, None, :, 0]
    for i in range(1, a.shape[-1]):
        cross = fma(a[:, :, None, i], b[:, None, :, i], cross)
    d2 = (_sqnorm(a)[:, :, None] + _sqnorm(b)[:, None, :]) - 2.0 * cross
    return torch.clamp_min(d2, 0.0)
