"""Layers with flax's `dtype` semantics: the port's precision policy.

The JAX package runs KPFusion in a compute `dtype` (bfloat16 for serving)
while its parameters and BatchNorm statistics stay float32. Each layer
here does what the flax layer of the same role does with `dtype=...`
(flax 0.12, read from its source), so a state_dict is float32 whatever the
compute dtype, and `model.to(torch.bfloat16)` is never used:
  * Linear / Conv2d (flax Dense / Conv): input, weight and bias are cast to
    the compute dtype at the op; the product is one op in that dtype
    (float32 accumulation, one rounding) and the bias is added after it,
    in that dtype. In bfloat16 that is a second rounding: the measured
    match with XLA's CPU convolution and dot is bit for bit this way, and
    not with the bias fused into the product. In float32 the bias stays
    fused (one kernel; the two differ by float32 rounding only).
  * BatchNorm (models/norm.py) and LayerNorm (flax nn.LayerNorm): the
    statistics and the normalization in float32, the result cast. torch's
    layer_norm takes the variance in two passes where flax takes
    E[x^2] - mean^2; the two differ at float32 rounding where |mean| is
    of the order of the spread, and flax's loses digits where it is far
    larger (tests/test_torch_port_backbones.py measures both against
    float64).
`set_compute_dtype(module, dtype)` sets the compute dtype of every layer
and block of a module tree that has one. Without gradients a parameter's
cast is made once and kept (`cast_param`), so a bfloat16 forward launches
no cast per weight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set `compute_dtype` on every submodule that has one."""
    for m in module.modules():
        if hasattr(m, 'compute_dtype'):
            m.compute_dtype = dtype
    return module


def cast_param(owner: nn.Module, key: str, t, dtype: torch.dtype):
    """t, a parameter of `owner` or a view of one, in `dtype`. Under
    no_grad or inference_mode the cast is kept on `owner`, outside its
    state_dict, and made again only when the parameter is replaced or
    written in place (.to(), load_state_dict); with gradients on, t is
    cast at the op."""
    if t is None or t.dtype == dtype:
        return t
    if torch.is_grad_enabled():
        return t.to(dtype)
    # the entry holds t, so no other tensor can take its address
    stamp = (t.data_ptr(), t._version, t.shape, dtype)
    cache = owner.__dict__.setdefault('_casts', {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        hit = cache[key] = (stamp, t.to(dtype), t)
    return hit[1]


def linear(x, weight, bias, dtype: torch.dtype):
    """flax Dense(dtype=dtype): x [..., I], weight [O, I] and bias [O]
    already in `dtype` (cast_param)."""
    if dtype == torch.float32:
        return F.linear(x.float(), weight, bias)
    y = F.linear(x.to(dtype), weight)
    return y if bias is None else y + bias


class Linear(nn.Linear):
    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        return linear(x, cast_param(self, 'weight', self.weight, dt),
                      cast_param(self, 'bias', self.bias, dt), dt)


class Conv2d(nn.Conv2d):
    """NCHW convolution with flax Conv(dtype=...) semantics."""
    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        weight = cast_param(self, 'weight', self.weight, dt)
        if dt == torch.float32 or self.bias is None:
            return self._conv_forward(x.to(dt), weight, self.bias)
        y = self._conv_forward(x.to(dt), weight, None)
        return y + cast_param(self, 'bias', self.bias, dt)[:, None, None]


class LayerNorm(nn.LayerNorm):
    compute_dtype = torch.float32

    def forward(self, x):
        return F.layer_norm(x.to(self.weight.dtype), self.normalized_shape,
                            self.weight, self.bias,
                            self.eps).to(self.compute_dtype)
