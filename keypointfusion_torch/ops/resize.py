"""Image resizing with the reference's semantics (port of
keypointfusion_tpu/ops/resize.py). Public functions take NHWC tensors."""

import torch
import torch.nn.functional as F


def resize_nearest_torch(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NHWC nearest resize with torch's floor(dst*in/out) source rule."""
    b, h, w, c = x.shape
    oh, ow = (out_hw, out_hw) if isinstance(out_hw, int) else out_hw
    if (oh, ow) == (h, w):
        return x
    idx_h = (torch.arange(oh, device=x.device) * h) // oh
    idx_w = (torch.arange(ow, device=x.device) * w) // ow
    return x[:, idx_h][:, :, idx_w]


def upsample_bilinear_x2(x: torch.Tensor) -> torch.Tensor:
    """NCHW 2x bilinear upsample with half-pixel centers
    (align_corners=False), as the reference's nn.Upsample. NCHW because
    only the backbones call it. Two 1-D passes, rows then columns, each
    rounded to x's dtype, as jax.image.resize contracts them (in bfloat16
    this matches the JAX function bit for bit; one 2-D pass does not)."""
    y = F.interpolate(x, scale_factor=(2, 1), mode='bilinear',
                      align_corners=False)
    return F.interpolate(y, scale_factor=(1, 2), mode='bilinear',
                         align_corners=False)
