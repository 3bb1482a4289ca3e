"""Image-sequence cross-attention variants, off the flagship path (port
of keypointfusion_tpu/models/transformer_extra.py; the reference's
model/transfusion_head.py:57-91, :560-632 and :711-783): the DETR sine
position embedding, DetrDecoder (joints attend to the image tokens) and
SpatialAggregateTR (image tokens attend to the joints).

The JAX package uses flax's plain MultiHeadDotProductAttention here, so
the port writes the attention out (models/transformer.py:attention, the
parameters packed as torch's MultiheadAttention packs them). Inputs and
outputs are [B, L, C] and NHWC as in JAX. Parameter names follow the JAX
module tree (`layer_0.cross_attn`, `query_pos_0`, `norm2`, ...); the
reference's own names could not be read, so a reference .pth of this
family will need a key map (its TransformerDecoderLayer holds
`multihead_attn`, `norm2`, `norm3`, `linear1`, `linear2`). Dropout acts
in train mode at the JAX module's sites, its masks drawn from the
`generator` passed down.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from keypointfusion_torch.models.layers import LayerNorm, Linear
from keypointfusion_torch.models.transformer import PackedAttention, dropout
from keypointfusion_torch.utils.device import resolve_device


def detr_sine_position_embedding(h: int, w: int, embedding_dim: int = 64,
                                 temperature: float = 10000.0,
                                 normalize: bool = True,
                                 device=None) -> torch.Tensor:
    """[H, W, 2*embedding_dim] float32 sine/cosine position features
    (transfusion_head.py:57-91, all-ones pixel mask), on `device`
    (utils/device.py:resolve_device)."""
    device = resolve_device(device)
    scale = 2 * math.pi
    f32 = torch.float32
    y = torch.arange(1, h + 1, dtype=f32, device=device)[:, None]
    x = torch.arange(1, w + 1, dtype=f32, device=device)[None, :]
    y, x = y.expand(h, w), x.expand(h, w)
    if normalize:
        y = y / (h + 1e-6) * scale
        x = x / (w + 1e-6) * scale
    dim_t = torch.arange(embedding_dim, dtype=f32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode='floor')
                            / embedding_dim)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        -1).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        -1).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


class _ImageCrossLayer(nn.Module):
    """Cross-only layer with explicit position tensors: attention of
    query + query_pos over key + key_pos (also the values), dropout,
    post-LN (eps 1e-6), ReLU FFN with dropout after the ReLU and the
    FFN (transfusion_head.py:141-151)."""

    def __init__(self, hidden: int = 128, heads: int = 4, ffn: int = 128,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.cross_attn = PackedAttention(hidden, heads)
        self.norm2 = LayerNorm(hidden, eps=1e-6)
        self.norm3 = LayerNorm(hidden, eps=1e-6)
        self.linear1 = Linear(hidden, ffn)
        self.linear2 = Linear(ffn, hidden)

    def forward(self, query, key, query_pos, key_pos,
                generator: Optional[torch.Generator] = None):
        drop = lambda t: dropout(t, self.dropout, self.training, generator)
        kv = key + key_pos
        a = self.cross_attn(query + query_pos, kv, kv, self.dropout,
                            generator)
        x = self.norm2(query + drop(a))
        h = self.linear2(drop(torch.relu(self.linear1(x))))
        return self.norm3(x + drop(h))


class _LastLayerStack(nn.Module):
    """`layers` image cross layers, each with its learned positions
    (`{pos_name}_{i}`), each fed the ORIGINAL inputs; only the last
    layer's output is returned (the reference's quirk,
    transfusion_head.py:625-631 and :776-781), so only the last layer
    runs. Every layer exists so that weights carry."""

    def __init__(self, pos_name: str, joint_num: int, hidden: int,
                 heads: int, ffn: int, dropout: float, layers: int):
        super().__init__()
        self.pos_name, self.layers, self.hidden = pos_name, layers, hidden
        for i in range(layers):
            setattr(self, f'{pos_name}_{i}', nn.Embedding(joint_num, hidden))
            setattr(self, f'layer_{i}',
                    _ImageCrossLayer(hidden, heads, ffn, dropout))

    def last(self):
        i = self.layers - 1
        return (getattr(self, f'{self.pos_name}_{i}').weight[None],
                getattr(self, f'layer_{i}'))


class DetrDecoder(_LastLayerStack):
    """Joints (learned query positions) attend over image tokens (sine
    key positions) (transfusion_head.py:560-632)."""

    def __init__(self, joint_num: int = 21, hidden: int = 128,
                 heads: int = 4, ffn: int = 128, dropout: float = 0.1,
                 layers: int = 3):
        super().__init__('query_pos', joint_num, hidden, heads, ffn,
                         dropout, layers)

    def forward(self, anchor_feats, img_feats,
                generator: Optional[torch.Generator] = None):
        """anchor_feats [B,J,C]; img_feats [B,H,W,C] -> [B,J,C]."""
        b, h, w, c = img_feats.shape
        key = img_feats.reshape(b, h * w, c)
        key_pos = detr_sine_position_embedding(
            h, w, self.hidden // 2, device=img_feats.device)
        q_pos, layer = self.last()
        return layer(anchor_feats, key, q_pos,
                     key_pos.reshape(1, h * w, -1), generator)


class SpatialAggregateTR(_LastLayerStack):
    """Image tokens (sine query positions) attend over joints (learned
    key positions) (transfusion_head.py:711-783)."""

    def __init__(self, joint_num: int = 21, hidden: int = 128,
                 heads: int = 4, ffn: int = 128, dropout: float = 0.1,
                 layers: int = 3):
        super().__init__('key_pos', joint_num, hidden, heads, ffn,
                         dropout, layers)

    def forward(self, img_feats, anchor_feats,
                generator: Optional[torch.Generator] = None):
        """img_feats [B,H,W,C]; anchor_feats [B,J,C] -> [B,H*W,C]."""
        b, h, w, c = img_feats.shape
        query = img_feats.reshape(b, h * w, c)
        q_pos = detr_sine_position_embedding(
            h, w, self.hidden // 2, device=img_feats.device)
        k_pos, layer = self.last()
        return layer(query, anchor_feats, q_pos.reshape(1, h * w, -1),
                     k_pos, generator)
