"""Keypoint transformers: the BERT-style post-LN encoder and the cross-only
decoder (port of keypointfusion_tpu/models/transformer.py).

Module names follow the reference (HuggingFace BERT layers for the
encoder; the decoder's packed `multihead_attn.in_proj_weight`), so its
state_dict loads. Attention is written out: 21-token sequences, 4 heads.
Dense layers, LayerNorms, embeddings and the attention follow the compute
dtype as flax's nn.Dense, nn.LayerNorm, nn.Embed and
nn.MultiHeadDotProductAttention do (models/layers.py).

Dropout (rate `dropout`, 0.1 in KPFusion) acts in train mode at the JAX
modules' sites: on the attention probabilities, on the attention's output,
after the FFN (the decoder's also after its ReLU) and on the encoder's
embedding sum. Its masks come from the `generator` the caller passes
down, never from the global RNG, as flax draws from rngs={'dropout': ...}.
The attention-probability mask is shared across the batch and the heads,
as flax's MultiHeadDotProductAttention shares it (broadcast_dropout).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from keypointfusion_torch.models.layers import (
    LayerNorm, Linear, cast_param, linear,
)


def dropout(x, rate: float, training: bool,
            generator: Optional[torch.Generator], shape=None):
    """flax nn.Dropout: in training, each element kept with probability
    1 - rate and divided by it, else 0; the identity otherwise. The mask
    has `shape` (x's by default, or one that broadcasts to it) and is
    drawn from `generator`, on x's device."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError('dropout in train mode draws from an explicit '
                         'torch.Generator; pass generator=')
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape if shape is None else shape,
                      generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def attention(q, k, v, heads: int, rate: float = 0.0,
              training: bool = False,
              generator: Optional[torch.Generator] = None):
    """Multi-head dot-product attention over projected q [B,Lq,C],
    k/v [B,Lk,C], in their dtype: the query is divided by sqrt(C/heads)
    rounded to that dtype before the product, as flax does. In training
    the probabilities take dropout at `rate`, one [Lq,Lk] mask for every
    batch element and head (flax's broadcast_dropout)."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    scale = float(torch.tensor(math.sqrt(d), dtype=q.dtype))
    q = q.reshape(b, lq, heads, d).transpose(1, 2) / scale
    k = k.reshape(b, lk, heads, d).transpose(1, 2)
    v = v.reshape(b, lk, heads, d).transpose(1, 2)
    w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    w = dropout(w, rate, training, generator, shape=(1, 1, lq, lk))
    return (w @ v).transpose(1, 2).reshape(b, lq, c)


def _normal_linear(m: Linear, std: float) -> Linear:
    nn.init.normal_(m.weight, std=std)
    nn.init.zeros_(m.bias)
    return m


class _DenseLN(nn.Module):
    """BERT's `dense` + `LayerNorm` pair (eps 1e-12)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.dense = _normal_linear(Linear(in_dim, out_dim), 0.02)
        self.LayerNorm = LayerNorm(out_dim, eps=1e-12)


class PostLNLayer(nn.Module):
    """MHA -> dropout -> LN(x + attn), FFN(exact gelu) -> dropout ->
    LN(x + ffn)."""

    def __init__(self, hidden: int = 128, heads: int = 4,
                 intermediate: int = 16, dropout: float = 0.1):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.attention = nn.Module()
        self.attention.self = nn.Module()
        for name in ('query', 'key', 'value'):
            setattr(self.attention.self, name,
                    _normal_linear(Linear(hidden, hidden), 0.02))
        self.attention.output = _DenseLN(hidden, hidden)
        self.intermediate = nn.Module()
        self.intermediate.dense = _normal_linear(
            Linear(hidden, intermediate), 0.02)
        self.output = _DenseLN(intermediate, hidden)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        drop = lambda t: dropout(t, self.dropout, self.training, generator)
        s = self.attention.self
        a = attention(s.query(x), s.key(x), s.value(x), self.heads,
                      self.dropout, self.training, generator)
        out = self.attention.output
        x = out.LayerNorm(x + drop(out.dense(a)))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + drop(self.output.dense(h)))


class KeypointEncoder(nn.Module):
    """Learned positions + linear feature embedding -> post-LN stack."""
    compute_dtype = torch.float32

    def __init__(self, hidden: int = 128, heads: int = 4, layers: int = 4,
                 intermediate: int = 16, img_dim: int = 128,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.position_embeddings = nn.Embedding(512, hidden)
        nn.init.normal_(self.position_embeddings.weight, std=0.02)
        self.img_embedding = _normal_linear(Linear(img_dim, hidden), 0.02)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            PostLNLayer(hidden, heads, intermediate, dropout)
            for _ in range(layers))

    def forward(self, img_feats, generator: Optional[torch.Generator] = None):
        seq = img_feats.shape[1]
        pos = self.position_embeddings.weight[None, :seq]
        x = self.img_embedding(img_feats) + cast_param(
            self, 'pos', pos, self.compute_dtype)
        x = dropout(x, self.dropout, self.training, generator)
        for layer in self.encoder.layer:
            x = layer(x, generator)
        return x


class KPInteraction(nn.Module):
    """Encoder + cls head with a linear residual from the raw input.
    Returns (sequence [B,J,H], prediction [B,J,out_dim])."""

    def __init__(self, hidden: int = 128, img_dim: int = 128,
                 out_dim: int = 3, dropout: float = 0.1):
        super().__init__()
        self.bert = KeypointEncoder(hidden=hidden, img_dim=img_dim,
                                    dropout=dropout)
        self.cls_head = _normal_linear(Linear(hidden, out_dim), 0.02)
        self.residual = _normal_linear(Linear(img_dim, out_dim), 0.02)

    def forward(self, img_feats, generator: Optional[torch.Generator] = None):
        seq = self.bert(img_feats, generator)
        return seq, self.cls_head(seq) + self.residual(img_feats)


class PackedAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed in_proj, out_proj)
    with the attention written out."""
    compute_dtype = torch.float32

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden))
        self.out_proj = Linear(hidden, hidden)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.xavier_uniform_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q, k, v, rate: float = 0.0,
                generator: Optional[torch.Generator] = None):
        dt = self.compute_dtype
        wq, wk, wv = (cast_param(self, f'w{i}', w, dt) for i, w in
                      enumerate(self.in_proj_weight.chunk(3)))
        bq, bk, bv = (cast_param(self, f'b{i}', b, dt) for i, b in
                      enumerate(self.in_proj_bias.chunk(3)))
        a = attention(linear(q, wq, bq, dt), linear(k, wk, bk, dt),
                      linear(v, wv, bv, dt), self.heads, rate, self.training,
                      generator)
        return self.out_proj(a)


class CrossDecoderLayer(nn.Module):
    """Cross-only decoder layer: learned query/key positions added to q, k
    AND v, post-LN (flax's default eps 1e-6), ReLU FFN, dropout after the
    attention, the ReLU and the FFN."""
    compute_dtype = torch.float32

    def __init__(self, hidden: int = 128, heads: int = 4, ffn: int = 128,
                 joint_num: int = 21, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_posembed = nn.Embedding(joint_num, hidden)
        self.cross_posembed = nn.Embedding(joint_num, hidden)
        self.multihead_attn = PackedAttention(hidden, heads)
        self.norm2 = LayerNorm(hidden, eps=1e-6)
        self.norm3 = LayerNorm(hidden, eps=1e-6)
        self.linear1 = Linear(hidden, ffn)
        self.linear2 = Linear(ffn, hidden)
        for lin in (self.linear1, self.linear2):
            nn.init.xavier_uniform_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, query, key,
                generator: Optional[torch.Generator] = None):
        drop = lambda t: dropout(t, self.dropout, self.training, generator)
        j = query.shape[1]
        dt = self.compute_dtype
        q = query + cast_param(self, 'self_pos',
                               self.self_posembed.weight[None, :j], dt)
        kv = key + cast_param(self, 'cross_pos',
                              self.cross_posembed.weight[None, :j], dt)
        a = self.multihead_attn(q, kv, kv, self.dropout, generator)
        x = self.norm2(query + drop(a))
        h = self.linear2(drop(torch.relu(self.linear1(x))))
        return self.norm3(x + drop(h))


class CrossDecoder(nn.Module):
    """N cross-only layers, each fed the ORIGINAL anchor features; only the
    last layer's output is returned (the reference's quirk), so only the
    last layer is computed. All layers exist so checkpoints load."""

    def __init__(self, hidden: int = 128, heads: int = 4, ffn: int = 128,
                 layers: int = 4, joint_num: int = 21, dropout: float = 0.1):
        super().__init__()
        self.decoder = nn.ModuleList(
            CrossDecoderLayer(hidden, heads, ffn, joint_num, dropout)
            for _ in range(layers))

    def forward(self, anchor_feats, img_feats,
                generator: Optional[torch.Generator] = None):
        return self.decoder[-1](anchor_feats, img_feats, generator)
