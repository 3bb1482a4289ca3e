"""DESA: multi-scale local point-feature aggregation around each joint
(port of keypointfusion_tpu/models/desa.py).

Parameters carry the reference's names (per-radius 1x1 Conv2d + BatchNorm2d
stacks, a Conv1d + BatchNorm1d fusion). In eval every BatchNorm folds into
the conv before it, and the whole computation is one call of
kernels/desa_dense.py:desa_dense (K1), or of its plain version when the
caller asks for it. As in the JAX module, a float32 DESA runs K1's
float32 'highest' mode and any other compute dtype its 'default' serving
mode, on features cast to that dtype; the result comes back in it.
Without gradients the folded weights and the mode's pack of them are made
once and kept (`kernel_weights`).

In train mode the module runs the JAX module's gather form
(dense_train=False): per radius, the group of ops/ball_query.py's
ball_query_group (the first S in-ball points in storage order, the
other slots repeating slot 0, an empty ball's closest point in every
slot) is gathered, each 1x1 conv is a Dense over the channels with its
BatchNorm's batch statistics taken over every slot (the fill slots
too), and the max runs over the valid slots only. No kernel runs in
train mode: K1 has no backward, as the JAX kernel has none.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from keypointfusion_torch.kernels.desa_dense import (
    DesaWeights, desa_dense, desa_dense_plain, fold_bn, highest_weights,
    serving_weights,
)
from keypointfusion_torch.models.layers import linear
from keypointfusion_torch.models.norm import (
    global_batch_norm, sync_group, weighted_batch_norm,
)
from keypointfusion_torch.models.resnet import init_conv
from keypointfusion_torch.ops.ball_query import (
    ball_query_group, exclusive_rank, group_features,
)
from keypointfusion_torch.ops.pairwise import pairwise_sqdist


def fold_conv_bn(conv: nn.Module, bn: nn.Module):
    """conv [out, in, 1(, 1)] + eval BN -> folded Dense (kernel [in, out],
    bias [out])."""
    kernel = conv.weight.reshape(conv.weight.shape[0], -1).t()
    return fold_bn(kernel, conv.bias, bn.weight, bn.bias, bn.running_mean,
                   bn.running_var, bn.eps)


def dense_group_masks(d2, radius: float, s: int):
    """The dense form's selection for one radius, from d2 [B,J,M].

    Returns (mask [B,J,M] bool: the group's points, the first S in-ball
    ones or an empty ball's closest point, which feed the max; weights
    [B,J,M]: how many of the gather form's S slots each point fills,
    summing to S per (b, j)). The gather form fills a short group's slots
    by repeating slot 0, so the first in-ball point counts 1 + (S - k)
    when the ball holds k < S points, and an empty ball's closest point S
    (the lowest index among equals)."""
    in_ball = d2 < radius * radius
    rank_in = exclusive_rank(in_ball)
    sel_in = in_ball & (rank_in < s)
    k_total = in_ball.sum(-1, keepdim=True)
    n_fill = (s - torch.clamp_max(k_total, s)).float()
    first_in = (in_ball & (rank_in == 0)).float()
    w = sel_in.float() + n_fill * first_in
    empty = k_total == 0
    closest = F.one_hot(torch.argmin(d2, -1), d2.shape[-1]).bool()
    w = torch.where(empty, float(s) * closest.float(), w)
    mask = sel_in | (empty & closest)
    return mask, w


class DESA(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, in_channel: int = 128, mlp: Sequence[int] = (128, 128),
                 num_samples: Sequence[int] = (64, 64, 64),
                 radius: Sequence[float] = (0.1, 0.2, 0.4),
                 dense_train: bool = False):
        super().__init__()
        if len(mlp) != 2:
            raise NotImplementedError('DESA is ported for a 2-layer MLP')
        self.dense_train = dense_train
        self.num_samples = tuple(num_samples)
        self.radius = tuple(radius)
        scales = range(len(radius))
        self.conv_l0_blocks = nn.ModuleList(
            nn.Conv2d(3, mlp[0], 1) for _ in scales)
        self.bn_l0_blocks = nn.ModuleList(
            nn.BatchNorm2d(mlp[0]) for _ in scales)
        self.conv_f0_blocks = nn.ModuleList(
            nn.Conv2d(in_channel, mlp[0], 1) for _ in scales)
        self.bn_f0_blocks = nn.ModuleList(
            nn.BatchNorm2d(mlp[0]) for _ in scales)
        self.conv_blocks = nn.ModuleList(
            nn.ModuleList([nn.Conv2d(mlp[0], mlp[1], 1)]) for _ in scales)
        self.bn_blocks = nn.ModuleList(
            nn.ModuleList([nn.BatchNorm2d(mlp[1])]) for _ in scales)
        self.fusion = nn.Sequential(
            nn.Conv1d(mlp[-1] * len(radius) + in_channel, in_channel, 1),
            nn.BatchNorm1d(in_channel))
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                init_conv(m)

    def folded_weights(self) -> DesaWeights:
        """Every BatchNorm folded into its conv, stacked over the radii."""
        wl, bl = zip(*(fold_conv_bn(c, b) for c, b in
                       zip(self.conv_l0_blocks, self.bn_l0_blocks)))
        wf, bf = zip(*(fold_conv_bn(c, b) for c, b in
                       zip(self.conv_f0_blocks, self.bn_f0_blocks)))
        w2, b2 = zip(*(fold_conv_bn(c[0], b[0]) for c, b in
                       zip(self.conv_blocks, self.bn_blocks)))
        wfu, bfu = fold_conv_bn(self.fusion[0], self.fusion[1])
        stack = lambda ts: torch.stack(ts).contiguous()
        return DesaWeights(
            wf=stack(wf), wl=stack(wl),
            b1=stack([x + y for x, y in zip(bl, bf)]), w2=stack(w2),
            b2=stack(b2), wfu=wfu.contiguous(), bfu=bfu.contiguous())

    def kernel_weights(self, pack: Optional[str] = None):
        """folded_weights(), or with `pack` its pack for that K1 mode
        (kernels/desa_dense.py: 'highest' -> highest_weights, 'default' ->
        serving_weights). Under no_grad or inference_mode each is kept on
        the module, outside its state_dict, and made again when a
        parameter or buffer is replaced or written in place (.to(),
        load_state_dict, a running statistic): the key is each tensor's
        (data_ptr, _version, shape), as models/layers.py:cast_param keys
        its casts."""
        make = {None: lambda w: w, 'highest': highest_weights,
                'default': serving_weights}[pack]
        if torch.is_grad_enabled():
            return make(self.folded_weights())
        tensors = [*self.parameters(), *self.buffers()]
        stamp = tuple((t.data_ptr(), t._version, t.shape) for t in tensors)
        hit = self.__dict__.get('_kernel_weights')
        if hit is None or hit['stamp'] != stamp:
            # the entry holds the tensors, so no other can take their
            # addresses
            hit = self.__dict__['_kernel_weights'] = {
                'stamp': stamp, 'tensors': tensors,
                None: self.folded_weights()}
        if pack not in hit:
            hit[pack] = make(hit[None])
        return hit[pack]

    def _dense(self, conv: nn.Module, x):
        """conv (1x1) as a Dense over the last axis, in the compute dtype
        (flax Dense with dtype=...)."""
        dt = self.compute_dtype
        w = conv.weight.reshape(conv.weight.shape[0], -1)
        return linear(x, w.to(dt), conv.bias.to(dt), dt)

    def _bn(self, bn: nn.Module, y, weights=None):
        """bn in train mode over every axis but the last, in its
        parameters' dtype (float32), in the compute dtype out
        (TorchBatchNorm with dtype=...); weighted statistics when
        `weights` is given; over every rank's rows inside
        models/norm.py:global_batch_statistics."""
        group = sync_group(bn)
        if group is not None:
            return global_batch_norm(y, bn, group, weights).to(
                self.compute_dtype)
        if weights is not None:
            return weighted_batch_norm(y, weights, bn).to(self.compute_dtype)
        y = y.to(bn.weight.dtype)
        # what nn.BatchNorm2d's forward does in train mode, on [rows, C]:
        # the module takes only 4-D inputs, and cuDNN's kernels for a
        # [rows, C, 1, 1] view took 160 ms of a 255 ms step on the H100
        bn.num_batches_tracked.add_(1)
        out = F.batch_norm(y.reshape(-1, y.shape[-1]), bn.running_mean,
                           bn.running_var, bn.weight, bn.bias, True,
                           bn.momentum, bn.eps)
        return out.reshape(y.shape).to(self.compute_dtype)

    def _dense_bn(self, conv: nn.Module, bn: nn.Module, x):
        return self._bn(bn, self._dense(conv, x))

    def _gather_scale(self, i, r, s, d2, support_xyz, support_feat,
                      node_xyz, node_feat):
        """One radius of the gather form: ([B,J,S,C] rows of the group's
        slots, the max's mask [B,J,S])."""
        idx, valid, rel_xyz = ball_query_group(support_xyz, node_xyz, r, s,
                                               d2=d2)
        grouped = group_features(support_feat, idx)
        loc = self._dense_bn(self.conv_l0_blocks[i], self.bn_l0_blocks[i],
                             rel_xyz / r)
        feat = self._dense_bn(self.conv_f0_blocks[i], self.bn_f0_blocks[i],
                              grouped - node_feat[:, :, None])
        h = torch.relu(loc + feat)
        h = torch.relu(self._dense_bn(self.conv_blocks[i][0],
                                      self.bn_blocks[i][0], h))
        return h, valid

    def _dense_scale(self, i, r, s, d2, support_xyz, support_feat,
                     node_xyz, node_feat):
        """One radius of the dense train form: ([B,J,M,C] rows of every
        support point, the max's mask [B,J,M])."""
        mask, bn_w = dense_group_masks(d2, r, s)
        conv_l, conv_f = self.conv_l0_blocks[i], self.conv_f0_blocks[i]
        zl = self._dense(conv_l, torch.zeros_like(node_xyz[:, :1]))
        ls = self._dense(conv_l, support_xyz)                  # [B,M,C]
        ln = self._dense(conv_l, node_xyz)                     # [B,J,C]
        loc = (ls[:, None] - ln[:, :, None]) / r + zl[:, :, None]
        zf = self._dense(conv_f, torch.zeros_like(node_feat[:, :1]))
        fs = self._dense(conv_f, support_feat)
        fn = self._dense(conv_f, node_feat)
        feat = fs[:, None] - fn[:, :, None] + zf[:, :, None]
        h = torch.relu(self._bn(self.bn_l0_blocks[i], loc, bn_w)
                       + self._bn(self.bn_f0_blocks[i], feat, bn_w))
        h = self._dense(self.conv_blocks[i][0], h)
        h = torch.relu(self._bn(self.bn_blocks[i][0], h, bn_w))
        return h, mask

    def _train_forward(self, pcl_feat, node_feat, pcl_xyz, node_xyz):
        dt = self.compute_dtype
        support_xyz = torch.cat([pcl_xyz, node_xyz], dim=1).float()
        support_feat = torch.cat([pcl_feat, node_feat], dim=1).to(dt)
        node_feat = node_feat.to(dt)
        node_xyz = node_xyz.float()
        d2 = pairwise_sqdist(node_xyz, support_xyz)
        outs = []
        for i, (r, s) in enumerate(zip(self.radius, self.num_samples)):
            scale = self._dense_scale if self.dense_train \
                else self._gather_scale
            h, valid = scale(i, r, s, d2, support_xyz, support_feat,
                             node_xyz, node_feat)
            outs.append(h.masked_fill(~valid[..., None],
                                      float('-inf')).amax(dim=2))
        outs.append(node_feat)
        fused = self._dense_bn(self.fusion[0], self.fusion[1],
                               torch.cat(outs, dim=-1))
        return torch.relu(fused)

    def forward(self, pcl_feat, node_feat, pcl_xyz, node_xyz,
                use_kernel: bool = True):
        """pcl_feat [B,N,C], node_feat [B,J,C], pcl_xyz [B,N,3],
        node_xyz [B,J,3] -> [B,J,C]. use_kernel=False runs the plain
        version on any device; train mode runs the gather form, or the
        dense form with dense_train."""
        if self.training:
            return self._train_forward(pcl_feat, node_feat, pcl_xyz,
                                       node_xyz)
        dt = self.compute_dtype
        mode = 'highest' if dt == torch.float32 else 'default'
        fn = desa_dense if use_kernel else desa_dense_plain
        w = self.kernel_weights(mode)
        return fn(pcl_feat.to(dt).contiguous(), node_feat.to(dt).contiguous(),
                  pcl_xyz.float().contiguous(), node_xyz.float().contiguous(),
                  w, self.radius, self.num_samples, mode).to(dt)


def set_dense_train(module: nn.Module, on: bool = True) -> nn.Module:
    """Set `dense_train` on every DESA in `module` (a KPFusion, a fusion
    block): train mode then runs DESA's dense form, or its gather form."""
    for m in module.modules():
        if isinstance(m, DESA):
            m.dense_train = on
    return module
