"""Plain float32 KPFusion for the benchmark's reference: the dual-backbone
RGB-D model of the KPFusion paper (AAAI 2024), with ResNet (arXiv
1512.03385) or ConvNeXt (arXiv 2201.03545) UNet backbones and two KFAM
fusion blocks. Imports nothing of the program under test.

Parameter and buffer names are the KPFusion reference checkpoint's, so
one state_dict serves this model and the program alike. Plain torch
layers only: BatchNorm runs in eval with its running statistics and in
train with the batch's (updating them), DESA gathers each joint's ball
groups and max-pools them in both modes (no folded weights, no kernels),
the pixel sampler sorts the full distance matrix. Dropout draws its masks
from the generator passed to forward, in a fixed order: per fusion block,
the first keypoint encoder, the cross decoder's last layer, the second
keypoint encoder; inside each, in the order the layers run.

Builds every backbone the port lists: KPFusion-resnet-18 (BasicBlock),
-50, -101 and -152 (Bottleneck, expansion 4), and KPFusion-convnext-T, -S,
-B and -L. A configuration may bring a reference file of its own
(`reference` in its file, loaded by portbench/shared.py:reference); it
defines `KPFusion` and `pack` with this module's constructor, forward,
results and state_dict names.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import geometry as G

# blocks a stage; 50 and deeper take the Bottleneck (expansion 4)
RESNET = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
          152: (3, 8, 36, 3)}
# (depths, widths) a stage
CONVNEXT = {'T': ((3, 3, 9, 3), (96, 192, 384, 768)),
            'S': ((3, 3, 27, 3), (96, 192, 384, 768)),
            'B': ((3, 3, 27, 3), (128, 256, 512, 1024)),
            'L': ((3, 3, 27, 3), (192, 384, 768, 1536))}


def bn(x, m: nn.modules.batchnorm._BatchNorm, channel_last: bool = False):
    """torch's BatchNorm of m on x ([N,C,...], or [..., C] when
    channel_last): batch statistics and a running update in train mode,
    the running statistics in eval."""
    if channel_last:
        shape = x.shape
        return bn(x.reshape(-1, shape[-1]), m).reshape(shape)
    if m.training:
        m.num_batches_tracked.add_(1)
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                        m.training, m.momentum, m.eps)


def up2(x):
    """2x bilinear upsample, half-pixel centres, rows then columns."""
    y = F.interpolate(x, scale_factor=(2, 1), mode='bilinear',
                      align_corners=False)
    return F.interpolate(y, scale_factor=(1, 2), mode='bilinear',
                         align_corners=False)


def dropout(x, rate, training, gen, shape=None):
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape if shape is None else shape, generator=gen,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# ---------------------------------------------------------------- backbones

class _Conv(nn.Module):
    def __init__(self, i, o, k):
        super().__init__()
        self.conv = nn.Conv2d(i, o, k, 1, (k - 1) // 2)


class Residual(nn.Module):
    """Pre-activation bottleneck residual of the hourglass decoder."""

    def __init__(self, i, o):
        super().__init__()
        h = o // 2
        self.bn1, self.conv1 = nn.BatchNorm2d(i), _Conv(i, h, 1)
        self.bn2, self.conv2 = nn.BatchNorm2d(h), _Conv(h, h, 3)
        self.bn3, self.conv3 = nn.BatchNorm2d(h), _Conv(h, o, 1)
        self.skip_layer = _Conv(i, o, 1) if i != o else None

    def forward(self, x):
        y = self.conv1.conv(torch.relu(bn(x, self.bn1)))
        y = self.conv2.conv(torch.relu(bn(y, self.bn2)))
        y = self.conv3.conv(torch.relu(bn(y, self.bn3)))
        return y + (x if self.skip_layer is None else self.skip_layer.conv(x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, i, o, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(i, o, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(o)
        self.conv2 = nn.Conv2d(o, o, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(o)
        self.downsample = nn.Sequential(
            nn.Conv2d(i, o, 1, stride, bias=False), nn.BatchNorm2d(o)) \
            if stride != 1 or i != o else None

    def forward(self, x):
        y = torch.relu(bn(self.conv1(x), self.bn1))
        y = bn(self.conv2(y), self.bn2)
        r = x if self.downsample is None else bn(self.downsample[0](x),
                                                 self.downsample[1])
        return torch.relu(y + r)


class Bottleneck(nn.Module):
    """1x1 down to o, 3x3 at the stride, 1x1 up to 4o (torchvision's
    v1.5)."""
    expansion = 4

    def __init__(self, i, o, stride):
        super().__init__()
        e = o * self.expansion
        self.conv1 = nn.Conv2d(i, o, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(o)
        self.conv2 = nn.Conv2d(o, o, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(o)
        self.conv3 = nn.Conv2d(o, e, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(e)
        self.downsample = nn.Sequential(
            nn.Conv2d(i, e, 1, stride, bias=False), nn.BatchNorm2d(e)) \
            if stride != 1 or i != e else None

    def forward(self, x):
        y = torch.relu(bn(self.conv1(x), self.bn1))
        y = torch.relu(bn(self.conv2(y), self.bn2))
        y = bn(self.conv3(y), self.bn3)
        r = x if self.downsample is None else bn(self.downsample[0](x),
                                                 self.downsample[1])
        return torch.relu(y + r)


class ResNet(nn.Module):
    def __init__(self, depth, cin):
        super().__init__()
        block = BasicBlock if depth < 50 else Bottleneck
        self.expansion = block.expansion
        self.conv1 = nn.Conv2d(cin, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        i = 64
        for s, (o, n) in enumerate(zip((64, 128, 256, 512), RESNET[depth])):
            blocks = []
            for k in range(n):
                blocks.append(block(i, o, 2 if s > 0 and k == 0 else 1))
                i = o * block.expansion
            setattr(self, f'layer{s + 1}', nn.Sequential(*blocks))

    def forward(self, x):
        x = F.max_pool2d(torch.relu(bn(self.conv1(x), self.bn1)), 3, 2, 1)
        c1 = self.layer1(x)
        c2 = self.layer2(c1)
        c3 = self.layer3(c2)
        return c1, c2, c3, self.layer4(c3)


class LayerNorm2d(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape,
                            self.weight, self.bias,
                            self.eps).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.dwconv = nn.Conv2d(d, d, 7, padding=3, groups=d)
        self.norm = nn.LayerNorm(d, eps=1e-6)
        self.pwconv1 = nn.Linear(d, 4 * d)
        self.pwconv2 = nn.Linear(4 * d, d)
        self.gamma = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        y = self.gamma * self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    def __init__(self, size, cin):
        super().__init__()
        depths, d = CONVNEXT[size]
        layers = [nn.Sequential(nn.Conv2d(cin, d[0], 4, 4),
                                LayerNorm2d(d[0], eps=1e-6))]
        layers += [nn.Sequential(LayerNorm2d(d[i - 1], eps=1e-6),
                                 nn.Conv2d(d[i - 1], d[i], 2, 2))
                   for i in range(1, 4)]
        self.downsample_layers = nn.ModuleList(layers)
        self.stages = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(d[i]) for _ in range(depths[i]))
            for i in range(4))

    def forward(self, x):
        out = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = down(x)
            for block in stage:
                x = block(x)
            out.append(x)
        return tuple(out)


class UNet(nn.Module):
    """Encoder + residual-skip decoder: NHWC [B,S,S,Cin] -> (dense map
    [B,S/4,S/4,5J], features [B,S/4,S/4,dim])."""

    def __init__(self, net: str, cin: int, dim: int = 128, j: int = 21):
        super().__init__()
        kind, size = net.split('-')[-2:]
        # d: the decoder's widths; enc: the encoder's, its skip inputs
        if kind == 'convnext':
            self.backbone = ConvNeXt(size, cin)
            d = enc = CONVNEXT[size][1]
        else:
            self.backbone = ResNet(int(size), cin)
            d = (64, 128, 256, 512)
            enc = tuple(w * self.backbone.expansion for w in d)
        self.convnext = kind == 'convnext'
        self.up4 = nn.Sequential(Residual(enc[3], d[3]))
        self.skip_layer4 = Residual(enc[2], d[2])
        self.fusion_layer4 = Residual(d[3] + d[2], d[2])
        self.up3 = nn.Sequential(Residual(d[2], d[2]))
        self.skip_layer3 = Residual(enc[1], d[1])
        self.fusion_layer3 = Residual(d[2] + d[1], d[1])
        self.up2 = nn.Sequential(Residual(d[1], d[1]))
        self.skip_layer2 = Residual(enc[0], d[0])
        self.fusion_layer2 = Residual(d[1] + d[0], dim)
        if self.convnext:
            self.result_emb = Residual(dim, dim)
        self.finals = nn.ModuleList(nn.Conv2d(dim, o, 1)
                                    for o in (3 * j, j, j))

    def forward(self, x):
        c1, c2, c3, c4 = self.backbone(x.permute(0, 3, 1, 2))
        x = self.fusion_layer4(torch.cat(
            [up2(self.up4(c4)), self.skip_layer4(c3)], 1))
        x = self.fusion_layer3(torch.cat(
            [up2(self.up3(x)), self.skip_layer3(c2)], 1))
        feat = self.fusion_layer2(torch.cat(
            [up2(self.up2(x)), self.skip_layer2(c1)], 1))
        if self.convnext:
            feat = self.result_emb(feat)
        dense = torch.cat([f(feat) for f in self.finals], 1)
        return (dense.permute(0, 2, 3, 1).contiguous(),
                feat.permute(0, 2, 3, 1).contiguous())


# ------------------------------------------------------------ fusion head

class EmbedBN(nn.Sequential):
    """Conv1d(k=1) + BatchNorm1d on tokens [B,N,Cin] -> [B,N,dim]."""

    def __init__(self, i, o):
        super().__init__(nn.Conv1d(i, o, 1), nn.BatchNorm1d(o))

    def forward(self, x):
        return bn(F.linear(x, self[0].weight[..., 0], self[0].bias), self[1],
                  channel_last=True)


def attention(q, k, v, heads, rate, training, gen):
    b, lq, c = q.shape
    lk, d = k.shape[1], c // heads
    q = q.reshape(b, lq, heads, d).transpose(1, 2) / math.sqrt(d)
    k = k.reshape(b, lk, heads, d).transpose(1, 2)
    v = v.reshape(b, lk, heads, d).transpose(1, 2)
    w = torch.softmax(q @ k.transpose(-1, -2), -1)
    w = dropout(w, rate, training, gen, (1, 1, lq, lk))
    return (w @ v).transpose(1, 2).reshape(b, lq, c)


class _DenseLN(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.dense = nn.Linear(i, o)
        self.LayerNorm = nn.LayerNorm(o, eps=1e-12)


class PostLNLayer(nn.Module):
    def __init__(self, hidden=128, heads=4, inter=16, rate=0.1):
        super().__init__()
        self.heads, self.rate = heads, rate
        self.attention = nn.Module()
        self.attention.self = nn.Module()
        for n in ('query', 'key', 'value'):
            setattr(self.attention.self, n, nn.Linear(hidden, hidden))
        self.attention.output = _DenseLN(hidden, hidden)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(hidden, inter)
        self.output = _DenseLN(inter, hidden)

    def forward(self, x, gen):
        s, o = self.attention.self, self.attention.output
        a = attention(s.query(x), s.key(x), s.value(x), self.heads,
                      self.rate, self.training, gen)
        x = o.LayerNorm(x + dropout(o.dense(a), self.rate, self.training,
                                    gen))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + dropout(
            self.output.dense(h), self.rate, self.training, gen))


class KPInteraction(nn.Module):
    """BERT-style post-LN encoder over the joints + a linear head with a
    residual from the raw input: (sequence, prediction [B,J,3])."""

    def __init__(self, hidden=128, img_dim=128, rate=0.1):
        super().__init__()
        self.rate = rate
        self.bert = nn.Module()
        self.bert.position_embeddings = nn.Embedding(512, hidden)
        self.bert.img_embedding = nn.Linear(img_dim, hidden)
        self.bert.encoder = nn.Module()
        self.bert.encoder.layer = nn.ModuleList(
            PostLNLayer(hidden, rate=rate) for _ in range(4))
        self.cls_head = nn.Linear(hidden, 3)
        self.residual = nn.Linear(img_dim, 3)

    def forward(self, x_in, gen):
        b = self.bert
        x = b.img_embedding(x_in) \
            + b.position_embeddings.weight[None, :x_in.shape[1]]
        x = dropout(x, self.rate, self.training, gen)
        for layer in b.encoder.layer:
            x = layer(x, gen)
        return x, self.cls_head(x) + self.residual(x_in)


class CrossDecoderLayer(nn.Module):
    def __init__(self, hidden=128, heads=4, ffn=128, j=21, rate=0.1):
        super().__init__()
        self.heads, self.rate = heads, rate
        self.self_posembed = nn.Embedding(j, hidden)
        self.cross_posembed = nn.Embedding(j, hidden)
        self.multihead_attn = nn.Module()
        self.multihead_attn.in_proj_weight = nn.Parameter(
            torch.zeros(3 * hidden, hidden))
        self.multihead_attn.in_proj_bias = nn.Parameter(
            torch.zeros(3 * hidden))
        self.multihead_attn.out_proj = nn.Linear(hidden, hidden)
        self.norm2 = nn.LayerNorm(hidden, eps=1e-6)
        self.norm3 = nn.LayerNorm(hidden, eps=1e-6)
        self.linear1 = nn.Linear(hidden, ffn)
        self.linear2 = nn.Linear(ffn, hidden)

    def forward(self, query, key, gen):
        j = query.shape[1]
        drop = lambda t: dropout(t, self.rate, self.training, gen)
        q = query + self.self_posembed.weight[None, :j]
        kv = key + self.cross_posembed.weight[None, :j]
        m = self.multihead_attn
        wq, wk, wv = m.in_proj_weight.chunk(3)
        bq, bk, bv = m.in_proj_bias.chunk(3)
        a = m.out_proj(attention(F.linear(q, wq, bq), F.linear(kv, wk, bk),
                                 F.linear(kv, wv, bv), self.heads, self.rate,
                                 self.training, gen))
        x = self.norm2(query + drop(a))
        return self.norm3(x + drop(self.linear2(drop(torch.relu(
            self.linear1(x))))))


class DESA(nn.Module):
    """Per radius: the joint's ball group of support points (the cloud,
    then the joints), a shared MLP on [feature - joint's feature,
    (xyz - joint's xyz) / r] with BatchNorm, max over the group; then a
    fusion layer over the radii's maxima and the joint's feature."""

    def __init__(self, c=128, samples=(64, 64, 64), radius=(0.1, 0.2, 0.4)):
        super().__init__()
        self.samples, self.radius = samples, radius
        r = range(len(radius))
        self.conv_l0_blocks = nn.ModuleList(nn.Conv2d(3, c, 1) for _ in r)
        self.bn_l0_blocks = nn.ModuleList(nn.BatchNorm2d(c) for _ in r)
        self.conv_f0_blocks = nn.ModuleList(nn.Conv2d(c, c, 1) for _ in r)
        self.bn_f0_blocks = nn.ModuleList(nn.BatchNorm2d(c) for _ in r)
        self.conv_blocks = nn.ModuleList(
            nn.ModuleList([nn.Conv2d(c, c, 1)]) for _ in r)
        self.bn_blocks = nn.ModuleList(
            nn.ModuleList([nn.BatchNorm2d(c)]) for _ in r)
        self.fusion = nn.Sequential(nn.Conv1d(c * len(radius) + c, c, 1),
                                    nn.BatchNorm1d(c))

    @staticmethod
    def _dense_bn(conv, norm, x):
        y = F.linear(x, conv.weight.reshape(conv.weight.shape[0], -1),
                     conv.bias)
        return bn(y, norm, channel_last=True)

    def forward(self, pcl_feat, node_feat, pcl_xyz, node_xyz):
        sup_xyz = torch.cat([pcl_xyz, node_xyz], 1)
        sup_feat = torch.cat([pcl_feat, node_feat], 1)
        d2 = G.sqdist(node_xyz, sup_xyz)
        outs = []
        for i, (r, s) in enumerate(zip(self.radius, self.samples)):
            idx, valid = G.ball_group(d2, r, s)
            rel = G.gather_rows(sup_xyz, idx) - node_xyz[:, :, None]
            grouped = G.gather_rows(sup_feat, idx) - node_feat[:, :, None]
            h = torch.relu(
                self._dense_bn(self.conv_l0_blocks[i], self.bn_l0_blocks[i],
                               rel / r)
                + self._dense_bn(self.conv_f0_blocks[i],
                                 self.bn_f0_blocks[i], grouped))
            h = torch.relu(self._dense_bn(self.conv_blocks[i][0],
                                          self.bn_blocks[i][0], h))
            outs.append(h.masked_fill(~valid[..., None],
                                      float('-inf')).amax(2))
        outs.append(node_feat)
        return torch.relu(self._dense_bn(self.fusion[0], self.fusion[1],
                                         torch.cat(outs, -1)))


class FusionBlock(nn.Module):
    def __init__(self, j=21, dim=128, fs=32, rate=0.1):
        super().__init__()
        self.pcl_feat_emb = EmbedBN(dim, dim)
        self.pcl_xyz_emb = EmbedBN(3, dim)
        self.pcl_pose_emb = EmbedBN(5 * j, dim)
        self.pcl_feat_emb_RGB = EmbedBN(dim, dim)
        self.joint_feat_emb = EmbedBN(dim, dim)
        self.joint_xyz_emb = EmbedBN(3, dim)
        self.FA = DESA(dim)
        self.init_TR = KPInteraction(dim, dim, rate)
        self.atten_spatial = nn.Conv2d(dim + j, j, 1)
        self.weight_dis = nn.Parameter(torch.zeros(1))
        self.fc_spatial2joint_feature = nn.Linear(fs * fs, 1)
        self.crossTR = nn.Module()
        self.crossTR.decoder = nn.ModuleList(
            CrossDecoderLayer(dim, j=j, rate=rate) for _ in range(4))
        self.final_TR = KPInteraction(dim, dim + 3, rate)

    def forward(self, img_feat, img_feat_rgb, pcl, joint_xyz, sampled, prev,
                fr, img_down, kernel, gen):
        b, h, w, c = img_feat.shape
        joint_xyz = joint_xyz.detach()
        offset = G.pcl_joint_offset(joint_xyz, pcl, kernel).detach()
        f_d, f_rgb = sampled[..., :c], sampled[..., c:2 * c]
        weight = sampled[..., 2 * c:].detach()
        pf = torch.relu(self.pcl_feat_emb(f_d) + self.pcl_xyz_emb(pcl)
                        + self.pcl_pose_emb(torch.cat([weight, offset], -1)))
        pf = torch.relu(pf + self.pcl_feat_emb_RGB(f_rgb))
        jf = torch.softmax(weight.transpose(1, 2), -1) @ pf
        jf = torch.relu(self.joint_feat_emb(jf)
                        + self.joint_xyz_emb(joint_xyz))
        jf = self.FA(pf, jf, pcl, joint_xyz)
        seq, ref3d = self.init_TR(jf, gen)
        hm = G.joint_heatmap(ref3d[..., :2], kernel, h, 1.0)
        gam = G.anchor_closeness(ref3d, img_down, fr)
        att = self.atten_spatial
        sw = torch.sigmoid(F.linear(torch.cat([img_feat_rgb, hm], -1),
                                    att.weight[:, :, 0, 0], att.bias))
        wd = torch.sigmoid(self.weight_dis)
        gate = wd * gam + (1.0 - wd) * sw
        fc = self.fc_spatial2joint_feature
        # per joint: FC over the pixels of relu(gate * feature)
        pooled = (gate.reshape(b, h * w, -1) * fc.weight.t()).transpose(1, 2) \
            @ torch.relu(img_feat_rgb).reshape(b, h * w, c) + fc.bias
        if prev is not None:
            pooled = torch.relu((pooled + prev) / 2.0)
        cross = self.crossTR.decoder[-1](pooled, seq, gen)
        _, ref2d = self.final_TR(torch.cat([ref3d, cross], -1), gen)
        return ref3d, ref2d, pooled, sw


class KPFusion(nn.Module):
    """results (img_offset, img_offset_rgb, b1_3d, b1_2d, b2_3d, b2_2d) and
    the two blocks' spatial weights, for rgb [B,S,S,3], depth [B,S,S,1],
    pcl [B,N,3] and a Frame; `gen` draws dropout in train mode."""

    def __init__(self, net: str, j: int = 21, dim: int = 128,
                 rate: float = 0.1):
        super().__init__()
        self.backbone_d = UNet(net, 1, dim, j)
        self.backbone_rgb = UNet(net, 3, dim, j)
        self.block1 = FusionBlock(j, dim, rate=rate)
        self.block2 = FusionBlock(j, dim, rate=rate)

    def forward(self, rgb, depth, pcl, fr, kernel: float = 0.8,
                gen: Optional[torch.Generator] = None):
        off_d, feat_d = self.backbone_d(depth)
        off_rgb, feat_rgb = self.backbone_rgb(rgb)
        b, h = feat_d.shape[:2]
        j = off_d.shape[-1] // 5
        joint_uvd = G.offset_to_joint(off_d, depth, kernel).detach()
        img_down = G.resize_nearest(depth, h)
        joint_xyz = G.uvd_nl_to_xyz_nl(joint_uvd, fr)
        maps = torch.cat([feat_d, feat_rgb, off_d[..., 4 * j:].detach()], -1)
        img_xyz = G.uvd_nl_to_xyz_nl(G.pixel_uvd(img_down), fr)
        sampled = G.sample_pixels(pcl, img_xyz, maps.reshape(b, h * h, -1))
        results, sws, prev = [off_d, off_rgb], [], None
        for block in (self.block1, self.block2):
            r3, r2, prev, sw = block(feat_d, feat_rgb, pcl, joint_xyz,
                                     sampled, prev, fr, img_down, kernel, gen)
            results += [r3, r2]
            sws.append(sw)
            joint_xyz = r2
        return tuple(results), tuple(sws)


def pack(results, fr):
    """The serving answer of each frame: [B, 2*3J+9] = world-mm joints |
    normalized uvd joints | crop matrix M."""
    xyz = results[-1]
    b = xyz.shape[0]
    world = xyz * fr.cube[:, None] / 2.0 + fr.center[:, None]
    return torch.cat([world.reshape(b, -1),
                      G.xyz_nl_to_uvd_nl(xyz, fr).reshape(b, -1),
                      fr.M.reshape(b, -1)], -1)
