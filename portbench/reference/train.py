"""Plain float32 train step of KPFusion for the benchmark's reference: the
KPFusion reference's losses ('weight_offset' dense maps, smooth-L1 with a
0.01 knee, stage weights, spatial-weight supervision) and AdamW written
out. Imports nothing of the program under test."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import geometry as G


def smooth_l1(x, y):
    z = x - y
    az = z.abs()
    return torch.where(az < 0.01, 0.5 * z * z, 0.01 * (az - 0.005)).mean(
        -1).mean()


def loss(results, sws, depth, uvd_gt, xyz_gt, kernel: float = 0.8,
         stage_type=(1, 1, 2, 3, 2, 3), coord_weight: float = 100.0,
         deconv_weight: float = 1.0, spatial_weight=(10.0, 10.0, 10.0)):
    """The total loss at epoch 0 (spatial supervision on)."""
    fs = results[0].shape[1]
    j = uvd_gt.shape[1]
    total = 0.0
    target = None
    for i, stage in enumerate(stage_type):
        if stage == 1:
            if target is None:
                target = G.joint_to_offset(uvd_gt, depth, kernel, fs)
            joint = G.offset_to_joint(results[i], depth, kernel)
            total = total + smooth_l1(results[i][..., :4 * j], target) \
                * deconv_weight
            total = total + smooth_l1(joint, uvd_gt) * coord_weight
        elif stage in (2, 3):
            total = total + smooth_l1(results[i], xyz_gt) * coord_weight
    for i, sw in enumerate(sws):
        hm = G.joint_heatmap(uvd_gt[..., :2], kernel, fs,
                             3.0 if i == 0 else 2.0)
        total = total + smooth_l1(sw, hm / torch.max(hm)) * spatial_weight[i]
    return total


class AdamW:
    """torch.optim.AdamW's update, written out: decoupled weight decay,
    bias-corrected moments, eps added to the corrected root."""

    def __init__(self, params, lr=8e-4, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.01):
        self.params = list(params)
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.state: Dict[int, dict] = {}

    @torch.no_grad()
    def step(self):
        b1, b2 = self.betas
        for i, p in enumerate(self.params):
            if p.grad is None:
                continue
            s = self.state.setdefault(i, {'t': 0,
                                          'm': torch.zeros_like(p),
                                          'v': torch.zeros_like(p)})
            s['t'] += 1
            t, g = s['t'], p.grad
            p.mul_(1.0 - self.lr * self.wd)
            s['m'].mul_(b1).add_(g, alpha=1.0 - b1)
            s['v'].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (s['v'].sqrt() / (1.0 - b2 ** t) ** 0.5).add_(self.eps)
            p.addcdiv_(s['m'], denom, value=-self.lr / (1.0 - b1 ** t))


def train(model, batches: List[dict], gen: torch.Generator,
          kernel: float = 0.8, lr: float = 8e-4, hook=None):
    """One step per batch of `batches` (dicts of the train batch's
    tensors) on `model` in train mode, dropout from `gen`. Returns
    (losses [float], the first step's gradients by parameter name).
    `hook(i, model)`, if given, runs after step i."""
    model.train()
    named = list(model.named_parameters())
    opt = AdamW([p for _, p in named], lr=lr)
    losses, first = [], None
    for i, batch in enumerate(batches):
        fr = G.Frame.make(batch['cam_para'], batch['center'], batch['M'],
                          batch['cube'], batch['depth'].shape[1])
        for _, p in named:
            p.grad = None
        results, sws = model(batch['rgb'], batch['depth'], batch['pcl'], fr,
                             kernel, gen)
        total = loss(results, sws, batch['depth'], batch['uvd_gt'],
                     batch['xyz_gt'], kernel)
        total.backward()
        if first is None:
            first = {n: p.grad.detach().clone() for n, p in named
                     if p.grad is not None}
        opt.step()
        losses.append(float(total.detach()))
        if hook is not None:
            hook(i, model)
    return losses, first
