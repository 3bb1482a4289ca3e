"""Seeded weights for a configuration, made on the device in a few large
calls, in float32 (the type the cells serve and train in).

Every floating tensor of the reference model's state_dict gets one slice
of a single normal draw, shifted and scaled by its role, so that random
weights give activations of order one through the whole depth:
  * 2-D and larger weights: normal(0, 1/fan_in), fan_in = numel / rows,
    but the output heads at the scales the KPFusion reference initialises
    them with (the dense maps' 1x1 convs and the spatial pooling 0.001,
    the keypoint heads 0.02), so that the joints start on the hand;
  * norm scales and layer scales (1-D `weight`, `gamma`): 1 + 0.1 z;
  * biases and running means: 0.05 z and 0.1 z;
  * running variances: exp(0.2 z);
  * `weight_dis` (a block's gate mix): 0.5 z.
Batch counters start at 0. The same state_dict loads into the program
and into the configuration's reference (shared.reference), whose names
and order it follows."""

from __future__ import annotations

from typing import Dict

import torch


def _role(name: str, shape) -> tuple:
    """(mean, std, exp) of the tensor's draw."""
    leaf = name.rsplit('.', 1)[-1]
    if leaf == 'running_var':
        return 0.0, 0.2, True
    if leaf == 'running_mean':
        return 0.0, 0.1, False
    if leaf == 'weight_dis':
        return 0.0, 0.5, False
    if len(shape) >= 2:
        if '.finals.' in name or 'fc_spatial2joint' in name:
            return 0.0, 0.001, False
        if '.cls_head.' in name or '.residual.' in name:
            return 0.0, 0.02, False
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return 0.0, fan_in ** -0.5, False
    if leaf in ('weight', 'gamma'):
        return 1.0, 0.1, False
    return 0.0, 0.05, False


def state_dict(kpfusion, config: dict, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """The configuration's weights for `seed`, on `device`, in the names
    and order of its reference `kpfusion`."""
    with torch.device('meta'):
        shapes = {k: (v.shape, v.dtype) for k, v in kpfusion(
            config['net'], config['joint_num']).state_dict().items()}
    drawn = [(k, s) for k, (s, dt) in shapes.items() if dt.is_floating_point]
    roles = [_role(k, s) for k, s in drawn]
    sizes = [s.numel() for _, s in drawn]
    total = sum(sizes)
    count = torch.tensor(sizes, device=device)
    mean, std, exp = (torch.repeat_interleave(
        torch.tensor(col, dtype=dt, device=device), count, output_size=total)
        for col, dt in zip(zip(*roles), (torch.float32, torch.float32,
                                         torch.bool)))
    # meta tensors (the tests' shape checks) draw nothing: a host generator
    gen = torch.Generator(device=device if torch.device(device).type != 'meta'
                          else 'cpu')
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device) * std + mean
    flat = torch.where(exp, torch.exp(flat), flat)
    out = {k: t.view(s) for (k, s), t in zip(drawn, flat.split(sizes))}
    for k, (s, dt) in shapes.items():
        if k not in out:
            out[k] = torch.zeros(s, dtype=dt, device=device)
    return {k: out[k] for k in shapes}
