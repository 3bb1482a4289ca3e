"""What the runs of portbench/kinds/ share: a configuration's plain
reference and the reference model with a run's weights, the TF32 switch
of the control, the work the per-layer readers divide by, and the gap of
two sets of norms."""

from __future__ import annotations

import os
import statistics
from typing import Dict

import torch

from portbench import work
from portbench.harness import ROOT, load_file


def reference(config: dict, root: str = ROOT):
    """The module of a configuration's plain reference: the file in
    portbench/reference/ of the checkout at `root` that its `reference`
    key names, model.py without the key, loaded by path. It defines
    `KPFusion` and `pack` (see reference/model.py). A run resolves it
    once and hands its `KPFusion` to the functions below."""
    name = config.get('reference', 'model.py')
    stem, ext = os.path.splitext(name)
    if os.path.basename(name) != name or ext != '.py':
        raise ValueError(f'reference {name!r}: not a .py file name')
    return load_file('reference', stem, root)


def work_info(kpfusion, config: dict, points: int, batch: int,
              k1_calls) -> dict:
    """What the rooflines and mfu readers divide by: the configuration's
    FLOPs a unit of `batch` frames through its reference `kpfusion`, each
    K1 launch's bound (from the points of each DESA call, in launch
    order) and one K2 launch's bound (32x32 maps of 2 x 128 features and
    J weights)."""
    joints = config['joint_num']
    nbytes, flops = work.k2_work(batch, points, 32 * 32, 2 * 128 + joints)
    return {
        'flops_per_unit': work.model_flops(kpfusion, config, points=points)
        * batch,
        'k1_bounds': [work.bound_s(*work.k1_work(
            p, n, 128, (0.1, 0.2, 0.4), (64, 64, 64))) for p, n in k1_calls],
        'k2_bound': work.bound_s(nbytes, fp32_flops=flops)}


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == 'cuda':
        torch.cuda.synchronize()


def release(device: torch.device) -> None:
    """Return the caching allocator's free blocks to the card."""
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def reference_model(kpfusion, config: dict, state: dict, device,
                    dropout: float = 0.1):
    """The configuration's plain reference `kpfusion` with the run's
    weights, on `device`."""
    with torch.device('meta'):
        model = kpfusion(config['net'], config['joint_num'], rate=dropout)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model


class Tf32:
    """Within the block, float32 products and convolutions run in TF32
    (True) or in float32 (False); the flags are restored after."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             keep=None) -> float:
    """The widest gap between the norms of two sets of leaves, each
    against the larger of the reference leaf's norm and the median
    reference leaf's: max |‖got‖ - ‖want‖| / max(‖want‖, median). `keep`
    names the leaves compared (all of `want` by default); a leaf missing
    from `got` reads as norm 0."""
    names = [n for n in want if keep is None or n in keep]
    norms = {n: float(want[n].double().norm()) for n in names}
    median = statistics.median(norms.values())
    gap = 0.0
    for n in names:
        g = float(got[n].double().norm()) if n in got else 0.0
        gap = max(gap, abs(g - norms[n]) / max(norms[n], median))
    return gap


def median_gap(got: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor]) -> float:
    """The gap of the median leaf: |median ‖got‖ - median ‖want‖| over
    median ‖want‖, a steadier reading than the worst leaf's."""
    g = statistics.median(float(got[n].double().norm()) for n in want)
    w = statistics.median(float(want[n].double().norm()) for n in want)
    return abs(g - w) / w
