"""Train and eval steps of KPFusion (port of
keypointfusion_tpu/training/train_step.py).

One train step does what the JAX step body does: the train-mode forward
(both backbones and the fusion blocks), compute_losses, the backward, the
optimizer's update times `lr_scale`, and the BatchNorm statistics' update
(in place, by the modules). The model runs on the CUDA card unless
`device='cpu'` is given (utils/device.py). Dropout draws from the
torch.Generator passed to the step, as JAX passes rngs={'dropout': rng};
the generator lives on the model's device.

The optimizers are torch's with optax's numbers (AdamW: betas (0.9,
0.999), eps 1e-8, weight decay 0.01; Adam; SGD with momentum 0.9); every
step sets their learning rate to the schedule's value at the step count,
times lr_scale. compute_dtype 'bfloat16' trains the whole model in
bfloat16 over float32 parameters, as the JAX package's full-bfloat16
state does; 'mixed' only the backbones. optax.flatten, which the JAX
package wraps its optimizer in to shrink XLA's compile, has no
counterpart: torch's updates are elementwise per tensor already. cfg.remat recomputes the forward in the
backward (torch.utils.checkpoint), with the forward's dropout masks and
without a second update of the BatchNorm statistics.

Under a process group (`group`, parallel/mesh.py) each rank runs the step
on its contiguous slice of the global batch, the JAX steps' `mesh=` forms:
  * cfg.sync_batchnorm (the JAX default): every BatchNorm takes the global
    batch's statistics (models/norm.py:global_batch_statistics), as
    GSPMD's reductions give them in the JAX step, and so does the one
    batch-wide term of the loss, the spatial-weight targets' max; each
    rank's loss is its slice's mean and the gradients are averaged over
    the ranks, which with equal slices is the global mean's gradient.
  * per-shard BatchNorm (the JAX package's shard_map step, the
    reference's DataParallel statistics): each rank normalizes with its
    own slice's statistics; the gradients, the new running statistics
    and the metrics are averaged over the ranks (JAX's pmean).
The gradients are averaged by explicit all-reduces after the backward,
one flat buffer per dtype. DistributedDataParallel is not used: its
broadcast_buffers would overwrite every rank's statistics with rank 0's
where JAX averages them, and it raises on the parameters a stage
configuration leaves without gradient. Each rank passes its own dropout
generator (the trainer derives it from the seed, the epoch and the rank,
as JAX folds the axis index into the key), so the ranks draw independent
masks. The metrics are the global batch's in both forms. The eval step
returns every rank's results gathered in row order.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from keypointfusion_torch.config import Config
from keypointfusion_torch.geometry.camera import CropFrame
from keypointfusion_torch.models.kpfusion import KPFusion, build_kpfusion
from keypointfusion_torch.models.norm import global_batch_statistics
from keypointfusion_torch.parallel.mesh import (
    all_gather_rows, all_mean, world_size,
)
from keypointfusion_torch.training.losses import compute_losses
from keypointfusion_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics, updated in
    place), its optimizer, the learning-rate schedule by step, the step
    count and the learning-rate multiplier of scheduler='auto' (the
    update is linear in the learning rate for every optimizer here, so
    scaling it scales the update, as JAX scales its updates)."""
    model: KPFusion
    optimizer: torch.optim.Optimizer
    schedule: LrSchedule
    step: int = 0
    lr_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class LrSchedule:
    """step -> learning rate. 'step': lr times step_gamma every step_size
    epochs of steps_per_epoch steps; 'constant' and 'auto' are flat
    (`stepped` False; 'auto' decays through TrainState.lr_scale). Plain
    numbers, so a checkpoint carries it as it was."""
    lr: float
    step_gamma: float = 1.0
    step_size: int = 1
    steps_per_epoch: int = 1
    stepped: bool = False

    def __call__(self, step: int) -> float:
        if not self.stepped:
            return self.lr
        epoch = step // max(self.steps_per_epoch, 1)
        return self.lr * (self.step_gamma ** (epoch // self.step_size))


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> LrSchedule:
    """The schedule of cfg.scheduler ('step', 'constant' or 'auto')."""
    if cfg.scheduler not in ('step', 'constant', 'auto'):
        raise ValueError(f'unknown scheduler {cfg.scheduler!r}')
    return LrSchedule(cfg.lr, cfg.step_gamma, cfg.step_size,
                      steps_per_epoch, cfg.scheduler == 'step')


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int = 1000):
    """(optimizer, schedule) for cfg.opt and cfg.scheduler."""
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    params = list(params)
    if cfg.opt == 'adamw':
        opt = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.01)
    elif cfg.opt == 'adam':
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                               eps=1e-8)
    elif cfg.opt == 'sgd':
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=0.9)
    else:
        raise ValueError(f'unknown optimizer {cfg.opt!r}')
    return opt, schedule


def apply_gradients(state: TrainState) -> None:
    """One optimizer update from the parameters' .grad, at the schedule's
    learning rate for state.step times state.lr_scale."""
    lr = state.schedule(state.step) * state.lr_scale
    for group in state.optimizer.param_groups:
        group['lr'] = lr
    state.optimizer.step()


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Batch:
    """A batch of numpy arrays (data/synthetic.py:synthetic_batch's keys)
    as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def frame_from_batch(batch: Batch, cfg: Config) -> CropFrame:
    """The batch's CropFrame, flip +1 for every dataset (NYU's labels are
    converted to that convention when loaded)."""
    return CropFrame.from_batch(batch['cam_para'], batch['center'],
                                batch['M'], batch['cube'], flip=1.0,
                                img_size=cfg.input_size,
                                device=batch['depth'].device)


def create_train_state(cfg: Config, sample_batch: Batch, device=None,
                       seed: int = 0, dropout: float = 0.1,
                       steps_per_epoch: int = 1000) -> TrainState:
    """A KPFusion in train mode with weights drawn from `seed`, on the
    CUDA card unless `device` names another, and its optimizer.
    cfg.compute_dtype: 'float32'; 'mixed' (bfloat16 backbones, float32
    head); or 'bfloat16', the whole model computing in bfloat16 over
    float32 parameters and statistics, as JAX's create_train_state builds
    it. sample_batch is the JAX signature's: torch modules need no sample
    to build, so only its keys are checked."""
    if cfg.compute_dtype not in ('float32', 'mixed', 'bfloat16'):
        raise ValueError(f'unknown compute_dtype {cfg.compute_dtype!r}')
    missing = {'rgb', 'depth', 'pcl', 'uvd_gt', 'xyz_gt', 'cam_para',
               'center', 'M', 'cube'} - set(sample_batch)
    if missing:
        raise ValueError(f'the batch lacks {sorted(missing)}')
    model = build_kpfusion(cfg, device, seed, dropout=dropout).train()
    optimizer, schedule = make_optimizer(cfg, model.parameters(),
                                         steps_per_epoch)
    return TrainState(model, optimizer, schedule)


def _remat_contexts(model: torch.nn.Module,
                    generator: Optional[torch.Generator]):
    """torch.utils.checkpoint's context_fn. The recomputation in the
    backward draws the forward's dropout masks again (the generator set
    back to its state at the forward's start, then to where the step had
    left it) and leaves the BatchNorm statistics as the forward left them
    (they would take a second update otherwise)."""
    start = None if generator is None else generator.get_state()

    @contextlib.contextmanager
    def recompute():
        buffers = [b.clone() for b in model.buffers()]
        resume = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(start)
        try:
            yield
        finally:
            with torch.no_grad():
                for b, saved in zip(model.buffers(), buffers):
                    b.copy_(saved)
            if generator is not None:
                generator.set_state(resume)

    return contextlib.nullcontext(), recompute()


def _statistics(model: torch.nn.Module):
    """The running statistics of every BatchNorm of `model`."""
    return [t for m in model.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            for t in (m.running_mean, m.running_var)]


def make_train_step(cfg: Config, group=None) -> Callable:
    """train_step(state, batch, generator=None, epoch=0) -> (state,
    metrics). batch: tensors on the model's device (rgb, depth NHWC; pcl;
    uvd_gt; xyz_gt; cam_para; center; M; cube), this rank's slice of the
    global batch under a process group `group` (see the module's
    docstring; None: one process). The state is updated in place and
    returned; metrics are compute_losses' values, detached."""
    kernel = cfg.feature_para[0]
    world = world_size(group)
    per_shard = world > 1 and not cfg.sync_batchnorm
    stats_group = None if per_shard else group

    def train_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None, epoch=0):
        """Spans: `kpf.train.step`, the whole step on the host; inside it
        `kpf.train.forward` (the forward, or checkpoint's) and
        `kpf.train.loss` (compute_losses)."""
        with span('kpf.train.step'):
            model = state.model.train()
            frame = frame_from_batch(batch, cfg)

            def forward():
                return model(batch['rgb'], batch['depth'], batch['pcl'],
                             frame, kernel, generator)

            state.optimizer.zero_grad(set_to_none=True)
            with global_batch_statistics(model, stats_group):
                with span('kpf.train.forward'):
                    if cfg.remat:
                        results, sw = checkpoint(
                            forward, use_reentrant=False,
                            context_fn=lambda: _remat_contexts(model,
                                                               generator))
                    else:
                        results, sw = forward()
                with span('kpf.train.loss'):
                    loss, metrics = compute_losses(
                        results, sw, batch['depth'], batch['uvd_gt'],
                        batch['xyz_gt'], frame, cfg, epoch, stats_group)
                loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            if world > 1:
                all_mean([p.grad for p in model.parameters()
                          if p.grad is not None], group)
                if per_shard:
                    all_mean(_statistics(model), group)
                names = list(metrics)
                values = torch.stack([metrics[k].float() for k in names])
                all_mean([values], group)
                metrics = dict(zip(names, values.unbind()))
            apply_gradients(state)
            state.step += 1
            return state, metrics

    return train_step


def make_train_step_scan(cfg: Config, group=None) -> Callable:
    """train_scan(state, batches, generators, epoch=0) -> (state,
    metrics): G steps of make_train_step, step i on batches' element i
    (tensors [G, B, ...]; under `group`, this rank's rows of each, axis 1
    of parallel/mesh.py:shard_batch) with generators[i] (one generator
    may stand G times), the metrics stacked [G]. It gives exactly what G
    calls of the single step give: JAX's lax.scan runs them in one
    dispatch, here they are a loop."""
    step = make_train_step(cfg, group)

    def train_scan(state: TrainState, batches: Batch,
                   generators: Sequence[Optional[torch.Generator]],
                   epoch=0):
        metrics = []
        for i, generator in enumerate(generators):
            state, m = step(state, {k: v[i] for k, v in batches.items()},
                            generator, epoch)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}

    return train_scan


def make_eval_step(cfg: Config, group=None) -> Callable:
    """eval_step(state, batch) -> (results, spatial_weights): the eval
    forward (running statistics, the kernels on the card) without
    gradients. Under a process group `group` each rank runs its slice and
    every output comes back as the global batch, gathered from the ranks
    in row order."""
    kernel = cfg.feature_para[0]

    def eval_step(state: TrainState, batch: Batch):
        model = state.model.eval()
        with torch.no_grad():
            results, sw = model(batch['rgb'], batch['depth'], batch['pcl'],
                                frame_from_batch(batch, cfg), kernel)
            if world_size(group) == 1:
                return results, sw
            return (tuple(all_gather_rows(t, group) for t in results),
                    tuple(all_gather_rows(t, group) for t in sw))

    return eval_step
