"""Port parity of the train step: one step and a 3-step trajectory of
training/train_step.py's train_step against the JAX package's step body,
and the port's own contract (remat, caches after an update, the entry
points' device and dtype rules).

Both sides start from the same weights (tests/torch_port_helpers.py:
train_weights), take SGD with momentum 0.9 at lr 1e-5 (Adam's first
updates are lr * sign(g), which flips on gradients near 0), dropout 0,
epoch 0, on synthetic_batch(batch_size=2, point_num=256) with seeds 42,
43 and 44, one per step. lr 1e-5 is tests/test_trajectory_parity.py's
regime, where three steps stay linear: float32 gradient noise (up to a
third of some tensors' gradients, tests/test_torch_port_train_forward.py)
times 1e-3 carried some parameters past the floor below within three
steps. The gradients themselves are held to JAX's at 1e-4 of each
tensor's scale in float64 by that file. JAX runs `_step_body` op by op
(its whole-model jit moves the forward by 4.05e-4 on these inputs;
ROADMAP.md §3); the port runs under cpu_reference_convs and
cpu_reference_batch_norms (tests/test_torch_port_train_forward.py says
why).

Tolerances, after steps 1 and 3: each parameter within max(5% of how far
it moved, 5e-6 of its scale, 3 learning rates) (the floor of
tests/test_trajectory_parity.py: train-mode BatchNorm turns float32
rounding upstream into gradient noise of the gradient's own size in the
first layers); each running statistic within 1e-2 of its scale (a point
at a ball's edge moves DESA's batch statistics); each step's loss within
1e-4 of it. Measured values are printed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.data.synthetic import synthetic_batch
from keypointfusion_tpu.models.kpfusion import KPFusion as JKPFusion
from keypointfusion_tpu.training.train_step import (
    TrainState as JTrainState, _step_body, make_optimizer as j_optimizer,
)

from keypointfusion_torch.config import Config
from keypointfusion_torch.models.kpfusion import KPFusion
from keypointfusion_torch.training.train_step import (
    TrainState, batch_to_device, create_train_state, frame_from_batch,
    make_eval_step, make_train_step,
)

from tests.torch_port_helpers import (
    cpu_reference_batch_norms, cpu_reference_convs, leaf_errors,
    port_to_jax_tree, train_weights,
)

torch.set_num_threads(2)
LR = 1e-5
STEPS = 3


@pytest.fixture(scope='module')
def batches():
    return [synthetic_batch(batch_size=2, point_num=256, seed=42 + i)
            for i in range(STEPS)]


@pytest.fixture(scope='module')
def weights():
    return train_weights(0)


@pytest.fixture(scope='module')
def jax_trajectory(batches, weights):
    """JAX's state (params, batch_stats) after steps 1 and STEPS, and each
    step's loss."""
    _, v = weights
    cfg = JConfig(opt='sgd', lr=LR)
    tx = j_optimizer(cfg, steps_per_epoch=1000)
    params = jax.tree_util.tree_map(jnp.asarray, v['params'])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree_util.tree_map(
                            jnp.asarray, v['batch_stats']),
                        opt_state=tx.init(params), tx=tx,
                        model=JKPFusion(joint_num=21, dropout=0.0))
    step = _step_body(cfg)
    snapshots, losses = {}, []
    for i, b in enumerate(batches):
        state, metrics = step(state, {k: jnp.asarray(x) for k, x in
                                      b.items()}, jax.random.PRNGKey(i), 0)
        losses.append(float(metrics['loss']))
        if i + 1 in (1, STEPS):
            snapshots[i + 1] = jax.tree_util.tree_map(
                np.asarray, {'params': state.params,
                             'batch_stats': state.batch_stats})
    return snapshots, losses


def test_train_steps_match_jax(batches, weights, jax_trajectory):
    """One step and the 3-step trajectory: losses, every parameter and
    every running statistic."""
    sd, v = weights
    want, want_losses = jax_trajectory
    cfg = Config(opt='sgd', lr=LR)
    b0 = batch_to_device(batches[0], 'cpu')
    state = create_train_state(cfg, b0, device='cpu', seed=0, dropout=0.0)
    state.model.load_state_dict(sd)
    step = make_train_step(cfg)
    losses, worst = [], {}
    for i, b in enumerate(batches):
        with cpu_reference_convs(), cpu_reference_batch_norms():
            state, metrics = step(state, batch_to_device(b, 'cpu'), None, 0)
        losses.append(float(metrics['loss']))
        if i + 1 not in want:
            continue
        got = port_to_jax_tree(state.model)
        start = leaf_errors(got['params'], v['params'])
        for path, (e, s) in leaf_errors(got['params'],
                                        want[i + 1]['params']).items():
            tol = max(0.05 * start[path][0], 5e-6 * s, 3 * LR)
            worst['params'] = max(worst.get('params', 0), e / tol)
            assert e <= tol, (i + 1, path, e, tol)
        for path, (e, s) in leaf_errors(
                got['batch_stats'], want[i + 1]['batch_stats']).items():
            worst['stats'] = max(worst.get('stats', 0), e / max(1.0, s))
            assert e <= 1e-2 * max(1.0, s), (i + 1, path, e)
    print('measured', worst, losses, want_losses)
    assert state.step == STEPS
    for got_loss, want_loss in zip(losses, want_losses):
        assert abs(got_loss - want_loss) <= 1e-4 * abs(want_loss), \
            (losses, want_losses)


def one_step(cfg, batch, dropout=0.1, seed=7):
    state = create_train_state(cfg, batch, device='cpu', seed=0,
                               dropout=dropout)
    gen = torch.Generator().manual_seed(seed)
    state, metrics = make_train_step(cfg)(state, batch, gen, 0)
    return state, metrics, gen


def test_remat_gives_the_same_step(batches):
    """cfg.remat recomputes the forward in the backward with the
    forward's dropout masks and without a second BatchNorm update: one
    step with dropout 0.1 gives bit for bit the gradients, parameters,
    statistics and generator state of the step without it (one thread:
    torch's CPU reductions are not deterministic across threads)."""
    batch = batch_to_device(batches[0], 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = [one_step(Config(opt='sgd', remat=remat), batch)
                for remat in (False, True)]
    finally:
        torch.set_num_threads(threads)
    (a, ma, ga), (b, mb, gb) = runs
    assert torch.equal(ga.get_state(), gb.get_state())
    assert float(ma['loss']) == float(mb['loss'])
    for (name, pa), pb in zip(a.model.named_parameters(),
                              b.model.parameters()):
        assert (pa.grad is None) == (pb.grad is None), name
        if pa.grad is not None:
            assert torch.equal(pa.grad, pb.grad), name
        assert torch.equal(pa, pb), name
    for (name, xa), xb in zip(a.model.named_buffers(), b.model.buffers()):
        assert torch.equal(xa, xb), name
    assert int(a.model.block1.FA.fusion[1].num_batches_tracked) == 1


def test_no_stale_cache_after_steps(batches):
    """'mixed' and full bfloat16 keep bfloat16 casts of the weights and
    DESA keeps its folded weights and K1 pack, all made under no_grad.
    After an eval forward that makes them, two train steps and .eval(),
    the model's plain-path forward, with and without gradients, equals bit
    for bit that of a fresh model loaded from its state_dict."""
    batch = batch_to_device(batches[0], 'cpu')
    for compute_dtype in ('mixed', 'bfloat16'):
        cfg = Config(compute_dtype=compute_dtype)
        state = create_train_state(cfg, batch, device='cpu', seed=0)
        evaluate = make_eval_step(cfg)
        state.model.use_kernels = False
        before = evaluate(state, batch)
        conv = state.model.backbone_d.backbone.conv1
        assert conv.__dict__['_casts']['weight'][1].dtype == torch.bfloat16
        assert '_kernel_weights' in state.model.block1.FA.__dict__
        if compute_dtype == 'bfloat16':
            linear = state.model.block1.init_TR.cls_head
            assert linear.__dict__['_casts']['weight'][1].dtype \
                == torch.bfloat16

        step = make_train_step(cfg)
        gen = torch.Generator().manual_seed(0)
        for _ in range(2):
            state, _ = step(state, batch, gen, 0)
        fresh = KPFusion(dtype=state.model.dtype,
                         backbone_dtype=state.model.backbone_dtype,
                         use_kernels=False)
        fresh.load_state_dict(state.model.state_dict())
        fresh.eval()
        after = evaluate(state, batch)
        want = evaluate(TrainState(fresh, None, None), batch)
        graded = state.model(batch['rgb'], batch['depth'], batch['pcl'],
                             frame_from_batch(batch, cfg))
        for g, gg, w, b in zip(after[0] + after[1], graded[0] + graded[1],
                               want[0] + want[1], before[0] + before[1]):
            assert torch.equal(g, w), compute_dtype
            assert torch.equal(gg.detach(), w), compute_dtype
            assert not torch.equal(g, b), compute_dtype


def test_train_entry_points_device_and_dtype(batches, monkeypatch):
    """Without a card, create_train_state raises unless the CPU is asked
    for; full bfloat16 builds the whole model in bfloat16 over float32
    parameters; an unknown compute dtype and a batch without its labels
    are refused."""
    batch = batch_to_device(batches[0], 'cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        create_train_state(Config(), batch)
    bf16 = create_train_state(Config(compute_dtype='bfloat16'), batch,
                              device='cpu').model
    assert bf16.dtype == bf16.backbone_dtype == torch.bfloat16
    assert bf16.block2.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    with pytest.raises(ValueError, match='float16'):
        create_train_state(Config(compute_dtype='float16'), batch,
                           device='cpu')
    with pytest.raises(ValueError, match='xyz_gt'):
        create_train_state(Config(), {k: v for k, v in batch.items()
                                      if k != 'xyz_gt'}, device='cpu')
    state = create_train_state(Config(), batch, device='cpu')
    assert state.model.training and state.step == 0
    assert isinstance(state.optimizer, torch.optim.AdamW)
