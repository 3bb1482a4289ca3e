"""A run with the timed path broken underneath must come out not
correct, and the same run unbroken correct: the harness's look for a card
is skipped and the rest of a run driven on the CPU at small sizes, with
the cell's own limits."""

import pytest
import torch

from portbench.tests.helpers import EVAL, SERVE, TRAIN, run_small


def _alter_answers(monkeypatch):
    """Every request's answers moved by 1 mm where the engine packs them."""
    from keypointfusion_torch import serving
    answer = serving._Replica.answer

    def altered(self, *args):
        out = answer(self, *args)
        return out + torch.nn.functional.pad(
            torch.ones_like(out[:, :1]), (0, out.shape[1] - 1))

    monkeypatch.setattr(serving._Replica, 'answer', altered)


def _alter_joints(monkeypatch):
    """The eval forward's final joints moved by 0.01 (1.25 mm) where the
    model produces them."""
    from keypointfusion_torch.models import kpfusion
    forward = kpfusion.KPFusion.forward

    def altered(self, *args, **kwargs):
        results, sw = forward(self, *args, **kwargs)
        return results[:-1] + (results[-1] + 0.01,), sw

    monkeypatch.setattr(kpfusion.KPFusion, 'forward', altered)


def _state_unchanged(monkeypatch):
    """The step computes its gradients and leaves the parameters as they
    were."""
    from keypointfusion_torch.training import train_step
    monkeypatch.setattr(train_step, 'apply_gradients', lambda state: None)


def _half_batch(monkeypatch):
    """The step takes the first half of the batch's rows, the mean over
    them."""
    from keypointfusion_torch.training import train_step
    make = train_step.make_train_step

    def broken(cfg, group=None):
        step = make(cfg, group)

        def half(state, batch, *args, **kwargs):
            return step(state, {k: v[:v.shape[0] // 2]
                                for k, v in batch.items()}, *args, **kwargs)
        return half

    monkeypatch.setattr(train_step, 'make_train_step', broken)


@pytest.mark.parametrize('workload,fault', [
    (SERVE, None), (SERVE, _alter_answers),
    (EVAL, None), (EVAL, _alter_joints),
    (TRAIN, None), (TRAIN, _state_unchanged), (TRAIN, _half_batch)])
def test_a_fault_makes_the_run_not_correct(monkeypatch, workload, fault):
    if fault is not None:
        fault(monkeypatch)
    result, rows = run_small(workload, seconds=0.3)
    assert result['correct'] == (fault is None), rows
