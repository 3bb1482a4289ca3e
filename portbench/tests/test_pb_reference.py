"""The plain reference against the port on the CPU at tiny sizes, with
the benchmark's own weights and inputs: the eval forward of both
configurations and of a Bottleneck ResNet, the serving pipeline
(preprocessing, forward, packing) and the train step's first loss and
gradient; and for every net the port lists, the reference's parameters
and buffers against the port's, built on the meta device."""

import numpy as np
import pytest
import torch

from portbench import inputs, weights, work
from portbench.reference import geometry as G
from portbench.reference.preprocess import preprocess
from portbench.shared import leaf_gap, reference, reference_model
from portbench.tests.helpers import NETS, net_config

SEED = 2 ** 31 + 101
# the reference a configuration without a `reference` key resolves to
REF = reference({})


@pytest.mark.parametrize('net', NETS)
def test_the_reference_builds_every_listed_net(net):
    from keypointfusion_torch.models.kpfusion import KPFusion as Port
    with torch.device('meta'):
        want = {k: v.shape for k, v in Port(net).state_dict().items()}
    sd = weights.state_dict(REF.KPFusion, net_config(net), SEED, 'meta')
    assert {k: v.shape for k, v in sd.items()} == want
    ref = reference_model(REF.KPFusion, net_config(net), sd, 'meta')
    assert {k: v.shape for k, v in ref.state_dict().items()} == want
    assert work.model_flops(REF.KPFusion, net_config(net)) > 0


@pytest.mark.parametrize('net', ['KPFusion-resnet-18', 'KPFusion-resnet-50',
                                 'KPFusion-convnext-T'])
def test_eval_forward(net):
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.models.kpfusion import build_kpfusion
    from keypointfusion_torch.training.train_step import frame_from_batch
    sd = weights.state_dict(REF.KPFusion, net_config(net), SEED, 'cpu')
    batch = inputs.crops(SEED, 1, 2, 128, 'cpu')[0]
    port = build_kpfusion(Config(net=net), 'cpu', dtype=torch.float32)
    port.load_state_dict(sd)
    ref = reference_model(REF.KPFusion, net_config(net), sd, 'cpu').eval()
    fr = G.Frame.make(batch['cam_para'], batch['center'], batch['M'],
                      batch['cube'])
    with torch.no_grad():
        got, got_sw = port(batch['rgb'], batch['depth'], batch['pcl'],
                           frame_from_batch(batch, Config(net=net)), 0.8)
        want, want_sw = ref(batch['rgb'], batch['depth'], batch['pcl'], fr)
    for g, w in zip(got + got_sw, want + want_sw):
        assert torch.isfinite(w).all()
        assert float((g - w).abs().max()) <= 1e-5 * max(
            1.0, float(w.abs().max()))


def test_serving_pipeline():
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.serving import StreamingEngine
    net = 'KPFusion-resnet-18'
    sd = weights.state_dict(REF.KPFusion, net_config(net), SEED, 'cpu')
    f = inputs.frames(SEED, 1, 2, 480, 640, 'cpu')[0]
    u = torch.rand((2, 128), generator=torch.Generator().manual_seed(3))
    eng = StreamingEngine(Config(net=net, point_num=128), state_dict=sd,
                          batch_size=2, dtype=torch.float32, device='cpu')
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    depth = t(f['depth'].astype(np.int32))
    got = eng.pipeline(depth, t(f['rgb']), t(f['centers']), t(f['cube']),
                       t(f['cam']), uniform=u)
    ref = reference_model(REF.KPFusion, net_config(net), sd, 'cpu').eval()
    with torch.no_grad():
        rgb, d, pcl, fr = preprocess(depth, t(f['rgb']), t(f['centers']),
                                     t(f['cube']), t(f['cam']), u)
        want = REF.pack(ref(rgb, d, pcl, fr)[0], fr)
    assert float((got[:, :63] - want[:, :63]).abs().max()) < 1e-3   # mm
    assert float((got[:, 63:] - want[:, 63:]).abs().max()) < 1e-5


def test_train_step_first_loss_and_gradient():
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.training.train_step import (
        create_train_state, make_train_step,
    )
    from portbench.reference import train as RT
    net = 'KPFusion-resnet-18'
    sd = weights.state_dict(REF.KPFusion, net_config(net), SEED, 'cpu')
    batch = inputs.crops(SEED, 1, 2, 128, 'cpu')[0]
    cfg = Config(net=net, point_num=128)
    state = create_train_state(cfg, batch, 'cpu')
    state.model.load_state_dict(sd)
    _, m = make_train_step(cfg)(state, batch,
                                torch.Generator().manual_seed(9), 0)
    named = dict(state.model.named_parameters())
    grads = {n: state.optimizer.state[p]['exp_avg'] / 0.1
             for n, p in named.items() if p in state.optimizer.state}
    ref = reference_model(REF.KPFusion, net_config(net), sd, 'cpu')
    losses, first = RT.train(ref, [batch], torch.Generator().manual_seed(9))
    assert abs(float(m['loss']) - losses[0]) <= 1e-6 * abs(losses[0])
    assert set(grads) == set(first)
    assert leaf_gap(grads, first) < 1e-4
