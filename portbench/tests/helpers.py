"""Shared pieces of the benchmark's tests: the benchmark file and the
small sizes a CPU run takes."""

import os

from portbench import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))
# a run's path at sizes the CPU holds: 2 frames or crops (8 for the train
# step: at 2 its BatchNorm statistics amplify rounding past the limits of
# the later steps), 128 points
SMALL = {'batch': 2, 'point_num': 128, 'warmup_requests': 1,
         'trace_requests': 1, 'check_requests': 2, 'trace_steps': 1}
SERVE, TRAIN, EVAL = 'cnxt-t.bulk.f32', 'r18.train.f32.b256', \
    'r18.eval.f32.b256'
# every net the port lists (keypointfusion_torch/config.py: Config.net)
NETS = [f'KPFusion-resnet-{d}' for d in (18, 50, 101, 152)] \
    + [f'KPFusion-convnext-{s}' for s in 'TSBL']


def config(name):
    """The configuration file portbench/configs/<name>.json."""
    return harness.load_json(os.path.join(harness.ROOT, 'portbench',
                                          'configs', name + '.json'))


def net_config(net, joints=21):
    """The least configuration the reference's functions read."""
    return {'net': net, 'joint_num': joints}


def run_small(workload, seed=2 ** 31 + 17, seconds=0.5, trace=False,
              root=harness.ROOT):
    return harness.run_cell(BENCH if root == harness.ROOT else
                            harness.load_json(os.path.join(
                                root, 'BENCHMARK.json')),
                            workload, seed, seconds, trace, device='cpu',
                            small={**SMALL, 'batch': 8} if workload == TRAIN
                            else SMALL, root=root)
