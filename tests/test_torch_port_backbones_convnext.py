"""Port parity of KPFusion-convnext-T's whole eval forward, at the
config's widths, on synthetic_batch(batch_size=2, point_num=256,
seed=42) (the inputs of tests/test_torch_port_slice.py), in float32 and
in bfloat16.

Weights: the port's model from seed 0, its layer scales set to
U(0.5, 1.5) and its backbones' BatchNorm statistics to the batch's
(tests/torch_port_helpers.py:backbone_net_weights), carried to JAX by the
JAX package's converter. JAX runs op by op (a jit of the whole model
moves b1_3d by 4e-4, ROADMAP.md §3); the port's CPU convolutions run
without oneDNN. Tolerances (torch_port_helpers.check_kpfusion_float32
and check_kpfusion_bfloat16):
  * float32: each output within 1e-4 of its scale. Measured 1.6e-6 on
    the six results, 5.7e-5 on the spatial weights.
  * bfloat16: within 2 max|jax_bf16 - jax_f32| + 2^-8 of the scale of
    JAX's float32 output. ConvNeXt's layer scales and residual stream
    stay float32 on both sides (flax promotes bfloat16 x float32) and
    the decoder's BatchNorms normalize that float32 stream before
    rounding. Measured (port gap / JAX gap): b1_3d 0.0348 / 0.0348,
    b2_3d 0.0452 / 0.0564, img_offset 0.0074 / 0.0076.
The whole-model test of KPFusion-resnet-50 is
tests/test_torch_port_backbones_resnet.py; the modules', weights' and
warm starts', tests/test_torch_port_backbones.py.
"""

import pytest
import torch

from keypointfusion_tpu.data.synthetic import synthetic_batch

from tests.torch_port_helpers import (
    backbone_net_weights, check_kpfusion_bfloat16, check_kpfusion_float32,
    kpfusion_outputs,
)

torch.set_num_threads(2)
NET = 'KPFusion-convnext-T'


@pytest.fixture(scope='module')
def shared():
    """(port state_dict, JAX variables, batch, JAX's float32 outputs)."""
    batch = synthetic_batch(batch_size=2, point_num=256, seed=42)
    sd, variables = backbone_net_weights(NET, batch)
    return sd, variables, batch, kpfusion_outputs(NET, variables, batch)


def test_kpfusion_convnext_float32_matches_jax(shared):
    print(NET, 'float32 (error / scale, JAX float32 from float64)',
          check_kpfusion_float32(NET, *shared))


def test_kpfusion_convnext_bfloat16_within_budget(shared):
    print(NET, 'bfloat16 (port gap, JAX gap)',
          check_kpfusion_bfloat16(NET, *shared))
