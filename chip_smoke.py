#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's five CUDA kernels from keypointfusion_torch/csrc/ (one
nvcc each, all at once) and holds each against its plain PyTorch version
at the serving path's shapes (batch 64): K2 and K1 in their float32
('highest') and bfloat16 serving ('default') modes, and K3. Compares the
KPFusion-resnet-18 forward through the kernels with the plain path, in
float32 and in bfloat16. Then drives each path with the launch counters
set to 0 just before and read just after: the float32 and the bfloat16
streaming engine, each answering 4 requests of 64 full 480x640 RGB-D
frames (the bfloat16 line gives how many pixels K2 'default' selects per
point on one request's data), and K3's own entry point,
desa_apply_inference; the train step in float32, 'mixed' and bfloat16
(check_train: one step on the card against the CPU, 13 steps at batch
64 timed, no kernel launched in them, then an eval step through K1 and
K2); the trainer (check_trainer: training/trainer.py's Trainer for 2
epochs, its resume against the straight run, its test() through the
kernels against the plain path, evaluation()); the host data path and
the command line (check_data); the demo (check_demo: ModelRGBD at batch
1 on a fixture frame and the JAX demo's synthetic frame, and demo.main());
and the config's other backbones (check_backbones: KPFusion-convnext-T
and KPFusion-resnet-50 through the forward, both engines and, for
ConvNeXt-T, the train step); the config's other feature types
(check_feature_types: 'offset' and 'heatmap' trained, card against CPU
and timed, and with 'weight_offset_nosoftmax' each decoding an eval batch
through the trainer's decode, the kernels against the plain path); MANO
(check_mano: mano_forward and ManoRegHead at batch 64, card against
CPU, ms and host waits a call); DESA's dense train form
(check_desa_dense_train: against the gather form on the card, then ms a
step and peak memory); the optional model families
(check_optional_models: PoseNet, CenterNetRegressor, CBAM,
RGBDResNetUNet, DetrDecoder and SpatialAggregateTR at full width, card
against CPU in eval and one train step, then ms and peak memory at batch
64, no kernel launched); and the off-path data modules
(check_extra_data: patch warps, crops, RHD helpers and heatmaps against
the JAX package's outputs in a fixture, bit for bit; occlusion masks and
visibility on the card against the CPU); the multi-device paths
(check_parallel: two engine replicas on the card against one engine,
each request launching K2 twice and K1 four times, counters set to 0
just before it; two gloo ranks on the card under both BatchNorm
policies against the world-1 step; an NCCL world of one); and the
native eval core (check_native: the JAX core's stored samples, 0 values
differing; ms a sample and loader samples/s by both routes); and the
debug renderers of utils/vis.py (check_vis_debug: the JAX package's
outputs in a fixture, bit for bit; then a float32 eval forward at batch
8 rendered, K2 once and K1 twice in it, nothing launched by the
renderers, host ms a call). Weights are random, drawn from a seed.
Every phase prints one line; then a JSON line describing each kernel, the card's name and power
limit as nvidia-smi reports them, and last {"ok": true,
"device": {...}}. Any failure raises and exits non-zero. Without a CUDA
device it exits 1 and prints no result.

Every kernel's `ms` is the CUDA-event time of back-to-back calls of its
entry point after a warm-up (L2 not flushed). Both K1 phase lines also
give the torch.profiler device time of the kernel alone and of its entry
point, the entry point's host time per call, and what ptxas and the CUDA
runtime report (registers, spills, shared memory, blocks per SM); both
K2 phase lines give the kernel's device time and the same build figures.
A kernel's bound is the larger of the bytes it must move over
3.35 TB/s and its operations over the card's peak for their type: float32
on the CUDA cores at 67 TFLOP/s, products of bfloat16 operands at 989
TFLOP/s, TF32 products at 495 TFLOP/s (the H100 SXM's published peaks);
K1 'highest''s and K3's products at float32 accuracy count as three TF32
products, as their kernels run them (each phase line gives the bound on
the CUDA cores beside it). The K3 phase line also gives its kernel's
device time, ptxas report and launch shape. Float32 matmuls and
convolutions run without TF32 throughout, but for the controls that show
one TF32 pass fails K1 'highest''s and K3's limits.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
import time
import types
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 64
REQUESTS = 4
TIE_ELEMENTS = 8   # batch elements of K2's flat-background case
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
K2_TOL = 0.0     # same selection, same float32 operations in the same order
# three TF32 products with float32 sums (the kernel) against float32
# products (the plain version): 3.05e-5 at batch 8, 2.5e-5 at batch 2
# (emulated on the CPU); one TF32 product lies 0.012-0.016 away, and
# check_highest_contract shows the card's TF32 products outside
K1_TOL = 1e-4
K3_TOL = 1e-4    # as K1
K3_VS_K1 = (1e-3, 2e-3)   # rtol, atol: the JAX package's bound for K3 vs DESA
# of the scale: sums in another order, then bfloat16 roundings of h1 and of
# the fusion input that fall the other way (4.1e-4 of the scale measured on
# an H100). Plain versions that skip the rounding of h1 or of the fusion
# input lie 2.0e-3 of the scale or more away at this shape, the 'highest'
# arithmetic 4.3e-3 (CPU); check_serving_contract shows each lies outside
K1_SERVING_TOL = 1e-3
# of the scale, K1 'default''s joint term against float64 sums: float32
# products lie 1.1e-7 of the scale away, TF32 products 3.4e-4 (CPU,
# operands rounded to TF32), and the check shows the card's TF32 outside
JOINT_TERM_TOL = 1e-5
FORWARD_TOL = 1e-4   # of each output's scale (at least 1)
TRAIN_LR = 1e-3      # the card-against-CPU step: SGD with momentum 0.9
TRAIN_WARMUP = 3
TRAIN_STEPS = 10
# the card's train step against the port's on the CPU, batch 2: each
# parameter within max(param_rel * its scale, lr_floor learning rates)
# (train-mode BatchNorm turns float32 rounding upstream into gradient noise
# of the gradient's own size in the first layers); each running statistic
# within stat_rel of its scale (a point at a ball's edge moves DESA's batch
# statistics by ~1e-3); the loss within loss_rel of itself. Those limits
# pass a step that skipped its update, so three lines hold the update
# itself, each an L2 norm over every tensor at once: 'update', the card's
# after - before against the CPU's, within update_rel; 'own_update', the
# card's after - before against -lr times its own gradient (SGD's first
# step), within own_update_rel; 'stat_change', the running statistics'
# change against the CPU's, within stat_change_rel. check_train shows that
# a skipped, halved or doubled update and statistics update fail each line
# held. Measured on an H100 (700 W), float32: loss 1.3e-6, parameters 0.016
# and statistics 0.0024 of their limits, update 0.0099, statistics' change
# 7.7e-6 (the CPU's step with and without oneDNN: update 0.029). 'mixed':
# loss 0.0198, the worst parameter 0.35 and statistic 0.34 of their limits,
# statistics' change 0.027; the update lies 0.83 from the CPU's, and the
# CPU's with and without oneDNN 0.75 apart: the backbones' bfloat16
# roundings, amplified by train-mode BatchNorm, leave no two
# implementations' gradients alike at batch 2 (JAX's own 'mixed' forward
# lies 0.16-0.66 from its float32 one on the block outputs,
# tests/test_torch_port_train_forward.py), so 'mixed' holds no 'update'
# line; its other limits are about 3x the measured, its floor 10 lr.
# 'bfloat16' (the whole model), the same way: loss 0.0061, the worst
# parameter under 0.29 and statistic 0.26 of these limits, statistics'
# change 0.024, own update 7.0e-5; the update 0.73 from the CPU's
TRAIN_TOL = {'float32': {'param_rel': 1e-4, 'lr_floor': 3,
                         'stat_rel': 1e-2, 'loss_rel': 1e-4,
                         'update_rel': 0.1, 'own_update_rel': 1e-3,
                         'stat_change_rel': 0.01},
             'mixed': {'param_rel': 0.04, 'lr_floor': 10, 'stat_rel': 0.5,
                       'loss_rel': 0.06, 'update_rel': None,
                       'own_update_rel': 1e-3, 'stat_change_rel': 0.1},
             'bfloat16': {'param_rel': 0.04, 'lr_floor': 10,
                          'stat_rel': 0.5, 'loss_rel': 0.02,
                          'update_rel': None, 'own_update_rel': 1e-3,
                          'stat_change_rel': 0.1}}
# the controls: the card's step with its update and its statistics' change
# scaled by these factors must fail every update line held
TRAIN_CONTROLS = (0.0, 0.5, 2.0)
TRAINER_TRAIN = 4 * BATCH   # samples: 4 steps an epoch
TRAINER_TEST = BATCH + 40   # a full batch and a partial one, padded
TRAINER_EPOCHS = 2
# the [trainer] phase's resumed run against the straight run (L2 over every
# tensor at once: parameters and statistics over how far the straight run
# moved them, each AdamW moment over its size). The card's backward sums
# with atomics (the bilinear upsampling's, cuDNN's), so no two runs are
# alike bit for bit, and 8 AdamW steps from random weights carry that far:
# two straight runs lay 0.20-0.23, 0.041-0.048, 0.134-0.148 and
# 0.016-0.024 apart, the resumed run 0.20-0.22, 0.038-0.053, 0.137-0.144
# and 0.015-0.024 from the straight one, cuDNN's deterministic algorithms
# on or off alike (scripts/torch_trainer_resume_spread.py and this
# script, an H100 at 700 W); a control resumed without the optimizer's
# state lay 0.73-0.74, 0.345-0.364, 1.89-2.00 and 1.86-2.08 away. The
# limits are about twice the spread; the control must fail every one
RESUME_TOL = {'params': 0.5, 'stats': 0.1, 'exp_avg': 0.3, 'exp_avg_sq': 0.05}
# test() through the kernels against test() on the plain path, in mm: the
# float32 forward's 1e-4 of scale times the half cube
TRAINER_MM_TOL = FORWARD_TOL * 125.0
SERVING_TOL = {'joint_xyz_mm': 1e-4 * 125.0, 'joint_uvd': 1e-4, 'M': 0.0}
# the [data] phase: the committed DexYCB-layout fixture, and a tree of
# annotations over its frames (right and left hands in turn) for the CLI
DATA_FIXTURE = 'tests/fixtures/torch_port_dexycb'
# annotations: 16 steps of the one epoch. The loader runs DATA_AHEAD
# batches ahead of the step (BatchLoader's 4 in flight, device_prefetch's
# 2), so it loads through the first 16 - DATA_AHEAD steps and is done for
# the rest: the two are reported apart
DATA_TRAIN = 16 * BATCH
DATA_AHEAD = 6
DATA_TEST = BATCH + 8       # a full batch and one of 8, padded
DATA_THREADS = (1, 2, 4, 8)
DATA_SCALING_SAMPLES = 2 * BATCH
# the fixture's samples built here against the JAX package's, stored: rgb
# bit for bit, every other key within this (normalized units); the CPU
# test holds all of them bit for bit against the same numpy and scipy
DATA_SAMPLE_TOL = 1e-5
# the [demo] phase: ModelRGBD on the fixture's test frame 0, its joints
# through the kernels against the plain path (normalized units: uvd, and
# xyz in half cubes), and its host ms a frame, the median of DEMO_FRAMES
# after DEMO_WARMUP
DEMO_TOL = 1e-4
DEMO_WARMUP = 3
DEMO_FRAMES = 20
# the [backbones] phase: the config's other backbones at batch 64; the
# ConvNeXt one also trains: its card-against-CPU step at this batch
BACKBONE_NETS = ('KPFusion-convnext-T', 'KPFusion-resnet-50')
BACKBONE_TRAIN_NET = 'KPFusion-convnext-T'
BACKBONE_TRAIN_BATCH = 8
# the [feature_types] phase: the config's other decodable feature types;
# the first two train (card against CPU at FEATURE_TRAIN_BATCH, then timed
# at BATCH), all three decode one eval batch through Trainer._decode_stage
FEATURE_TYPES = (('offset',), ('heatmap',), ('weight_offset_nosoftmax',))
FEATURE_TRAINED = 2
FEATURE_TRAIN_BATCH = 8
# the [mano] phase: the synthetic 778-vertex asset at batch 64; the card
# against the CPU port within these fractions of each tensor's scale (at
# least 1): the meshes and joints in mm, the head's gradients
MANO_TOL = {'mesh': 1e-5, 'grad': 1e-4}
MANO_ITERS = 20
# the [desa_dense_train] phase: dense against gather on the card at batch
# 8 within TRAIN_TOL['float32']; timed at the first of these batches that
# fits on the card
DENSE_TRAIN_BATCH = 8
DENSE_TIMED_BATCHES = (BATCH, 48, 32, 16)
# the [optional_models] phase: each family at full width, the card
# against the CPU port at OPTIONAL_CHECK_BATCH in float32 (TF32 off):
# the eval forward within 'forward' of each output's scale (at least 1);
# after one train-mode forward and backward, the gradients and the
# running statistics' change, each as one L2 norm over every tensor at
# once relative to the CPU's, within OPTIONAL_BUDGET times the CPU's own
# float32 distance from its float64 run, and at least within 'grad' and
# 'stat'. Train-mode BatchNorms over few values make float32 gradients
# ill-conditioned: PoseNet's float32 gradients lie 3.7% (L2) from
# float64 on the CPU, and two CPU builds (with and without oneDNN) 1.9%
# from each other; CBAM's 1e-6. The control, the CPU's run on inputs
# moved by OPTIONAL_CONTROL of their scale (noise: a train-mode BatchNorm
# would cancel a scaling), must fail every limit. Timed at BATCH over
# OPTIONAL_ITERS calls after a warm-up.
OPTIONAL_CHECK_BATCH = 4
OPTIONAL_TOL = {'forward': 1e-4, 'grad': 1e-3, 'stat': 1e-4}
OPTIONAL_BUDGET = 3.0
OPTIONAL_CONTROL = 1e-2
OPTIONAL_ITERS = 10
# the [extra_data] phase: the host functions against the JAX package's
# outputs in this file (scripts/make_torch_port_extra_fixture.py), bit
# for bit; mask_image and joint_visibility on the card against the CPU
# with the same draws at these sizes, expected equal
EXTRA_FIXTURE = 'tests/fixtures/torch_port_extra/extra.npz'
# host ms a call at the datasets' own sizes (the fixture's are toy ones):
# a FreiHAND 224x224 RGB frame warped to patch_augmentation's default
# 256x256, an RHD 320x320 frame and mask, create_heatmap's default 64x64
# maps, make_gaussian_heatmap on a batch of 64x64 maps
EXTRA_FREIHAND = 224
EXTRA_RHD = 320
EXTRA_PATCH = (256, 256)
EXTRA_HEATMAP = 64
EXTRA_HOST_ITERS = 20
EXTRA_MASK_SIZE = 128
EXTRA_POINTS = 1024
EXTRA_KERNEL = 0.17   # ~12 of the cloud's points a joint: some visible
# the [parallel] phase: engine replicas on the one card, gloo ranks on it
PARALLEL_REPLICAS = 2
PARALLEL_RANKS = 2
PARALLEL_STEP_BATCH = 2      # the ranks' step: one row a rank, 256 points
# the NCCL world-1 global-batch BatchNorm against torch's own, of scale
PARALLEL_BN_TOL = 1e-5
PARALLEL_BN_ROWS = 4096
# the [native] phase: the test split's samples timed by each route
NATIVE_TEST = 2 * BATCH
NATIVE_THREADS = (1, 8)
# the [vis_debug] phase: the debug renderers on the fixture's inputs
# against the JAX package's digests (scripts/make_torch_port_vis_fixture.py),
# bit for bit; then on a float32 eval forward's outputs at VIS_BATCH, host
# ms a call over VIS_ITERS calls after one
VIS_FIXTURE = 'tests/fixtures/torch_port_vis/vis_debug.npz'
VIS_BATCH = 8
VIS_ITERS = 3
OUTPUTS = ['img_offset', 'img_offset_rgb', 'b1_3d', 'b1_2d', 'b2_3d',
           'b2_2d', 'spatial_weight_1', 'spatial_weight_2']


def log(phase, **fields):
    print(f'[{phase}] ' + ' '.join(f'{k}={v}' for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters):
    """Host time per call of fn, issued back to back without waiting for
    the card (whose queue does not fill at these sizes): where it exceeds
    the device time, cuda_ms reads it."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e3


def device_ms(fn, iters, name=''):
    """Device time per call of fn, from torch.profiler over `iters` calls
    after a warm-up: the kernels whose name holds `name` (every kernel when
    it is empty). Unlike cuda_ms, no host time between launches counts."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.key)
    if total <= 0:
        raise AssertionError(f'the profiler saw no device time for {name!r}')
    return total / iters / 1e3


def bound_ms(nbytes, flops, bf16_flops=0, tf32_flops=0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP32_FLOP_PER_S + bf16_flops / BF16_FLOP_PER_S
             + tf32_flops / TF32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def joint_term_float64(node_feat, node_xyz, w, radius):
    """K1 'default''s joint term b_j [B,J,R,C]
    (kernels/desa_dense.py:serving_joint_term) from the folded weights,
    with every sum and product in float64."""
    import torch
    f = node_feat.to(torch.bfloat16).double()
    x = node_xyz.double()
    return torch.stack([f @ w.wf[i].double()
                        + (x @ w.wl[i].double()) * (1.0 / r)
                        - w.b1[i].double()
                        for i, r in enumerate(radius)], 2)


def bf16_ulp(x):
    """One bfloat16 ulp of |x| (8 significant bits)."""
    import torch
    m = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def reset(kernels):
    for k in kernels.values():
        k.launches = 0


def counts(kernels):
    return {name: k.launches for name, k in kernels.items()}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def model_inputs(batch, dev):
    import torch
    from keypointfusion_torch.geometry.camera import CropFrame
    frame = CropFrame.from_batch(batch['cam_para'], batch['center'],
                                 batch['M'], batch['cube'], device=dev)
    t = lambda k: torch.from_numpy(batch[k]).to(dev)
    return t('rgb'), t('depth'), t('pcl'), frame


def sampler_inputs(dev, batch):
    """K2's inputs at the serving shape: 64 x 1024 points, 32x32 pixels, 277
    channels. The first TIE_ELEMENTS elements are a flat background on a
    dyadic grid, where equidistant pixels tie exactly (the 4th and 5th
    nearest among them)."""
    import torch
    from keypointfusion_torch.geometry.camera import uvd_nl_to_xyz_nl
    from keypointfusion_torch.geometry.grid import img_uvd_points
    from keypointfusion_torch.ops.resize import resize_nearest_torch

    _, depth, pcl, frame = model_inputs(batch, dev)
    img_xyz = uvd_nl_to_xyz_nl(
        img_uvd_points(resize_nearest_torch(depth, 32)), frame)
    rng = np.random.RandomState(1)
    r = (np.arange(32, dtype=np.float32) + 0.5) / 16.0 - 1.0
    u, v = np.meshgrid(r, r)
    grid = np.stack([u, v, np.full_like(u, 0.5)], -1).reshape(-1, 3)
    img_xyz[:TIE_ELEMENTS] = torch.from_numpy(grid).to(dev)
    pts = rng.randint(-32, 33, (TIE_ELEMENTS, 1024, 2)) / 32.0
    pcl[:TIE_ELEMENTS] = torch.from_numpy(np.concatenate(
        [pts, np.full((TIE_ELEMENTS, 1024, 1), 0.5)], -1).astype(
            np.float32)).to(dev)
    feat = torch.from_numpy(
        rng.randn(BATCH, 1024, 277).astype(np.float32)).to(dev)
    return pcl.contiguous(), img_xyz.contiguous(), feat


def selection_spread(pcl, img_xyz):
    """K2 'default''s pixels selected per point: mean, p99 and max, and
    the total."""
    import torch
    from keypointfusion_torch.kernels import pixel_sampler as k2
    d2 = k2.serving_sqdist(pcl, img_xyz)
    counts = (d2 <= k2.serving_threshold(d2)).sum(-1).flatten().float()
    return {'mean': round(float(counts.mean()), 3),
            'p99': float(torch.quantile(counts, 0.99)),
            'max': int(counts.max()), 'total': int(counts.sum())}


def three_positions(pcl, img_xyz, feat):
    """K2's inputs cut to the first TIE_ELEMENTS elements, their pixel
    centres moved to 3 positions: no point has a 4th distinct distance, so
    'default' selects all HW pixels, and each of a point's 4 nearest is a
    tie ('highest' must take the lowest indices)."""
    import torch
    e = TIE_ELEMENTS
    hw = img_xyz.shape[1]
    rng = np.random.RandomState(3)
    where = torch.from_numpy(rng.uniform(-1, 1, (e, 3, 3)).astype(
        np.float32)).to(img_xyz.device)
    pick = torch.from_numpy(rng.randint(0, 3, (e, hw))).to(img_xyz.device)
    img3 = where[torch.arange(e, device=pick.device)[:, None], pick]
    return pcl[:e].contiguous(), img3.contiguous(), feat[:e].contiguous()


def check_all_selected(pcl, img_xyz, feat):
    """K2 'default' on three_positions(): each point selects all HW
    pixels. Returns (the largest error in bfloat16 ulps, the kernel's ms);
    raises unless it is bit for bit within one ulp."""
    from keypointfusion_torch.kernels import pixel_sampler as k2
    args = three_positions(pcl, img_xyz, feat)
    if selection_spread(*args[:2])['mean'] != img_xyz.shape[1]:
        raise AssertionError('the all-selected case does not select all')
    got = k2.sample_pixel_features_fused(*args, mode='default')
    want = k2.sample_pixel_features_plain(*args, mode='default')
    ulps = float(((got.float() - want.float()).abs()
                  / bf16_ulp(want)).max())
    if not ulps <= 1:
        raise AssertionError(f'K2 default, all selected: {ulps} ulps from '
                             f'its plain version')
    ms = cuda_ms(lambda: k2.sample_pixel_features_fused(
        *args, mode='default'), 5)
    return ulps, ms


def check_all_tied(pcl, img_xyz, feat):
    """K2 'highest' on three_positions(): every point's 5 nearest pixels
    tie. Returns (the largest error, the kernel's ms); raises unless it is
    bit for bit."""
    import torch
    from keypointfusion_torch.kernels import pixel_sampler as k2
    from keypointfusion_torch.ops.pairwise import pairwise_sqdist
    args = three_positions(pcl, img_xyz, feat)
    d2 = torch.sort(pairwise_sqdist(*args[:2]), -1)[0]
    if not bool((d2[..., 0] == d2[..., 4]).all()):
        raise AssertionError('the all-tied case has a slot that is no tie')
    got = k2.sample_pixel_features_fused(*args)
    err = float((got - k2.sample_pixel_features_plain(*args)).abs().max())
    if not err <= K2_TOL:
        raise AssertionError(f'K2 highest, all tied: {err} from its plain '
                             f'version')
    return err, cuda_ms(lambda: k2.sample_pixel_features_fused(*args), 5)


def check_pixel_sampler(dev, batch, mode):
    """K2 in one mode against its plain version. 'highest': the flat
    background's 4th/5th-nearest ties go to the lower index, and
    check_all_tied runs. 'default': the flat background selects whole
    tied rings, more than 4 pixels, check_all_selected runs, and the
    phase line gives the selection's spread. Both phase lines give the
    kernel's device time (torch.profiler), its ptxas report and its
    launch shape."""
    import torch
    from keypointfusion_torch.kernels import pixel_sampler as k2
    from keypointfusion_torch.ops.pairwise import pairwise_sqdist

    pcl, img_xyz, feat = sampler_inputs(dev, batch)
    serving = mode == 'default'
    if serving:
        feat = feat.to(torch.bfloat16)
    run = lambda: k2.sample_pixel_features_fused(pcl, img_xyz, feat,
                                                 mode=mode)
    plain = lambda: k2.sample_pixel_features_plain(pcl, img_xyz, feat,
                                                   mode=mode)
    got, want = run(), plain()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    b, n, hw, c = BATCH, 1024, 1024, 277
    if serving:
        spread = selection_spread(pcl, img_xyz)
        selected = spread['total']
        ok = bool((diff <= bf16_ulp(want)).all())
        tol = 'one bfloat16 ulp'
        # one distance pass (3 subtractions, 3 multiply-adds and a compare
        # per pair), the selected pixels' weights, then bf16 x bf16
        # products: the function's work, whatever computes it
        flops = b * n * hw * 7 + selected * 3
        bound, bound_by = bound_ms(nbytes(pcl, img_xyz, feat, got), flops,
                                   selected * c * 2)
        all_ulps, all_ms = check_all_selected(pcl, img_xyz, feat)
        fields = dict(
            selected_per_point=json.dumps(spread), all_selected_ulps=all_ulps,
            all_selected_ms=round(all_ms, 4))
        if spread['max'] <= 4:
            raise AssertionError('no point selects more than 4 pixels')
    else:
        d2 = torch.sort(pairwise_sqdist(pcl[:TIE_ELEMENTS],
                                        img_xyz[:TIE_ELEMENTS]), -1)[0]
        ties = int((d2[..., 3] == d2[..., 4]).sum())
        ok = err <= K2_TOL
        tol = K2_TOL
        # one distance pass (d2 and its clamp), then the weighted sum
        flops = b * n * hw * 9 + b * n * c * 7
        bound, bound_by = bound_ms(nbytes(pcl, img_xyz, feat, got), flops)
        tied_err, tied_ms = check_all_tied(pcl, img_xyz, feat)
        fields = dict(boundary_ties=ties, all_tied_err=tied_err,
                      all_tied_ms=round(tied_ms, 4))
        if ties == 0:
            raise AssertionError('the flat-background case has no '
                                 'boundary tie')
    kernel = k2.SERVING_KERNEL if serving else k2.KERNEL
    per_block, smem, blocks, threads, rows = k2.kernel_info(mode, hw, c)
    fields.update(
        points_per_block=per_block, grid=json.dumps([-(-n // per_block), b]),
        threads=threads, rows_in_flight=rows, smem_bytes=smem,
        blocks_per_sm=blocks,
        kernel_device_ms=round(device_ms(run, 20, kernel.name + '_kernel'),
                               5),
        ptxas=json.dumps([ln.strip() for ln in kernel.build_log.splitlines()
                          if 'entry function' in ln or 'registers' in ln
                          or 'spill' in ln]))
    ms = cuda_ms(run, 20)
    plain_ms = cuda_ms(plain, 5, 1)
    log(f'kernel K2 {mode}', max_abs_err=err, tol=tol, **fields,
        ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        bound_ms=round(bound, 4), bound_by=bound_by)
    if not ok:
        raise AssertionError(f'K2 {mode} differs from its plain version '
                             f'by {err}')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by}


def desa_inputs(dev, batch):
    """K1's and K3's inputs at the serving shape: 64 x 21 joints over 1024
    + 21 support points, C=128, and a seeded DESA with perturbed BatchNorm
    statistics. Joint 0 of element 0 sits far from the cloud, so its balls
    hold only itself."""
    import torch
    from keypointfusion_torch.models.desa import DESA

    rng = np.random.RandomState(2)
    pcl_xyz = torch.from_numpy(batch['pcl']).to(dev)
    node_np = batch['xyz_gt'].copy()
    node_np[0, 0] = 5.0
    node_xyz = torch.from_numpy(node_np).to(dev)
    pcl_feat = torch.from_numpy(
        rng.randn(BATCH, 1024, 128).astype(np.float32)).to(dev)
    node_feat = torch.from_numpy(
        rng.randn(BATCH, 21, 128).astype(np.float32)).to(dev)
    torch.manual_seed(2)
    module = DESA(128)
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    return (pcl_feat, node_feat, pcl_xyz, node_xyz), module.eval().to(dev)


def group_mismatches(pcl_xyz, node_xyz, radius, samples):
    """(joint, radius) pairs whose group K1 'default' selects
    (kernels/desa_dense.py:serving_groups, the kernel's own selection
    code) differs from the plain ball query's, slot by slot."""
    import torch
    from keypointfusion_torch.kernels import desa_dense as k1
    from keypointfusion_torch.ops.ball_query import ball_query_slots
    from keypointfusion_torch.ops.pairwise import pairwise_sqdist

    sel, nsel = k1.serving_groups(pcl_xyz, node_xyz, radius, samples)
    d2 = pairwise_sqdist(node_xyz, torch.cat([pcl_xyz, node_xyz], 1))
    bad = 0
    for i, (r, s) in enumerate(zip(radius, samples)):
        idx, valid = ball_query_slots(d2, r, s)
        want = torch.full_like(sel[:, :, i], -1, dtype=torch.int64)
        want[..., :s] = torch.where(valid, idx, -1)
        same = (sel[:, :, i].long() == want).all(-1)
        same &= nsel[:, :, i] == valid.sum(-1)
        bad += int((~same).sum())
    return bad


def check_serving_contract(args, w, pack, want, radius, samples, tol):
    """What the comparison of K1 'default' with its plain version cannot
    see or must tell apart: the joint term, which the two share, against
    float64 sums (and TF32 products must fail that limit); plain versions
    that skip a rounding of the contract, or take the 'highest'
    arithmetic, must each lie outside the kernel's limit."""
    import torch
    from keypointfusion_torch.kernels import desa_dense as k1

    node_feat, node_xyz = args[1], args[3]
    ref = joint_term_float64(node_feat, node_xyz, w, radius)
    jt_tol = JOINT_TERM_TOL * max(1.0, float(ref.abs().max()))
    jt = lambda: float((k1.serving_joint_term(node_feat, node_xyz, pack,
                                              radius).double() - ref)
                       .abs().max())
    jt_err = jt()
    torch.backends.cuda.matmul.allow_tf32 = True
    jt_tf32 = jt()
    torch.backends.cuda.matmul.allow_tf32 = False
    if not jt_err <= jt_tol < jt_tf32:
        raise AssertionError(f'joint term {jt_err} from float64 sums, with '
                             f'TF32 {jt_tf32}; limit {jt_tol}')
    controls = {
        'highest': k1.desa_dense_plain(*args, w, radius, samples, 'highest'),
        'h1_float32': k1._desa_serving_plain(*args, pack, radius, samples,
                                             keep_float32=('h1',)),
        'fusion_float32': k1._desa_serving_plain(
            *args, pack, radius, samples, keep_float32=('fusion',))}
    dist = {k: float((v - want).abs().max()) for k, v in controls.items()}
    if not all(d > tol for d in dist.values()):
        raise AssertionError(f'a control lies inside the K1 default limit '
                             f'{tol}: {dist}')
    return {'joint_term_vs_float64': jt_err, 'joint_term_tol': jt_tol,
            'joint_term_tf32_vs_float64': jt_tf32,
            'controls_vs_plain': json.dumps(dist)}


def check_highest_contract(args, w, want, radius, samples):
    """What the comparison of K1 'highest' with its plain version must tell
    apart: the plain version with one TF32 pass per product (cuBLAS with
    TF32 on, the flag restored after) must lie outside K1_TOL; the
    kernel's arithmetic, three TF32 passes emulated bit for bit
    (`_desa_highest_plain(tf32_passes=3)`), inside it."""
    import torch
    from keypointfusion_torch.kernels import desa_dense as k1

    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = k1.desa_dense_plain(*args, w, radius, samples)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    three = k1._desa_highest_plain(*args, w, radius, samples, tf32_passes=3)
    dist = {'tf32_1pass_cublas': float((one_pass - want).abs().max()),
            'tf32_3pass_emulated': float((three - want).abs().max())}
    if not dist['tf32_3pass_emulated'] <= K1_TOL < dist['tf32_1pass_cublas']:
        raise AssertionError(f'a control lies on the wrong side of the K1 '
                             f'highest limit {K1_TOL}: {dist}')
    return {'controls_vs_plain': json.dumps(dist)}


def check_desa(dev, batch, mode):
    """K1 in one mode against its plain version. A second call with a first
    radius whose square rounds to 0 leaves every first ball empty, so each
    group falls back to the closest point (the joints sit on a 1/64 grid,
    where a joint's d2 to itself is exactly 0). 'default' takes the
    features in bfloat16 and its weights packed once, as models/desa.py
    keeps them; its groups are held slot by slot against the plain ball
    query, and check_serving_contract runs; 'highest' takes its weights
    packed once too, and check_highest_contract runs. The phase line also
    gives the device time (torch.profiler) of the kernel alone and of the
    entry point's call ('default': the joint term, then the kernel)."""
    import torch
    from keypointfusion_torch.kernels import desa_dense as k1
    from keypointfusion_torch.ops.ball_query import ball_query_slots
    from keypointfusion_torch.ops.pairwise import pairwise_sqdist

    (pcl_feat, node_feat, pcl_xyz, node_xyz), module = desa_inputs(dev, batch)
    serving = mode == 'default'
    if serving:
        pcl_feat, node_feat = pcl_feat.bfloat16(), node_feat.bfloat16()
    grid_xyz = torch.round(node_xyz * 64) / 64
    with torch.no_grad():
        w = module.folded_weights()
    kw = k1.serving_weights(w) if serving else k1.highest_weights(w)
    radius, samples = module.radius, module.num_samples
    empty_radius = (1e-23,) + radius[1:]
    args = (pcl_feat, node_feat, pcl_xyz, node_xyz)
    empty_args = (pcl_feat, node_feat, pcl_xyz, grid_xyz)
    got = k1.desa_dense(*args, kw, radius, samples, mode)
    want = k1.desa_dense_plain(*args, w, radius, samples, mode)
    got_e = k1.desa_dense(*empty_args, kw, empty_radius, samples, mode)
    want_e = k1.desa_dense_plain(*empty_args, w, empty_radius, samples, mode)
    torch.cuda.synchronize()
    err_o = float((got - want).abs().max())
    err_e = float((got_e - want_e).abs().max())
    err = max(err_o, err_e)
    scale = max(1.0, float(want.abs().max()), float(want_e.abs().max()))
    tol = K1_SERVING_TOL * scale if serving else K1_TOL
    entry = lambda: k1.desa_dense(*args, kw, radius, samples, mode)
    fields = {'err_ordinary': err_o, 'err_empty_first_balls': err_e}
    if serving:
        bad_groups = group_mismatches(pcl_xyz, node_xyz, radius, samples) \
            + group_mismatches(pcl_xyz, grid_xyz, empty_radius, samples)
        if bad_groups:
            raise AssertionError(f'K1 default selects {bad_groups} groups '
                                 f'unlike the plain ball query')
        fields.update(check_serving_contract(args, w, kw, want, radius,
                                             samples, tol))
        fields['groups_unlike_plain'] = bad_groups
    else:
        fields.update(check_highest_contract(args, w, want, radius, samples))
    kernel = k1.SERVING_KERNEL if serving else k1.KERNEL
    tile, smem, blocks = k1.kernel_info(mode)
    fields.update(
        joint_tile=tile, grid=json.dumps([-(-21 // tile), BATCH]),
        smem_bytes=smem, blocks_per_sm=blocks,
        kernel_device_ms=round(device_ms(
            entry, 20, kernel.name + '_kernel'), 5),
        entry_device_ms=round(device_ms(entry, 20), 5),
        entry_host_ms=round(host_ms(entry, 50), 4),
        ptxas=json.dumps([ln.strip() for ln in kernel.build_log.splitlines()
                          if 'entry function' in ln or 'registers' in ln
                          or 'spill' in ln]))
    ms = cuda_ms(entry, 20)
    plain_ms = cuda_ms(
        lambda: k1.desa_dense_plain(*args, w, radius, samples, mode), 5, 1)

    # the work these inputs need: every group slot in use; in 'default'
    # the first layer's A_m once per (element, point) some group holds
    d2 = pairwise_sqdist(node_xyz, torch.cat([pcl_xyz, node_xyz], 1))
    slots, points = 0, 0
    for r, s in zip(radius, samples):
        idx, valid = ball_query_slots(d2, r, s)
        slots += int(valid.sum())
        held = torch.zeros(d2.shape[0], d2.shape[2], dtype=torch.bool,
                           device=dev)
        held.scatter_(1, torch.where(valid, idx, idx[..., :1]).flatten(1),
                      True)
        points += int(held.sum())
    lone = int((d2[0, 0] < 0.01).sum())
    empty = int((pairwise_sqdist(grid_xyz, torch.cat([pcl_xyz, grid_xyz], 1))
                 < empty_radius[0] ** 2).sum())
    c, m = 128, 1024 + 21
    fusion = BATCH * 21 * 2 * 4 * c * c            # 512 -> 128 fusion
    # the least work: products A_m = f_m Wf_i per held point, h2 per slot,
    # the fusion; float32 on the CUDA cores: A_m's coordinate term, d2, the
    # joint's own term per radius
    products = (points + slots) * 2 * c * c + fusion
    rest = points * 2 * 3 * c + BATCH * 21 * m * 9 \
        + BATCH * 21 * 3 * 2 * c * c
    moved = nbytes(*args, *w, got)
    if serving:       # bfloat16 operands
        bound, bound_by = bound_ms(moved, rest, bf16_flops=products)
    else:             # float32 accuracy: three TF32 products each
        bound, bound_by = bound_ms(moved, rest, tf32_flops=3 * products)
        # every slot's h1 and h2, and the coordinates, on the CUDA cores
        fields['cuda_core_bound_ms'] = round(bound_ms(
            moved, slots * 2 * (2 * c * c + 3 * c) + fusion
            + BATCH * 21 * m * 9)[0], 4)
        fields['bound_note'] = 'products_as_3_tf32_passes'
    fields['held_points'] = points
    log(f'kernel K1 {mode}', max_abs_err=err, tol=tol, slots=slots,
        **fields, lone_joint_ball=lone, in_ball_at_empty_radius=empty,
        ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        bound_ms=round(bound, 4), bound_by=bound_by)
    if not err <= tol:
        raise AssertionError(f'K1 {mode} differs from its plain version '
                             f'by {err}')
    if lone != 1 or empty != 0:
        raise AssertionError('the lone-joint or empty-ball case is not one')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by}


def same_groups(module, pcl_xyz, node_xyz):
    """[B,J] bool: the joints whose groups are the same at every radius
    under K1's rule (d2 < r^2 on the expansion) and K3's (|rel/r|^2 < 1 on
    the gathered differences, or slot 0). The two roundings can put a
    point at the ball's edge on either side."""
    import torch
    from keypointfusion_torch.ops.ball_query import (
        ball_query_group, ball_query_slots,
    )
    from keypointfusion_torch.ops.pairwise import pairwise_sqdist

    sup = torch.cat([pcl_xyz, node_xyz], 1)
    d2 = pairwise_sqdist(node_xyz, sup)
    same = torch.ones(d2.shape[:2], dtype=torch.bool, device=d2.device)

    def members(idx, keep):
        mask = torch.zeros(d2.shape, dtype=torch.bool, device=d2.device)
        return mask.scatter_(2, torch.where(keep, idx, idx[..., :1]), True)

    for r, s in zip(module.radius, module.num_samples):
        k1_group = members(*ball_query_slots(d2, r, s))
        idx, _, rel = ball_query_group(sup, node_xyz, r, s, d2=d2)
        rel = rel / r
        keep = rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1] \
            + rel[..., 2] * rel[..., 2] < 1.0
        keep[..., 0] = True
        same &= (k1_group == members(idx, keep)).all(-1)
    return same


def k3_calls(module, inputs):
    """The arguments of K3's three launches (one per radius) on `inputs`,
    as desa_apply_inference builds them."""
    import torch
    from keypointfusion_torch.models.desa import fold_conv_bn
    from keypointfusion_torch.ops.ball_query import (
        ball_query_group, group_features,
    )
    from keypointfusion_torch.ops.pairwise import pairwise_sqdist

    pcl_feat, node_feat, pcl_xyz, node_xyz = inputs
    sup_xyz = torch.cat([pcl_xyz, node_xyz], 1)
    sup_feat = torch.cat([pcl_feat, node_feat], 1)
    d2 = pairwise_sqdist(node_xyz, sup_xyz)
    calls = []
    with torch.no_grad():
        for i, (r, s) in enumerate(zip(module.radius, module.num_samples)):
            idx, _, rel = ball_query_group(sup_xyz, node_xyz, r, s, d2=d2)
            weights = [t.contiguous() for pair in (
                fold_conv_bn(module.conv_l0_blocks[i], module.bn_l0_blocks[i]),
                fold_conv_bn(module.conv_f0_blocks[i], module.bn_f0_blocks[i]),
                fold_conv_bn(module.conv_blocks[i][0], module.bn_blocks[i][0]))
                for t in pair]
            calls.append(((rel / r).contiguous(),
                          group_features(sup_feat, idx).contiguous(),
                          node_feat, *weights))
    return calls


def check_grouped_mlp_pool(dev, batch, kernels):
    """K3's own path: desa_apply_inference on K1's serving-shape inputs,
    driven once with the launch counters set to 0 just before and read
    just after (one launch per radius), against the same function with
    K3's plain version, and against K1 'highest' on the same module at the
    JAX package's bound on every joint whose groups the two rules make
    alike (at most 1% may differ at a ball's edge). The plain version with
    one TF32 pass per product (cuBLAS, TF32 on, the flag restored after)
    must lie outside K3_TOL. The times are per launch, over the three
    radii's inputs; the phase line adds the kernel's device time
    (torch.profiler), its ptxas report and its launch shape. The bound
    counts the products as three TF32 passes, as the kernel runs them,
    beside the bound on the CUDA cores."""
    import torch
    from keypointfusion_torch.kernels import desa_dense as k1
    from keypointfusion_torch.kernels import grouped_mlp_pool as k3

    inputs, module = desa_inputs(dev, batch)
    with torch.no_grad():
        torch.cuda.synchronize()
        reset(kernels)
        got = k3.desa_apply_inference(module, *inputs)
        torch.cuda.synchronize()
        launches = counts(kernels)
        want = k3.desa_apply_inference(module, *inputs, use_kernel=False)
        k1_out = k1.desa_dense(*inputs, module.folded_weights())
    err = float((got - want).abs().max())
    k1_err = float((got - k1_out).abs().max())
    want_launches = dict.fromkeys(kernels, 0)
    want_launches['grouped_mlp_pool'] = 3
    if launches != want_launches:
        raise AssertionError(f'K3 path launches {launches}, expected '
                             f'{want_launches}')

    pcl_xyz, node_xyz = inputs[2:]
    calls = k3_calls(module, inputs)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = max(float((k3.grouped_mlp_pool_plain(*a)
                              - k3.grouped_mlp_pool(*a)).abs().max())
                       for a in calls)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if not one_pass > K3_TOL:
        raise AssertionError(f'the plain K3 with one TF32 pass lies within '
                             f'{K3_TOL} of the kernel: {one_pass}')
    run = lambda: [k3.grouped_mlp_pool(*a) for a in calls]
    kernel_device_ms = device_ms(run, 20, 'grouped_mlp_pool_kernel') / 3
    ms = cuda_ms(run, 20) / 3
    plain_ms = cuda_ms(
        lambda: [k3.grouped_mlp_pool_plain(*a) for a in calls], 5, 1) / 3
    c = 128
    slots = sum(a[1].shape[0] * a[1].shape[1] * a[1].shape[2] for a in calls)
    groups = sum(a[1].shape[0] * a[1].shape[1] for a in calls) // 3
    moved = sum(nbytes(*a) for a in calls) + 3 * nbytes(got)
    # every slot, as K3 does: two 128 x 128 products, three TF32 passes
    # each, and the coordinate term on the CUDA cores
    bound, bound_by = bound_ms(moved, slots * 2 * 3 * c,
                               tf32_flops=3 * slots * 2 * 2 * c * c)
    bound /= 3
    cuda_core_bound = bound_ms(moved, slots * 2 * (2 * c * c + 3 * c))[0] / 3
    per_block, smem, blocks, threads = k3.kernel_info()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rtol, atol = K3_VS_K1
    same = same_groups(module, pcl_xyz, node_xyz)
    close = ((got - k1_out).abs() <= atol + rtol * k1_out.abs()).all(-1)
    edge = int((~same).sum())
    k1_ok = bool(close[same].all()) and edge <= same.numel() // 100
    log('kernel K3', max_abs_err=err, tol=K3_TOL,
        vs_k1_highest_same_groups=float((got - k1_out)[same].abs().max()),
        vs_k1_tol=json.dumps(K3_VS_K1), joints_with_edge_groups=edge,
        vs_k1_highest_all=k1_err, tf32_1pass_cublas_vs_kernel=one_pass,
        launches=json.dumps(launches), groups_per_block=per_block,
        grid=min(-(-groups // per_block), blocks * sms), threads=threads,
        smem_bytes=smem, blocks_per_sm=blocks,
        kernel_device_ms=round(kernel_device_ms, 5),
        ptxas=json.dumps([ln.strip() for ln in k3.KERNEL.build_log
                          .splitlines() if 'entry function' in ln
                          or 'registers' in ln or 'spill' in ln]),
        ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        bound_ms=round(bound, 4), bound_by=bound_by,
        cuda_core_bound_ms=round(cuda_core_bound, 4),
        bound_note='products_as_3_tf32_passes')
    if not err <= K3_TOL:
        raise AssertionError(f'K3 differs from its plain version by {err}')
    if not k1_ok:
        raise AssertionError(f'K3 path differs from K1 by {k1_err}, '
                             f'{edge} joints with edge groups')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by,
            'launches': launches['grouped_mlp_pool']}


def forward(model, inputs, use_kernels):
    import torch
    model.use_kernels = use_kernels
    with torch.inference_mode():
        res, sw = model(*inputs)
    model.use_kernels = True
    return [t.float() for t in res + sw]


def forward_check(dev, batch, net):
    """KPFusion `net` at batch 64. float32: through the kernels and
    through the plain path, per output, to 1e-4 of its scale. bfloat16
    (the same weights): through the kernels, against the float32 path,
    within twice the bfloat16 plain path's distance from it plus 2^-8 of
    the scale (the budget of tests/test_torch_port_serving_bf16.py).
    Returns (the float32 outputs, {output: float32 error}, {output:
    [bfloat16 kernels' gap, bfloat16 plain gap, kernels vs plain]})."""
    import torch
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.models.kpfusion import build_kpfusion

    inputs = model_inputs(batch, dev)
    model = build_kpfusion(Config(net=net), device=dev, seed=0,
                           dtype=torch.float32)
    got, want = forward(model, inputs, True), forward(model, inputs, False)
    errs = {}
    for name, g, w in zip(OUTPUTS, got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f'{net} {name} is not finite')
        err = float((g - w).abs().max())
        errs[name] = err
        tol = FORWARD_TOL * max(1.0, float(w.abs().max()))
        if not err <= tol:
            raise AssertionError(f'{net} forward {name}: kernels differ '
                                 f'from the plain path by {err} > {tol}')

    model_bf = build_kpfusion(Config(net=net), device=dev, seed=0,
                              dtype=torch.bfloat16)
    got_bf = forward(model_bf, inputs, True)
    plain_bf = forward(model_bf, inputs, False)
    gaps = {}
    for name, g, p, w in zip(OUTPUTS, got_bf, plain_bf, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f'{net} bfloat16 {name} is not finite')
        gap = float((g - w).abs().max())
        plain_gap = float((p - w).abs().max())
        gaps[name] = [gap, plain_gap, float((g - p).abs().max())]
        budget = 2 * plain_gap + 2 ** -8 * max(1.0, float(w.abs().max()))
        if not gap <= budget:
            raise AssertionError(f'{net} bfloat16 forward {name}: {gap} '
                                 f'from float32, over the budget {budget}')
    return got, errs, gaps


def check_forward(dev, batch):
    """KPFusion-resnet-18's forward_check, one line per dtype."""
    got, errs, gaps = forward_check(dev, batch, 'KPFusion-resnet-18')
    log('forward float32', batch=BATCH,
        shapes=json.dumps([tuple(r.shape) for r in got[:6]]),
        max_abs_err=max(errs.values()), per_output=json.dumps(errs))
    log('forward bfloat16', batch=BATCH,
        kernels_vs_f32_plain_vs_f32_kernels_vs_plain=json.dumps(gaps))


def serve(dev, kernels, dtype, net):
    """A main path: StreamingEngine of KPFusion `net` in `dtype` answers
    REQUESTS requests, with every launch counter set to 0 just before and
    read just after. First, one request through the kernels against the
    plain path, with the same point draws: float32 to SERVING_TOL,
    bfloat16 within the budget against the float32 engine's answer.
    Returns the phase line's fields: requests, frames, seconds,
    frames_per_s, launches, and for bfloat16 the pixels K2 'default'
    selects per point."""
    import torch
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.synthetic import synthetic_frames
    from keypointfusion_torch.serving import StreamingEngine

    cfg = Config(net=net)
    eng = StreamingEngine(cfg, batch_size=BATCH, img_hw=(480, 640),
                          dtype=dtype, seed=0)
    rng = np.random.RandomState(0)
    requests = [synthetic_frames(BATCH, rng=rng)
                for _ in range(REQUESTS + 1)]

    r0 = requests[0]
    staged = [torch.from_numpy(r0['depth'].astype(np.int32)).to(dev)] + [
        torch.from_numpy(r0[k]).to(dev)
        for k in ('rgb', 'centers', 'cube', 'cam')]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    uniform = torch.rand((BATCH, eng.cfg.point_num), generator=gen,
                         device=dev)

    def answer(engine, use_kernels):
        engine.model.use_kernels = use_kernels
        packed = engine.pipeline(*staged, uniform=uniform)
        engine.model.use_kernels = True
        return engine._unpack(packed.cpu().numpy())

    # the sampler's inputs in this request, for K2 'default''s spread
    import keypointfusion_torch.models.kpfusion as kpf
    sampled = []

    def recording(*args, **kw):
        sampled.append(args[:2])
        return sampler(*args, **kw)

    sampler = kpf.sample_pixel_features_fused
    kpf.sample_pixel_features_fused = recording
    try:
        got = answer(eng, True)
    finally:
        kpf.sample_pixel_features_fused = sampler
    want = answer(eng, False)
    spread = selection_spread(*sampled[0])
    if dtype == torch.float32:
        for key, tol in SERVING_TOL.items():
            err = float(np.abs(got[key] - want[key]).max())
            if not err <= tol:
                raise AssertionError(f'{net} serving {key}: kernels differ '
                                     f'from the plain path by {err} > {tol}')
    else:
        eng32 = StreamingEngine(cfg, state_dict=eng.model.state_dict(),
                                batch_size=BATCH, img_hw=(480, 640),
                                dtype=torch.float32)
        ref = answer(eng32, False)
        del eng32
        if not np.array_equal(got['M'], ref['M']):
            raise AssertionError(f'{net} bfloat16 serving changed the crop')
        for key, unit in (('joint_xyz_mm', 125.0), ('joint_uvd', 1.0)):
            gap = float(np.abs(got[key] - ref[key]).max())
            budget = 2 * float(np.abs(want[key] - ref[key]).max()) \
                + 2 ** -8 * unit
            if not gap <= budget:
                raise AssertionError(f'{net} bfloat16 serving {key}: {gap} from '
                                     f'float32, over the budget {budget}')

    list(eng.process_stream(iter(requests[:1])))         # warm-up
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    outs = list(eng.process_stream(iter(requests[1:])))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts(kernels)

    if len(outs) != REQUESTS:
        raise AssertionError(f'{net}: {len(outs)} answers to {REQUESTS} '
                             'requests')
    for o in outs:
        if o['joint_xyz_mm'].shape != (BATCH, 21, 3) \
                or o['joint_uvd'].shape != (BATCH, 21, 3) \
                or o['M'].shape != (BATCH, 3, 3):
            raise AssertionError(f'{net}: unexpected output shapes')
        if not all(np.isfinite(v).all() for v in o.values()):
            raise AssertionError(f'{net}: non-finite serving output')
    suffix = '' if dtype == torch.float32 else '_serving'
    want_launches = dict.fromkeys(kernels, 0)
    want_launches['pixel_sampler' + suffix] = REQUESTS
    want_launches['desa_dense' + suffix] = 2 * REQUESTS
    if launches != want_launches:
        raise AssertionError(f'{net} launches {launches}, expected '
                             f'{want_launches}')
    frames = REQUESTS * BATCH
    return dict(requests=REQUESTS, frames=frames, seconds=round(seconds, 4),
                frames_per_s=round(frames / seconds, 1), launches=launches,
                **({} if dtype == torch.float32 else
                   {'k2_default_selected_per_point': spread}))


def check_serving(dev, kernels, card, dtype):
    """serve() of KPFusion-resnet-18, one line."""
    import torch
    stats = serve(dev, kernels, dtype, 'KPFusion-resnet-18')
    log(f'serving {str(dtype).split(".")[-1]}', requests=stats['requests'],
        frames=stats['frames'], seconds=stats['seconds'],
        frames_per_s=stats['frames_per_s'],
        launches=json.dumps(stats['launches']), card=json.dumps(card),
        **({} if dtype == torch.float32 else
           {'k2_default_selected_per_point': json.dumps(
               stats['k2_default_selected_per_point'])}))
    return stats['launches']


class Block2Inputs:
    """Block 2's joints and block 1's 2D feature, recorded on a run through
    the kernels and handed to block 2 on the plain run that follows, so
    that both runs' block 2 takes the same inputs. Block 1's outputs
    differ by some 1e-6 between the kernels and the plain path; a point
    that close to a ball's edge joins a group of block 2 on one path and
    not the other, and moves block 2's outputs past 1e-4 (8.0e-4 on b2_3d
    once in five runs on an H100: trained weights differ from run to run,
    since the card's backward is not deterministic)."""

    def __init__(self, model):
        self.calls, self.replaying = [], None
        self.handle = model.block2.register_forward_pre_hook(self.hook)

    def hook(self, module, args):
        if self.replaying is None:
            self.calls.append((args[3], args[5]))
            return None
        joint, updated = self.calls[self.replaying]
        self.replaying += 1
        return args[:3] + (joint,) + args[4:5] + (updated,) + args[6:]

    def replay(self):
        self.replaying = 0

    def remove(self):
        self.handle.remove()


def state64(model):
    """The model's floating-point state, float64 on the CPU."""
    return {k: v.detach().cpu().double()
            for k, v in model.state_dict().items() if v.is_floating_point()}


def train_step_errors(got, want, start, grads, lr, tol):
    """The state `got` after an SGD step from `start` against `want`, the
    CPU's step from it (state64 dicts; `grads`, the parameters' names to
    the gradients `got` stepped with, zeros where none): 'param': (the
    worst parameter over max(tol['param_rel'] * its scale, tol['lr_floor']
    * lr), its name); 'stat': (the worst running statistic over
    tol['stat_rel'] of its scale, at least 1, its name); 'update':
    |(got - start) - (want - start)| / |want - start| over every parameter
    at once (L2 norms); 'own_update': |(got - start) + lr * grads| /
    |lr * grads|; 'stat_change': as 'update' over the statistics."""
    worst = {True: (0.0, ''), False: (0.0, '')}
    sums = dict.fromkeys(('update', 'own_update', 'stat_change'), (0.0, 0.0))

    def add(line, diff, ref):
        sums[line] = (sums[line][0] + float(diff.square().sum()),
                      sums[line][1] + float(ref.square().sum()))

    for name, y in want.items():
        x, is_param = got[name], name in grads
        e, s = float((x - y).abs().max()), float(y.abs().max())
        limit = (max(tol['param_rel'] * s, tol['lr_floor'] * lr) if is_param
                 else tol['stat_rel'] * max(s, 1.0))
        worst[is_param] = max(worst[is_param], (e / limit, name))
        add('update' if is_param else 'stat_change', x - y, y - start[name])
        if is_param:
            step = lr * grads[name]
            add('own_update', x - start[name] + step, step)
    return {'param': worst[True], 'stat': worst[False],
            **{k: (a / b) ** 0.5 for k, (a, b) in sums.items()}}


def train_step_failures(got, want, start, grads, lr, tol):
    """The lines of train_step_errors that `got` fails, and each control
    (`got`'s step scaled by a TRAIN_CONTROLS factor) that passes an update
    line held (tol[line + '_rel'] not None): no failure when the step
    agrees and every control is caught. Returns (failures, errors,
    {factor: {line: error}} of the controls)."""
    errors = train_step_errors(got, want, start, grads, lr, tol)
    held = [k for k in ('update', 'own_update', 'stat_change')
            if tol[f'{k}_rel'] is not None]
    failures = [k for k in held if not errors[k] <= tol[f'{k}_rel']]
    failures += [k for k in ('param', 'stat') if not errors[k][0] <= 1]
    controls = {}
    for f in TRAIN_CONTROLS:
        scaled = {k: start[k] + f * (x - start[k]) for k, x in got.items()}
        e = train_step_errors(scaled, want, start, grads, lr, tol)
        controls[f] = {k: e[k] for k in held}
        failures += [f'control {f}: {k} passed' for k in held
                     if e[k] <= tol[f'{k}_rel']]
    return failures, errors, controls


def step_grads(model):
    """The gradients the model's last step took, float64 on the CPU,
    zeros where none reached."""
    import torch
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad)
            .detach().cpu().double() for k, p in model.named_parameters()}


def compare_steps(sides, compute_dtype, net, batch_size, **cfg_kw):
    """One SGD-momentum step of KPFusion `net` at `batch_size` with 256
    points, dropout 0, on each of two sides (device, DESA's dense_train)
    from the same weights: the second side's loss, every parameter, every
    running statistic, the update over all parameters and the statistics'
    change within TRAIN_TOL[compute_dtype] of the first side's, and the
    controls (TRAIN_CONTROLS) outside it. cfg_kw: more Config fields.
    Returns the phase line's dict."""
    import torch
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.models.desa import set_dense_train
    from keypointfusion_torch.training.train_step import (
        batch_to_device, create_train_state, make_train_step,
    )

    tol = TRAIN_TOL[compute_dtype]
    cfg = Config(net=net, compute_dtype=compute_dtype, opt='sgd',
                 lr=TRAIN_LR, **cfg_kw)
    small = synthetic_batch(batch_size=batch_size, point_num=256, seed=42)
    stepped = []
    for where, dense in sides:
        b = batch_to_device(small, where)
        state = create_train_state(cfg, b, device=where, seed=0,
                                   dropout=0.0)
        set_dense_train(state.model, dense)
        start = state64(state.model)
        with torch.backends.mkldnn.flags(enabled=False):
            state, metrics = make_train_step(cfg)(state, b, None, 0)
        stepped.append((state.model, float(metrics['loss']), start))
    (ref_model, ref_loss, start), (got_model, got_loss, got_start) = \
        stepped
    what = f'train {net} {compute_dtype} {cfg_kw}: {sides[1]} against ' \
        f'{sides[0]}'
    if any(not torch.equal(got_start[k], t) for k, t in start.items()):
        raise AssertionError(f'{what}: the two start from different weights')
    loss_err = abs(got_loss - ref_loss) / abs(ref_loss)
    failures, errors, controls = train_step_failures(
        state64(got_model), state64(ref_model), start,
        step_grads(got_model), TRAIN_LR, tol)
    if not loss_err <= tol['loss_rel']:
        failures.append('loss')
    if failures:
        raise AssertionError(
            f'{what}: the steps differ: {failures}; loss {loss_err}, '
            f'{errors}, controls {controls}; tolerance {tol}')
    return {'batch': batch_size, 'lr': TRAIN_LR, 'loss_rel': loss_err,
            'worst_param_over_tol': errors['param'][0],
            'param': errors['param'][1],
            'worst_stat_over_tol': errors['stat'][0],
            'stat': errors['stat'][1], 'update_rel': errors['update'],
            'own_update_rel': errors['own_update'],
            'stat_change_rel': errors['stat_change'],
            'controls': {str(f): c for f, c in controls.items()},
            'tol': tol}


def card_vs_cpu_step(dev, compute_dtype, net, batch_size, **cfg_kw):
    """compare_steps of the card's step against the CPU's (the port's own
    step; this machine has no JAX). Returns the phase line's
    'card_vs_cpu' dict."""
    return compare_steps([('cpu', False), (dev, False)], compute_dtype, net,
                         batch_size, **cfg_kw)


def timed_train_steps(dev, kernels, compute_dtype, net, batch_size=BATCH,
                      dense_train=False, **cfg_kw):
    """KPFusion `net`'s train step at `batch_size`, 1024 points, full
    width, AdamW, dropout 0.1 from a CUDA generator, DESA's dense_train
    as given, cfg_kw more Config fields: TRAIN_WARMUP steps, then
    TRAIN_STEPS timed by CUDA events; peak memory; every loss finite. The
    launch counters, set to 0 before the steps, read 0 after them (the
    kernels are eval-only). Returns (state, batch, cfg, the phase line's
    fields)."""
    import torch
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.training.train_step import (
        batch_to_device, create_train_state, make_train_step,
    )

    from keypointfusion_torch.models.desa import set_dense_train

    cfg = Config(net=net, compute_dtype=compute_dtype, **cfg_kw)
    batch = batch_to_device(
        synthetic_batch(batch_size=batch_size, point_num=1024, seed=2), dev)
    state = create_train_state(cfg, batch, device=dev, seed=0)
    set_dense_train(state.model, dense_train)
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, batch, gen, 0)
        losses.append(metrics['loss'])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, batch, gen, 0)
        losses.append(metrics['loss'])
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / TRAIN_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_launches = counts(kernels)
    losses = [float(x) for x in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f'train {net} {compute_dtype}: losses {losses}')
    if any(step_launches.values()):
        raise AssertionError(f'train {net} {compute_dtype}: the train steps '
                             f'launched {step_launches}')
    return state, batch, cfg, {
        'ms_per_step': round(ms, 3), 'timed_steps': TRAIN_STEPS,
        'peak_gib': round(peak_gib, 3),
        'losses': [round(x, 5) for x in losses],
        'step_launches': step_launches}


def check_train(dev, kernels, card, compute_dtype):
    """A main path: the train step of KPFusion-resnet-18 in
    `compute_dtype` ('float32', TF32 off; 'mixed': bfloat16 backbones; or
    'bfloat16': the whole model).
    1. card_vs_cpu_step at batch 2.
    2. timed_train_steps at batch 64.
    3. .eval() and one eval step on the trained weights, counters set to 0
       just before: K2 once and K1 once per block, in their 'highest'
       modes under a float32 head ('float32', 'mixed'), within FORWARD_TOL
       of the plain path, block 2 taking the same inputs on both paths
       (Block2Inputs); in their 'default' modes in 'bfloat16', within
       check_forward's bfloat16 budget against the float32 plain path on
       the same weights."""
    import torch
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.models.kpfusion import build_kpfusion
    from keypointfusion_torch.training.train_step import (
        TrainState, make_eval_step,
    )

    net = 'KPFusion-resnet-18'
    card_vs_cpu = card_vs_cpu_step(dev, compute_dtype, net, 2)
    state, batch, cfg, timed = timed_train_steps(dev, kernels,
                                                 compute_dtype, net)

    evaluate = make_eval_step(cfg)
    head_f32 = state.model.dtype == torch.float32
    if head_f32:
        block2 = Block2Inputs(state.model)
    reset(kernels)
    got = evaluate(state, batch)
    eval_launches = counts(kernels)
    suffix = '' if head_f32 else '_serving'
    want_launches = dict.fromkeys(kernels, 0)
    want_launches.update({'pixel_sampler' + suffix: 1,
                          'desa_dense' + suffix: 2})
    if eval_launches != want_launches:
        raise AssertionError(f'eval after training launched '
                             f'{eval_launches}, expected {want_launches}')
    state.model.use_kernels = False
    if head_f32:
        block2.replay()
    want = evaluate(state, batch)
    state.model.use_kernels = True
    if head_f32:
        block2.remove()
    else:
        # the bfloat16 forward's budget (check_forward) against the
        # float32 plain path on the trained weights
        f32 = build_kpfusion(Config(), device=dev, seed=0,
                             dtype=torch.float32)
        f32.load_state_dict(state.model.state_dict())
        ref = make_eval_step(Config())(TrainState(f32, None, None), batch)
        del f32
    errs = {}
    for i, (name, g, w) in enumerate(zip(OUTPUTS, got[0] + got[1],
                                         want[0] + want[1])):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f'eval after training: {name} not finite')
        errs[name] = float((g - w).abs().max())
        if head_f32:
            limit = FORWARD_TOL * max(1.0, float(w.abs().max()))
        else:
            r = (ref[0] + ref[1])[i].float()
            errs[name] = float((g - r).abs().max())
            limit = 2 * float((w - r).abs().max()) \
                + 2 ** -8 * max(1.0, float(r.abs().max()))
        if not errs[name] <= limit:
            raise AssertionError(f'eval after training {name}: kernels '
                                 f'differ from the plain path by '
                                 f'{errs[name]} > {limit}')
    log('train', dtype=compute_dtype, batch=BATCH, points=1024,
        card_vs_cpu=json.dumps(card_vs_cpu),
        ms_per_step=timed['ms_per_step'], timed_steps=TRAIN_STEPS,
        peak_gib=timed['peak_gib'], losses=json.dumps(timed['losses']),
        step_launches=json.dumps(timed['step_launches']),
        eval_launches=json.dumps(eval_launches),
        eval_max_abs_err=max(errs.values()), card=json.dumps(card))
    del state


MOMENTS = ('exp_avg', 'exp_avg_sq')


def trainer_state(trainer):
    """A trainer's parameters, running statistics, AdamW moments (float64
    on the CPU) and step counts."""
    model = trainer.state.model
    opt = trainer.state.optimizer.state
    out = {'params': {k: p.detach().cpu().double()
                      for k, p in model.named_parameters()},
           'stats': {k: v.detach().cpu().double() for k, v in
                     model.named_buffers() if v.is_floating_point()},
           'step': trainer.state.step,
           'adam_steps': sorted({int(s['step']) for s in opt.values()})}
    for m in MOMENTS:
        out[m] = {k: opt[p][m].detach().cpu().double()
                  for k, p in model.named_parameters() if p in opt}
    return out


def resume_errors(got, want, start):
    """L2 over every tensor at once: the parameters' and the statistics'
    distance from `want` over how far `want` moved from `start`, each
    moment's distance over its size."""
    out = {}
    for group in RESUME_TOL:
        diff = ref = 0.0
        for k, w in want[group].items():
            diff += float((got[group][k] - w).square().sum())
            base = w if group in MOMENTS else w - start[group][k]
            ref += float(base.square().sum())
        out[group] = (diff / ref) ** 0.5
    return out


def same_state(a, b):
    """Whether two trainer_state()s are equal bit for bit."""
    import torch
    return a['step'] == b['step'] and a['adam_steps'] == b['adam_steps'] \
        and all(torch.equal(a[g][k], b[g][k])
                for g in RESUME_TOL for k in b[g])


def resume_runs(make, cfg, start, end, train=lambda t: t.train()):
    """The resume check of a straight run from `start` to `end` (both
    trainer_state()s): a one-epoch run (`make(name, cfg)` builds a
    Trainer), a new Trainer with resume=True, which must hold the
    checkpoint's state bit for bit and is trained by `train`, and a
    control resumed without the optimizer's state. Returns (failures,
    errors, control errors, the resumed Trainer)."""
    import dataclasses
    from keypointfusion_torch.training.train_step import make_optimizer
    first = make('resumed', dataclasses.replace(cfg, epochs=1))
    first.train()
    resumed = make('resumed', dataclasses.replace(cfg, resume=True))
    control = make('resumed', dataclasses.replace(cfg, resume=True))
    failures = []
    if resumed.start_epoch != 1 \
            or not same_state(trainer_state(resumed), trainer_state(first)):
        failures.append('the restored state is not the saved one')
    control.state.optimizer = make_optimizer(
        cfg, control.state.model.parameters(),
        len(first.train_data) // cfg.batch_size)[0]
    train(resumed)
    control.train()
    got = trainer_state(resumed)
    errors = resume_errors(got, end, start)
    control_errors = resume_errors(trainer_state(control), end, start)
    failures += [k for k, e in errors.items() if not e <= RESUME_TOL[k]]
    failures += [f'control passed {k}' for k, e in control_errors.items()
                 if e <= RESUME_TOL[k]]
    if (got['step'], got['adam_steps']) != (end['step'], end['adam_steps']):
        failures.append('step')
    return failures, errors, control_errors, resumed


class TrainerProbe:
    """Host time of each train step, the host's waits for the card
    (torch.cuda.set_sync_debug_mode) in each step and by where the
    trainer was (steps, the loop between them, test(), checkpoints), and
    the launches of each test()."""

    def __init__(self, trainer, kernels):
        self.trainer = trainer
        self.step_ms, self.step_waits = [], []
        self.waits, self.where = collections.Counter(), 'loop'
        self.loop_sites = collections.Counter()
        self.test_launches = []
        step, test, save = trainer.train_step, trainer.test, \
            trainer.ckpt.save

        def timed_step(*args):
            self.where, before = 'step', self.waits['step']
            t0 = time.perf_counter()
            out = step(*args)
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            self.step_waits.append(self.waits['step'] - before)
            self.where = 'loop'
            return out

        def counted_test(*args):
            self.where = 'test'
            reset(kernels)
            out = test(*args)
            self.test_launches.append(counts(kernels))
            self.where = 'loop'
            return out

        def counted_save(*args):
            self.where = 'checkpoint'
            out = save(*args)
            self.where = 'loop'
            return out

        trainer.train_step, trainer.test = timed_step, counted_test
        trainer.ckpt.save = counted_save

    def run(self, fn):
        """fn() with every wait for the card counted where it fell."""
        import torch
        with warnings.catch_warnings():
            warnings.simplefilter('always')
            original = warnings.showwarning

            def show(message, category, filename, lineno, *args, **kw):
                if 'synchroniz' in str(message):
                    self.waits[self.where] += 1
                    if self.where == 'loop':
                        self.loop_sites[f'{filename}:{lineno}'] += 1
                else:
                    original(message, category, filename, lineno, *args,
                             **kw)
            # the mode's own notice, when it is first set, is no wait
            torch.cuda.set_sync_debug_mode('warn')
            warnings.showwarning = show
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode('default')
                warnings.showwarning = original

    def train(self):
        return self.run(self.trainer.train)


def check_trainer(dev, kernels, card):
    """A main path: training/trainer.py's Trainer, float32, KPFusion-
    resnet-18 at full width and depth, batch 64, 1024 points, random
    weights from seed 0, on in-memory synthetic datasets: a train set of
    TRAINER_TRAIN samples (4 steps an epoch) and a test set of
    TRAINER_TEST (a full batch and one of 40, padded).
    1. A straight run of TRAINER_EPOCHS epochs (test() after each, best
       and latest checkpoints): host ms per step, peak memory; test()'s
       launches per call, counters set to 0 just before and read just
       after: K2 'highest' once and K1 'highest' twice per batch.
    2. resume_runs: a one-epoch run, then a new Trainer with resume=True
       (holding the checkpoint's state bit for bit) and its second epoch,
       the host's waits for the card counted by where they fell. Its
       parameters, statistics and AdamW moments against the straight
       run's within RESUME_TOL, its step counts equal; a control that
       resumes everything but the optimizer's state must fail every
       limit.
    3. test() of the straight run through the kernels and again with
       use_kernels=False, block 2 taking the same inputs on both
       (Block2Inputs): every stage's error and PA error of every sample
       and joint within TRAINER_MM_TOL, the dumps within it plus their
       print unit.
    4. evaluation()'s pred.json holds [104, 21, 3] joints and [104, 778,
       3] meshes; the best and latest checkpoints exist."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import torch
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.pipeline import collate
    from keypointfusion_torch.data.synthetic import synthetic_dataset
    from keypointfusion_torch.training.train_step import (
        batch_to_device, create_train_state, make_train_step,
    )
    from keypointfusion_torch.training.trainer import Trainer

    @dataclasses.dataclass(frozen=True)
    class TrainerConfig(Config):
        epochs: int = TRAINER_EPOCHS

        @property
        def max_epoch(self) -> int:
            return self.epochs

    cfg = TrainerConfig(batch_size=BATCH, point_num=1024, seed=0,
                        pretrain='')
    train_set = synthetic_dataset(TRAINER_TRAIN, 1024, seed=1000)
    test_set = synthetic_dataset(TRAINER_TEST, 1024, seed=5000)
    root = tempfile.mkdtemp(prefix='kpf_trainer_')
    try:
        make = lambda name, c=cfg: Trainer(
            c, train_set, test_set, model_dir=os.path.join(root, name),
            device=dev)

        straight = make('straight')
        start = trainer_state(straight)
        probe = TrainerProbe(straight, kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        probe.train()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want_test = dict.fromkeys(kernels, 0)
        want_test.update(pixel_sampler=2, desa_dense=4)
        if any(c != want_test for c in probe.test_launches) \
                or len(probe.test_launches) != TRAINER_EPOCHS:
            raise AssertionError(f'test() launched {probe.test_launches}, '
                                 f'expected {want_test} per call')
        end = trainer_state(straight)

        # the bare step in the same conditions: make_train_step on one
        # batch, no loader, host time and waits per call
        state = create_train_state(cfg, train_set[0], device=dev, seed=0)
        batch = batch_to_device(collate(train_set[:BATCH]), dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        step = make_train_step(cfg)
        step(state, batch, gen, 0)                       # warm-up
        bare = types.SimpleNamespace(train_step=step, test=None,
                                     ckpt=types.SimpleNamespace(save=None))
        bare_probe = TrainerProbe(bare, kernels)
        bare_probe.run(lambda: [bare.train_step(state, batch, gen, 0)
                                for _ in range(len(probe.step_ms))])
        del state, bare

        probes = []

        def probed(trainer):
            probes.append(TrainerProbe(trainer, kernels))
            return probes[-1].train()
        failures, errors, control_errors, resumed = resume_runs(
            make, cfg, start, end, probed)
        resumed_probe = probes[0]
        if max(resumed_probe.step_waits[1:]) > max(probe.step_waits[1:]):
            failures.append('the resumed steps wait for the card more')
        if probe.waits['loop'] > TRAINER_EPOCHS \
                or resumed_probe.waits['loop'] > 1:
            failures.append('the loop waits for the card')
        if failures:
            raise AssertionError(f'resume: {failures}; errors {errors}, '
                                 f'control {control_errors}, tolerance '
                                 f'{RESUME_TOL}; waits straight '
                                 f'{probe.step_waits}, {dict(probe.waits)}, '
                                 f'{dict(probe.loop_sites)}, resumed '
                                 f'{resumed_probe.step_waits}, '
                                 f'{dict(resumed_probe.waits)}')

        rows, dumps = [], []
        stage_results = straight._stage_results

        def record(batch):
            out = stage_results(batch)
            rows.append(out)
            return out
        straight._stage_results = record
        block2 = Block2Inputs(straight.state.model)
        reset(kernels)
        straight.test()
        test_launches = counts(kernels)
        for use_kernels in (True, False):
            straight.state.model.use_kernels = use_kernels
            if not use_kernels:
                block2.replay()
                straight.test()
            dumps.append([np.loadtxt(os.path.join(
                straight.model_dir, f'test_{i}.txt'))
                for i in range(len(cfg.stage_type))])
        straight.state.model.use_kernels = True
        block2.remove()
        if test_launches != want_test:
            raise AssertionError(f'test() launched {test_launches}, '
                                 f'expected {want_test}')
        n = len(rows) // 2
        got, want = rows[:n], rows[n:]
        test_err = {'err_mm': 0.0, 'pa_mm': 0.0, 'dump_mm': 0.0}
        for g, w in zip(got, want):
            if not np.isfinite(g).all():
                raise AssertionError('test(): non-finite results')
            test_err['err_mm'] = max(test_err['err_mm'],
                                     float(np.abs(g[..., 0] - w[..., 0]).max()))
            test_err['pa_mm'] = max(test_err['pa_mm'],
                                    float(np.abs(g[..., 1] - w[..., 1]).max()))
        for g, w in zip(*dumps):
            if g.shape != (TRAINER_TEST, 63) or w.shape != g.shape:
                raise AssertionError(f'test() dump of shape {g.shape}')
            test_err['dump_mm'] = max(test_err['dump_mm'],
                                      float(np.abs(g - w).max()))
        if not (test_err['err_mm'] <= TRAINER_MM_TOL
                and test_err['pa_mm'] <= TRAINER_MM_TOL
                and test_err['dump_mm'] <= TRAINER_MM_TOL + 1e-3):
            raise AssertionError(f'test() through the kernels differs from '
                                 f'the plain path: {test_err}')

        with open(straight.evaluation()) as f:
            joints, meshes = (np.array(x) for x in json.load(f))
        if joints.shape != (TRAINER_TEST, 21, 3) \
                or meshes.shape != (TRAINER_TEST, 778, 3) \
                or not np.isfinite(joints).all():
            raise AssertionError(f'pred.json holds {joints.shape}, '
                                 f'{meshes.shape}')
        for t in (straight, resumed):
            for name in ('best', 'latest'):
                if not os.path.isfile(t.ckpt.path(name)):
                    raise AssertionError(f'no {name} checkpoint')
        log('trainer', dtype='float32', batch=BATCH, points=1024,
            train_samples=TRAINER_TRAIN, test_samples=TRAINER_TEST,
            epochs=TRAINER_EPOCHS, wall_s=round(wall_s, 3),
            host_ms_per_step=json.dumps([round(x, 3)
                                         for x in probe.step_ms]),
            host_ms_per_step_after_first=round(float(
                np.mean(probe.step_ms[1:])), 3),
            bare_host_ms_per_step=json.dumps([round(x, 3)
                                              for x in bare_probe.step_ms]),
            bare_host_ms_mean=round(float(np.mean(bare_probe.step_ms)), 3),
            peak_gib=round(peak_gib, 3),
            waits_per_step=json.dumps({
                'straight': probe.step_waits,
                'resumed': resumed_probe.step_waits,
                'bare': bare_probe.step_waits}),
            waits=json.dumps({'straight': dict(probe.waits),
                              'resumed': dict(resumed_probe.waits)}),
            resume=json.dumps({'errors': errors,
                               'control': control_errors,
                               'tol': RESUME_TOL}),
            test_launches=json.dumps(test_launches),
            test_kernels_vs_plain=json.dumps(test_err),
            tol_mm=TRAINER_MM_TOL, pred_json=json.dumps(
                [list(joints.shape), list(meshes.shape)]),
            min_error=round(straight.min_error, 4), card=json.dumps(card))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_dexycb_tree(root, fixture, n_train, n_test, seed=0):
    """A DexYCB-layout tree under root whose annotations reference the
    fixture's four frames (its imgs directory linked) n_train and n_test
    times: joints jittered from the fixture's by a seed, right and left
    hands in turn for every frame."""
    import os
    base = os.path.join(root, 'DexYCB')
    os.makedirs(os.path.join(base, 'annotations'))
    os.symlink(os.path.abspath(os.path.join(fixture, 'DexYCB', 'imgs')),
               os.path.join(base, 'imgs'))
    with open(os.path.join(fixture, 'DexYCB', 'annotations',
                           'DEX_YCB_s0_test_data.json')) as f:
        db = json.load(f)
    rng = np.random.RandomState(seed)
    frames = len(db['images'])
    for split, n in (('train', n_train), ('test', n_test)):
        images, anns = [], []
        for k in range(n):
            image = dict(db['images'][k % frames], id=k)
            ann = dict(db['annotations'][k % frames], id=k, image_id=k)
            ann['joints_coord_cam'] = (np.asarray(ann['joints_coord_cam'])
                                       + rng.uniform(-8, 8, (21, 3))
                                       ).tolist()
            ann['hand_type'] = ('right', 'left')[(k + k // frames) % 2]
            images.append(image)
            anns.append(ann)
        with open(os.path.join(base, 'annotations',
                               f'DEX_YCB_s0_{split}_data.json'), 'w') as f:
            json.dump({'images': images, 'annotations': anns}, f)


class Prefix:
    """The first n samples of a dataset."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i]


class StepClock:
    """While active, every train step made by training/trainer.py's
    make_train_step records its host start and end times."""

    def __init__(self):
        self.starts, self.ends = [], []

    def __enter__(self):
        from keypointfusion_torch.training import trainer as module
        self.module, self.original = module, module.make_train_step

        def make(*args):
            step = self.original(*args)

            def timed(*args):
                self.starts.append(time.perf_counter())
                out = step(*args)
                self.ends.append(time.perf_counter())
                return out
            return timed
        module.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.module.make_train_step = self.original

    def figures(self):
        """ms: each step's host time, the time from its start to the next
        step's and the wait for the loader between them; their means over
        the steps after the first while the loader still loads, and over
        the last DATA_AHEAD steps, when it is done."""
        host = [(e - s) * 1e3 for s, e in zip(self.starts, self.ends)]
        gaps = [(b - a) * 1e3 for a, b in zip(self.starts, self.starts[1:])]
        waits = [(b - a) * 1e3 for a, b in zip(self.ends, self.starts[1:])]
        done = len(host) - DATA_AHEAD
        r = lambda xs: [round(x, 3) for x in xs]
        mean = lambda xs: round(float(np.mean(xs)), 3)
        return {'host_ms': r(host), 'step_to_step_ms': r(gaps),
                'loader_wait_ms': r(waits),
                'loading': {'steps': [2, done],
                            'host_ms': mean(host[1:done]),
                            'step_to_step_ms': mean(gaps[1:done]),
                            'loader_wait_ms': mean(waits[1:done])},
                'loader_done': {'steps': [done + 1, len(host)],
                                'host_ms': mean(host[done:]),
                                'step_to_step_ms': mean(gaps[done:]),
                                'loader_wait_ms': mean(waits[done:])}}


def printed_errors(text):
    return [float(v) for v in
            __import__('re').findall(r'\[mean_Error ([-0-9.]+)\]', text)]


def check_data(dev, kernels, card):
    """The host data path and the command line, on the card's machine
    (no cv2, no JAX): the committed fixture (tests/fixtures/
    torch_port_dexycb, scripts/make_torch_port_fixture.py) and a
    DexYCB-layout tree of DATA_TRAIN / DATA_TEST annotations over its
    frames in a temporary directory.
    1. Decoders: each of the fixture's JPEG and PNG-16 files decoded by
       data/image_io.py against cv2's decode stored beside it (tolerance
       0: max |d| and the pixels that differ); one thread's ms a decode.
    2. Samples: the port's DexYCBDataset on the fixture (seed 7, train
       indices 1, 2 then test 0, 3) against the JAX package's samples
       stored beside it (DATA_SAMPLE_TOL).
    3. Loader: __getitem__'s ms a sample on one thread (train and test
       split), and BatchLoader's samples/s over DATA_SCALING_SAMPLES
       training samples at DATA_THREADS threads, os.cpu_count() beside.
    4. Training: keypointfusion_torch.train.main(['--phase', 'train',
       ...]) on the tree, float32, batch 64, 1024 points, one epoch of
       DATA_TRAIN / 64 steps (and its test()): each step's host ms, the
       time from step to step and the wait for the loader (StepClock),
       then the bare step on one of the loader's batches in the same
       call, and the loader's ms a batch at 8 threads from 3.; test()'s
       launches, counters set to 0 just before main() and read just
       after: K2 'highest' once and K1 'highest' twice a batch.
    5. Testing: python -m keypointfusion_torch.train --phase test
       --load_model best --loader_threads 1 as a subprocess: exit code 0,
       the test split loaded, its K1/K2 'highest' launches from its
       summary line, and its printed errors against an in-process test()
       of the same checkpoint (one loader thread too, so that both draw
       the same point samples) within TRAINER_MM_TOL plus the print
       unit, its result within TRAINER_MM_TOL."""
    import contextlib
    import dataclasses
    import io
    import os
    import shutil
    import tempfile
    import torch
    from keypointfusion_torch import train as cli
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.datasets import DexYCBDataset
    from keypointfusion_torch.data.image_io import DECODER, imread
    from keypointfusion_torch.data.pipeline import BatchLoader, collate
    from keypointfusion_torch.training.train_step import (
        batch_to_device, create_train_state, make_train_step,
    )
    from keypointfusion_torch.training.trainer import Trainer

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           DATA_FIXTURE)
    t0 = time.perf_counter()
    DECODER.load()
    decoder_build_s = time.perf_counter() - t0

    # 1. decoders against cv2's decode
    decoded = np.load(os.path.join(fixture, 'decoded.npz'))
    imgs = os.path.join(fixture, 'DexYCB', 'imgs')
    decode = {'max_abs': 0, 'pixels_differing': 0, 'files': 0}
    decode_ms = {'jpeg': [], 'png16': []}
    for name in decoded.files:
        colour = name.startswith('color_')
        path = os.path.join(imgs, name + ('.jpg' if colour else '.png'))
        want = decoded[name]
        got = imread(path, anydepth=not colour)
        if got is None or got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f'{path}: decoded to '
                                 f'{None if got is None else got.shape}')
        diff = np.abs(got.astype(np.int64) - want)
        decode['max_abs'] = max(decode['max_abs'], int(diff.max()))
        decode['pixels_differing'] += int(
            (diff.reshape(diff.shape[0], diff.shape[1], -1) > 0)
            .any(-1).sum())
        decode['files'] += 1
        times = []
        for _ in range(10):
            t = time.perf_counter()
            imread(path, anydepth=not colour)
            times.append((time.perf_counter() - t) * 1e3)
        decode_ms['jpeg' if colour else 'png16'].append(
            float(np.median(times)))
    if decode['max_abs'] != 0:
        raise AssertionError(f'decoders differ from cv2: {decode}')

    # 2. the fixture's samples against the JAX package's
    stored = np.load(os.path.join(fixture, 'samples.npz'))
    sample_err, bit_for_bit = {}, True
    for split, indices in (('train', (1, 2)), ('test', (0, 3))):
        ds = DexYCBDataset('s0', split, fixture, sample_num=1024, seed=7)
        for i in indices:
            got = ds[i]
            for k, v in got.items():
                want = stored[f'{split}_{i}_{k}']
                err = float(np.abs(v.astype(np.float64) - want).max())
                sample_err[k] = max(sample_err.get(k, 0.0), err)
                bit_for_bit &= bool(np.array_equal(v, want))
    if sample_err['rgb'] != 0.0 or max(sample_err.values()) > \
            DATA_SAMPLE_TOL:
        raise AssertionError(f'samples differ from the JAX package\'s: '
                             f'{sample_err}')

    root = tempfile.mkdtemp(prefix='kpf_data_')
    try:
        write_dexycb_tree(root, fixture, DATA_TRAIN, DATA_TEST)
        # 3. the loader, one thread, then by threads
        getitem_ms = {}
        for split in ('train', 'test'):
            ds = DexYCBDataset('s0', split, root, sample_num=1024)
            ds[0]                                   # lazy imports
            n = min(16, len(ds))
            t = time.perf_counter()
            for i in range(n):
                ds[i]
            getitem_ms[split] = round((time.perf_counter() - t) / n * 1e3,
                                      3)
        scaling = {}
        for threads in DATA_THREADS:
            ds = Prefix(DexYCBDataset('s0', 'train', root, sample_num=1024),
                        DATA_SCALING_SAMPLES)
            loader = BatchLoader(ds, BATCH, shuffle=True,
                                 num_workers=threads, seed=0)
            t = time.perf_counter()
            n = sum(len(b['rgb']) for b in loader)
            scaling[threads] = round(n / (time.perf_counter() - t), 2)

        # 4. training through the command line
        @dataclasses.dataclass(frozen=True)
        class DataConfig(Config):
            epochs: int = 1

            @property
            def max_epoch(self) -> int:
                return self.epochs

        save = os.path.join(root, 'runs')
        common = ['--dataset', 'dexycb', '--root_dir', root,
                  '--batch_size', str(BATCH), '--point_num', '1024',
                  '--pretrain', '', '--seed', '0', '--save_dir', save,
                  '--model_save', 'data']
        out = io.StringIO()
        reset(kernels)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with StepClock() as clock, contextlib.redirect_stdout(out):
            trainer, _ = cli.main(['--phase', 'train', *common], device=dev,
                                  config=DataConfig)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        train_launches = counts(kernels)
        summary = json.loads(out.getvalue().strip().splitlines()[-1])
        steps = DATA_TRAIN // BATCH
        want_test = dict.fromkeys(kernels, 0)
        want_test.update(pixel_sampler=2, desa_dense=4)
        if summary['train_samples'] != DATA_TRAIN \
                or summary['test_samples'] != DATA_TEST \
                or len(clock.starts) != steps \
                or trainer.state.step != steps:
            raise AssertionError(f'the CLI trained {len(clock.starts)} '
                                 f'steps: {summary}')
        if train_launches != want_test \
                or summary['kernel_launches'] != want_test:
            raise AssertionError(f'train()\'s test() launched '
                                 f'{train_launches}, expected {want_test}')
        if not np.isfinite(summary['result']):
            raise AssertionError(f'training gave {summary["result"]}')
        trainer_figures = clock.figures()

        # the bare step on one of the loader's batches, same call
        cfg = DataConfig(batch_size=BATCH, point_num=1024, seed=0,
                         pretrain='')
        batch = next(iter(BatchLoader(trainer.train_data, BATCH)))
        del trainer
        state = create_train_state(cfg, collate([{
            k: v[0] for k, v in batch.items()}]), device=dev, seed=0)
        batch = batch_to_device(batch, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        step = make_train_step(cfg)
        step(state, batch, gen, 0)                       # warm-up
        bare = []
        for _ in range(5):
            t = time.perf_counter()
            step(state, batch, gen, 0)
            bare.append((time.perf_counter() - t) * 1e3)
        del state, batch

        # 5. --phase test as a subprocess, against test() in-process
        test_args = ['--phase', 'test', '--load_model', 'best', *common,
                     '--loader_threads', '1']
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'keypointfusion_torch.train',
             *test_args], capture_output=True, text=True, timeout=900)
        test_s = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f'--phase test exited {proc.returncode}:\n'
                                 f'{proc.stdout[-3000:]}\n'
                                 f'{proc.stderr[-3000:]}')
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        if sub['test_samples'] != DATA_TEST \
                or sub['kernel_launches'] != want_test:
            raise AssertionError(f'--phase test: {sub}, expected '
                                 f'{DATA_TEST} samples and {want_test}')
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            local = Trainer(cli.parse_config(test_args), device=dev,
                            loader_threads=1)
            local_error = local.test()
        got, want = printed_errors(proc.stdout), printed_errors(
            out.getvalue())
        test_vs = {'result_mm': abs(sub['result'] - local_error),
                   'printed_mm': max((abs(a - b) for a, b in zip(got, want)),
                                     default=float('inf'))}
        if len(got) != 6 or len(want) != 6 \
                or test_vs['result_mm'] > TRAINER_MM_TOL \
                or test_vs['printed_mm'] > TRAINER_MM_TOL + 1e-3:
            raise AssertionError(f'--phase test printed {got}, in-process '
                                 f'{want}: {test_vs}')
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log('data', decoder_build_s=round(decoder_build_s, 3),
        decode=json.dumps(decode),
        decode_ms=json.dumps({k: [round(x, 3) for x in v]
                              for k, v in decode_ms.items()}),
        samples_max_err=json.dumps(sample_err), sample_tol=DATA_SAMPLE_TOL,
        samples_bit_for_bit=bit_for_bit,
        getitem_ms=json.dumps(getitem_ms),
        loader_samples_per_s=json.dumps(scaling),
        loader_ms_per_batch_8_threads=round(BATCH / scaling[8] * 1e3, 3),
        cpu_count=os.cpu_count(), batch=BATCH,
        train_samples=DATA_TRAIN, test_samples=DATA_TEST,
        cli_train_s=round(train_s, 3), trainer=json.dumps(trainer_figures),
        bare_host_ms=json.dumps([round(x, 3) for x in bare]),
        bare_host_ms_mean=round(float(np.mean(bare)), 3),
        train_test_launches=json.dumps(train_launches),
        cli_test=json.dumps({'seconds': round(test_s, 3),
                             'launches': sub['kernel_launches'],
                             'result_mm': sub['result'],
                             'printed_mm': got}),
        cli_test_vs_in_process=json.dumps(test_vs), tol_mm=TRAINER_MM_TOL,
        card=json.dumps(card))


def demo_frame(index=0, pad=12):
    """(input dict, camera) of the DexYCB fixture's test frame `index`
    (DATA_FIXTURE): colour and depth read by data/image_io.py, the bbox
    around its annotated joints projected to pixels, padded by `pad`."""
    import os
    from keypointfusion_torch.data.image_io import imread
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        DATA_FIXTURE, 'DexYCB')
    with open(os.path.join(root, 'annotations',
                           'DEX_YCB_s0_test_data.json')) as f:
        ann = json.load(f)['annotations'][index]
    (fx, fy), (fu, fv) = (ann['cam_param']['focal'],
                          ann['cam_param']['princpt'])
    xyz = np.asarray(ann['joints_coord_cam'])
    u = xyz[:, 0] * fx / xyz[:, 2] + fu
    v = xyz[:, 1] * fy / xyz[:, 2] + fv
    bbox = [u.min() - pad, v.min() - pad, np.ptp(u) + 2 * pad,
            np.ptp(v) + 2 * pad]
    imgs = os.path.join(root, 'imgs')
    rgb = imread(os.path.join(imgs, f'color_{index:06d}.jpg'))
    depth = imread(os.path.join(imgs, f'aligned_depth_to_color_'
                                      f'{index:06d}.png'), anydepth=True)
    return ({'rgb': rgb, 'depth': depth.astype(np.float32), 'bbox': bbox,
             'hand_type': 'right'}, (fx, fy, fu, fv))


def demo_normalized(model, meta, out):
    """A ModelRGBD answer back in normalized units: stage 2's uvd (the
    full-frame pixels through the crop's M, depth about the centre, in
    half cubes) and the last stage's world joints in half cubes."""
    from keypointfusion_torch.data.preprocessing import transform_points_2d
    uvd = transform_points_2d(out['joint_uvd'], meta['img2bb_trans'])
    half = model.cube[0] / 2
    uvd[:, :2] = uvd[:, :2] / model.img_size * 2 - 1
    uvd[:, 2] = (out['joint_uvd'][:, 2] - meta['center'][2]) / half
    return uvd, out['joint_xyz'] * 1000 / half


def check_demo(dev, kernels, card):
    """A main path: the demo (keypointfusion_torch/demo.py) on the card,
    KPFusion-resnet-18 in float32 at 1024 points (weights from seed 0),
    on the fixture's test frame 0 (demo_frame) and on the JAX demo's
    synthetic frame (demo.smoke_frame), with every launch counter set to
    0 just before each frame's ModelRGBD.estimate_pose_rgbd and read just
    after: K2 'highest' once and K1 'highest' twice, at batch 1. Its
    joints against use_kernels=False on the same point draws within
    DEMO_TOL (demo_normalized); finite outputs of the JAX demo's shapes;
    host ms a frame on the fixture frame (the median of DEMO_FRAMES after
    DEMO_WARMUP, the host's preprocessing included). Then demo.main()
    (root demo_RGBD.py's CLI) on the fixture frame's files writes its
    four PNGs, which read back as its meta arrays."""
    import os
    import shutil
    import tempfile
    from keypointfusion_torch import demo
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.image_io import imread

    t0 = time.perf_counter()
    want_launches = dict.fromkeys(kernels, 0)
    want_launches.update({'pixel_sampler': 1, 'desa_dense': 2})
    errs = {}
    for name, (inp, cam) in (('fixture', demo_frame(0)),
                             ('smoke', demo.smoke_frame())):
        model = demo.ModelRGBD(Config(phase='test'), cam, device=dev)

        def answer(use_kernels):
            model.np_rng = np.random.RandomState(model.cfg.seed)
            model.model.use_kernels = use_kernels
            try:
                meta, out = model.estimate_pose_rgbd([inp])
            finally:
                model.model.use_kernels = True
            return meta[0], out[0]

        answer(True)                           # warm-up, builds the packs
        reset(kernels)
        meta, got = answer(True)
        launches = counts(kernels)
        if launches != want_launches:
            raise AssertionError(f'demo {name}: launches {launches}, '
                                 f'expected {want_launches}')
        _, want = answer(False)
        if got['joint_uvd'].shape != (21, 3) \
                or got['joint_xyz'].shape != (21, 3) \
                or meta['pose_d'].shape != (128, 128, 3) \
                or got['mesh_uvd'] is not None:
            raise AssertionError(f'demo {name}: unexpected output shapes')
        if not (np.isfinite(got['joint_uvd']).all()
                and np.isfinite(got['joint_xyz']).all()):
            raise AssertionError(f'demo {name}: non-finite joints')
        errs[name] = [float(np.abs(g - w).max()) for g, w in zip(
            demo_normalized(model, meta, got),
            demo_normalized(model, meta, want))]
        if not max(errs[name]) <= DEMO_TOL:
            raise AssertionError(f'demo {name}: kernels differ from the '
                                 f'plain path by {errs[name]} (uvd, xyz) > '
                                 f'{DEMO_TOL}')
    inp, cam = demo_frame(0)
    model = demo.ModelRGBD(Config(phase='test'), cam, device=dev)

    for _ in range(DEMO_WARMUP):
        model.estimate_pose_rgbd([inp])
    frame_ms = []
    for _ in range(DEMO_FRAMES):
        t = time.perf_counter()
        model.estimate_pose_rgbd([inp])        # ends on the host's copy
        frame_ms.append((time.perf_counter() - t) * 1e3)

    out_dir = tempfile.mkdtemp(prefix='kpf_demo_')
    try:
        imgs = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            DATA_FIXTURE, 'DexYCB', 'imgs')
        x, y, w, h = inp['bbox']
        cli_meta, cli_out = demo.main(
            ['--rgb', os.path.join(imgs, 'color_000000.jpg'),
             '--depth', os.path.join(imgs, 'aligned_depth_to_color_000000'
                                           '.png'),
             '--bbox', *(str(v) for v in (x + w / 2, y + h / 2, w, h)),
             '--fx', str(cam[0]), '--fy', str(cam[1]), '--fu', str(cam[2]),
             '--fv', str(cam[3]), '--out_dir', out_dir], device=dev)
        written = {}
        for key, name in demo.OUTPUT_FILES.items():
            arr = cli_meta[0][key]
            back = imread(os.path.join(out_dir, name),
                          anydepth=arr.ndim == 2)
            written[name] = list(arr.shape)
            if not np.array_equal(back, arr):
                raise AssertionError(f'demo.main: {name} reads back '
                                     f'otherwise')
        if not np.isfinite(cli_out[0]['joint_xyz']).all():
            raise AssertionError('demo.main: non-finite joints')
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log('demo', net='KPFusion-resnet-18', dtype='float32', points=1024,
        frames='fixture test 0 (480x640), smoke (720x1280)',
        launches_per_frame=json.dumps(launches),
        kernels_vs_plain_uvd_xyz=json.dumps(errs), tol=DEMO_TOL,
        ms_per_frame_median=round(float(np.median(frame_ms)), 3),
        ms_per_frame_range=json.dumps([round(min(frame_ms), 3),
                                       round(max(frame_ms), 3)]),
        frames_timed=DEMO_FRAMES, main_png=json.dumps(written),
        seconds=round(time.perf_counter() - t0, 2), card=json.dumps(card))


def check_backbones(dev, kernels, card, batch):
    """The config's other backbones, KPFusion-convnext-T and
    KPFusion-resnet-50 (BACKBONE_NETS), at batch 64, weights from seed 0:
    1. forward_check: float32 through the kernels against the plain path
       within FORWARD_TOL, bfloat16 within its budget.
    2. Main paths: serve() in float32 and in bfloat16, each engine over
       REQUESTS requests of 480x640 frames with every launch counter set
       to 0 just before and read just after (K2 once and K1 twice a
       request, in the engine's modes); frames/s as smoke figures.
    3. KPFusion-convnext-T also trains: card_vs_cpu_step in float32 at
       BACKBONE_TRAIN_BATCH under TRAIN_TOL, then timed_train_steps in
       float32 and 'mixed' (ms a step, peak memory, no launch).
    One line, a JSON object by net."""
    import torch
    t0 = time.perf_counter()
    nets = {}
    for net in BACKBONE_NETS:
        t1 = time.perf_counter()
        _, errs, gaps = forward_check(dev, batch, net)
        entry = {'forward_float32_max_abs_err': max(errs.values()),
                 'forward_bfloat16_gaps': gaps}
        for dtype in (torch.float32, torch.bfloat16):
            entry[f'serving_{str(dtype).split(".")[-1]}'] = serve(
                dev, kernels, dtype, net)
        if net == BACKBONE_TRAIN_NET:
            entry['train_card_vs_cpu_float32'] = card_vs_cpu_step(
                dev, 'float32', net, BACKBONE_TRAIN_BATCH)
            for compute_dtype in ('float32', 'mixed'):
                state, _, _, timed = timed_train_steps(dev, kernels,
                                                       compute_dtype, net)
                del state
                entry[f'train_{compute_dtype}'] = timed
        entry['seconds'] = round(time.perf_counter() - t1, 2)
        nets[net] = entry
        torch.cuda.empty_cache()
    log('backbones', batch=BATCH, nets=json.dumps(nets),
        seconds=round(time.perf_counter() - t0, 2), card=json.dumps(card))


def decode_stages(model, batch, cfg, use_kernels):
    """One eval step of `model` on `batch`, every stage decoded as the
    trainer decodes it (Trainer._decode_stage, by cfg's feature type and
    stage_type): [stages, B, J, 3] in mm from the crop centre."""
    import torch
    from keypointfusion_torch.training.train_step import (
        TrainState, frame_from_batch, make_eval_step,
    )
    from keypointfusion_torch.training.trainer import Trainer

    model.use_kernels = use_kernels
    results, _ = make_eval_step(cfg)(TrainState(model, None, None), batch)
    model.use_kernels = True
    frame = frame_from_batch(batch, cfg)
    holder = types.SimpleNamespace(cfg=cfg)
    xyz = torch.stack([Trainer._decode_stage(holder, results, batch, frame,
                                             i, stage)
                       for i, stage in enumerate(cfg.stage_type)])
    return xyz * (batch['cube'][None, :, None, :] / 2.0)


def check_feature_types(dev, kernels, card):
    """The config's other feature types (FEATURE_TYPES), KPFusion-resnet-18
    in float32, TF32 off:
    1. 'offset' and 'heatmap' train: card_vs_cpu_step at
       FEATURE_TRAIN_BATCH within TRAIN_TOL['float32'], then
       timed_train_steps at batch 64 (ms a step, no launch), beside the
       default 'weight_offset' step timed in the same call.
    2. A main path: each of the three decodes one eval batch of 64 through
       Trainer._decode_stage, the launch counters set to 0 just before and
       read just after: K2 'highest' once and K1 'highest' twice; then the
       plain path, block 2 taking the same inputs (Block2Inputs): every
       stage within TRAINER_MM_TOL (mm), the non-finite joints of the
       nosoftmax decode (its weights' sum may be <= 0 on random weights,
       as in JAX) at the same places on both paths.
    One line, a JSON object by feature type."""
    import torch
    from keypointfusion_torch.models.kpfusion import build_kpfusion

    t0 = time.perf_counter()
    net = 'KPFusion-resnet-18'
    state, _, _, timed = timed_train_steps(dev, kernels, 'float32', net)
    del state
    entries = {'weight_offset': {'ms_per_step': timed['ms_per_step']}}
    want_launches = dict.fromkeys(kernels, 0)
    want_launches.update({'pixel_sampler': 1, 'desa_dense': 2})
    for i, ftype in enumerate(FEATURE_TYPES):
        kw = {'feature_type': ftype}
        entry = {}
        if i < FEATURE_TRAINED:
            entry['card_vs_cpu'] = card_vs_cpu_step(
                dev, 'float32', net, FEATURE_TRAIN_BATCH, **kw)
            state, batch, cfg, timed = timed_train_steps(
                dev, kernels, 'float32', net, **kw)
            model = state.model
            entry.update({k: timed[k] for k in ('ms_per_step', 'peak_gib',
                                                'step_launches')})
        else:
            cfg = dataclasses.replace(cfg, **kw)
            model = build_kpfusion(cfg, device=dev, seed=0)
        block2 = Block2Inputs(model)
        reset(kernels)
        got = decode_stages(model, batch, cfg, True)
        launches = counts(kernels)
        if launches != want_launches:
            raise AssertionError(f'{ftype} decode launched {launches}, '
                                 f'expected {want_launches}')
        block2.replay()
        want = decode_stages(model, batch, cfg, False)
        block2.remove()
        same = (got == want) | (got.isnan() & want.isnan())
        err = float(torch.where(same, torch.zeros_like(got),
                                (got - want).abs()).max())
        finite = torch.isfinite(got)
        if not err <= TRAINER_MM_TOL or (i < FEATURE_TRAINED
                                         and not bool(finite.all())):
            raise AssertionError(f'{ftype} decode: kernels against plain '
                                 f'{err} mm (tol {TRAINER_MM_TOL}), '
                                 f'finite {bool(finite.all())}')
        entry.update({'eval_launches': launches, 'eval_max_abs_err_mm': err,
                      'non_finite_joints': int((~finite).any(-1).sum())})
        entries[ftype[0]] = entry
        del model, state
        state = None
        torch.cuda.empty_cache()
    log('feature_types', batch=BATCH, tol_mm=TRAINER_MM_TOL,
        types=json.dumps(entries),
        seconds=round(time.perf_counter() - t0, 2), card=json.dumps(card))


def count_waits(fn):
    """fn()'s result and the host's waits for the card inside it
    (torch.cuda.set_sync_debug_mode), by source line."""
    import torch
    sites = collections.Counter()
    with warnings.catch_warnings():
        warnings.simplefilter('always')
        original = warnings.showwarning

        def show(message, category, filename, lineno, *args, **kw):
            if 'synchroniz' in str(message):
                sites[f'{filename}:{lineno}'] += 1
            else:
                original(message, category, filename, lineno, *args, **kw)
        # the mode's own notice, when it is first set, is no wait
        torch.cuda.set_sync_debug_mode('warn')
        warnings.showwarning = show
        try:
            return fn(), sites
        finally:
            torch.cuda.set_sync_debug_mode('default')
            warnings.showwarning = original


def check_mano(dev, card):
    """MANO at batch 64 on the synthetic asset (778 vertices; no MANO pkl
    is in the repository), float32, TF32 off:
    1. mano_forward in PCA mode with betas and trans, and in the
       rotation-matrix mode; ManoRegHead (feature_size 1024, neurons
       (1024, 512)) forward and backward of a fixed scalar of its mesh,
       joints and axis-angle pose. The card against the CPU port on the
       same inputs and weights: meshes and joints within MANO_TOL['mesh']
       and every head gradient within MANO_TOL['grad'] of its scale.
    2. ms a call of each (CUDA events over MANO_ITERS calls after a
       warm-up) and the host's waits for the card in one call (the target
       is 0)."""
    import torch
    from keypointfusion_torch.mano.assets import synthetic_mano_model
    from keypointfusion_torch.mano.mano_head import ManoRegHead
    from keypointfusion_torch.mano.manolayer import (
        ManoLayer, batch_rodrigues, mano_forward,
    )

    t0 = time.perf_counter()
    asset = synthetic_mano_model()
    rng = np.random.RandomState(0)
    arrays = {'pose': rng.randn(BATCH, 48) * 0.5,
              'betas': rng.randn(BATCH, 10),
              'trans': rng.randn(BATCH, 3) * 0.1,
              'aa': rng.randn(BATCH, 16, 3) * 0.7,
              'feat': rng.randn(BATCH, 1024),
              'cot': rng.randn(BATCH, 778 + 21 + 16, 3)}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        head_cpu = ManoRegHead(asset, 1024, (1024, 512), device='cpu')

    def calls(where):
        x = {k: torch.from_numpy(v.astype(np.float32)).to(where)
             for k, v in arrays.items()}
        layer = ManoLayer(asset, device=where)
        head = head_cpu if where == 'cpu' else ManoRegHead(
            layer, 1024, (1024, 512), device=where)
        head.load_state_dict(head_cpu.state_dict())
        rotmats = batch_rodrigues(x['aa'])

        def head_step():
            head.zero_grad(set_to_none=True)
            out = head(x['feat'])
            pts = torch.cat([out['verts3d'], out['joints3d'],
                             out['mano_pose_aa'].reshape(-1, 16, 3)], 1)
            (pts * x['cot']).sum().backward()
            return out
        return {'pca': lambda: mano_forward(layer, x['pose'],
                                            betas=x['betas'],
                                            trans=x['trans']),
                'rotmats': lambda: mano_forward(layer, None,
                                                betas=x['betas'],
                                                pose_rotmats=rotmats),
                'head': head_step}, head

    def outputs(fns, head):
        out = {}
        for name in ('pca', 'rotmats'):
            out[f'{name}_verts'], out[f'{name}_joints'] = fns[name]()
        res = fns['head']()
        out['head_verts'], out['head_joints'] = res['verts3d'], \
            res['joints3d']
        out.update({f'grad {k}': p.grad for k, p in
                    head.named_parameters()})
        return {k: v.detach().double().cpu() for k, v in out.items()}

    cpu_fns, cpu_head = calls('cpu')
    want = outputs(cpu_fns, cpu_head)
    fns, head = calls(dev)
    got = outputs(fns, head)
    errs = {}
    for k, w in want.items():
        e = float((got[k] - w).abs().max())
        limit = MANO_TOL['grad' if k.startswith('grad') else 'mesh'] \
            * max(1.0, float(w.abs().max()))
        errs[k] = e / limit
        if not e <= limit or not bool(torch.isfinite(got[k]).all()):
            raise AssertionError(f'mano {k}: the card lies {e} from the CPU '
                                 f'(limit {limit})')
    timing = {}
    for name, fn in fns.items():
        ms = cuda_ms(fn, MANO_ITERS)
        _, sites = count_waits(fn)
        timing[name] = {'ms': round(ms, 4),
                        'host_ms': round(host_ms(fn, MANO_ITERS), 4),
                        'waits_per_call': sum(sites.values()),
                        'wait_sites': dict(sites)}
    log('mano', batch=BATCH, verts=778, tol=json.dumps(MANO_TOL),
        worst_over_tol=json.dumps(max(errs.items(), key=lambda kv: kv[1])),
        errs_over_tol=json.dumps({k: float(f'{v:.3g}')
                                  for k, v in errs.items()}),
        calls=json.dumps(timing),
        seconds=round(time.perf_counter() - t0, 2), card=json.dumps(card))


def check_desa_dense_train(dev, kernels, card):
    """DESA's dense train form (models/desa.py, dense_train=True) in the
    KPFusion-resnet-18 train step, float32, TF32 off:
    1. compare_steps of the dense step against the gather step, both on
       the card, at DENSE_TRAIN_BATCH: the loss, every running statistic,
       every parameter and the update within TRAIN_TOL['float32'], the
       controls outside it.
    2. timed_train_steps (ms a step, peak memory, no launch) of the dense
       step at the first batch of DENSE_TIMED_BATCHES that fits in the
       card's memory, and of the gather step at batch 64 in the same
       call."""
    import torch
    t0 = time.perf_counter()
    net = 'KPFusion-resnet-18'
    vs_gather = compare_steps([(dev, False), (dev, True)], 'float32', net,
                              DENSE_TRAIN_BATCH)
    state, _, _, gather = timed_train_steps(dev, kernels, 'float32', net)
    del state
    too_big, dense = [], None
    for batch_size in DENSE_TIMED_BATCHES:
        try:
            state, _, _, dense = timed_train_steps(
                dev, kernels, 'float32', net, batch_size=batch_size,
                dense_train=True)
        except torch.cuda.OutOfMemoryError:
            too_big.append(batch_size)
        state = None
        # after the handler: its traceback no longer holds the tensors
        torch.cuda.empty_cache()
        if dense is not None:
            break
    if dense is None:
        raise AssertionError(f'the dense train step fits no batch of '
                             f'{DENSE_TIMED_BATCHES}')
    log('desa_dense_train', dense_vs_gather=json.dumps(vs_gather),
        dense_batch=batch_size, out_of_memory_at=json.dumps(too_big),
        dense_ms_per_step=dense['ms_per_step'],
        dense_peak_gib=dense['peak_gib'],
        dense_losses=json.dumps(dense['losses']),
        dense_step_launches=json.dumps(dense['step_launches']),
        gather_batch=BATCH, gather_ms_per_step=gather['ms_per_step'],
        gather_peak_gib=gather['peak_gib'],
        seconds=round(time.perf_counter() - t0, 2), card=json.dumps(card))


def optional_families():
    """{name: (constructor, input shapes at batch b)} of the
    [optional_models] phase, NHWC, at full width: PoseNet (nstack 2,
    inp_dim 256) on 128x128 depth, CenterNetRegressor on ResNet-18,
    CBAM on [b, 32, 32, 256], RGBDResNetUNet on ResNet-18 with 128x128
    RGB and depth, DetrDecoder and SpatialAggregateTR (hidden 128, 4
    heads, 3 layers) over 32x32 image tokens and 21 joints."""
    from keypointfusion_torch.models.legacy import (
        CBAM, CenterNetRegressor, PoseNet,
    )
    from keypointfusion_torch.models.rgbd_fusion import RGBDResNetUNet
    from keypointfusion_torch.models.transformer_extra import (
        DetrDecoder, SpatialAggregateTR,
    )
    tr = dict(hidden=128, heads=4, layers=3)
    return {
        'posenet': (lambda **kw: PoseNet(nstack=2, inp_dim=256),
                    lambda b: [(b, 128, 128, 1)]),
        'centernet': (lambda **kw: CenterNetRegressor(depth=18),
                      lambda b: [(b, 128, 128, 1)]),
        'cbam': (lambda **kw: CBAM(256), lambda b: [(b, 32, 32, 256)]),
        'rgbd_resnet_unet': (lambda **kw: RGBDResNetUNet(18),
                             lambda b: [(b, 128, 128, 3), (b, 128, 128, 1)]),
        'detr_decoder': (lambda **kw: DetrDecoder(**tr, **kw),
                         lambda b: [(b, 21, 128), (b, 32, 32, 128)]),
        'spatial_aggregate_tr': (
            lambda **kw: SpatialAggregateTR(**tr, **kw),
            lambda b: [(b, 32, 32, 128), (b, 21, 128)]),
    }


def family_inputs(shapes, seed, dev):
    import torch
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
            for s in shapes]


def family_outputs(out):
    import torch
    return [out] if isinstance(out, torch.Tensor) else list(out)


def family_pass(model, xs, cots):
    """The eval outputs, then one train-mode forward and backward of
    sum(out * cot) from the same state: (eval outputs, gradients, the
    running statistics' change), float64 on the CPU."""
    import torch
    before = {k: b.detach().cpu().double().clone()
              for k, b in model.named_buffers() if b.is_floating_point()}
    model.eval()
    with torch.no_grad():
        evals = [o.detach().cpu().double()
                 for o in family_outputs(model(*xs))]
    model.train()
    model.zero_grad(set_to_none=True)
    outs = family_outputs(model(*xs))
    sum((o * c).sum() for o, c in zip(outs, cots)).backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             .detach().cpu().double() for k, p in model.named_parameters()}
    stats = {k: b.detach().cpu().double() - before[k]
             for k, b in model.named_buffers() if b.is_floating_point()}
    return evals, grads, stats


def family_distances(got, want):
    """{'forward': the worst eval output's max abs error over its scale
    (at least 1), 'grad': the L2 norm of the gradients' difference over
    every tensor at once over that of `want`'s, 'stat': the same of the
    running statistics' change} of `got` against `want` (family_pass
    results)."""
    evals, grads, stats = got
    w_evals, w_grads, w_stats = want

    def l2(a, b):
        diff = sum(float((a[k] - w).square().sum()) for k, w in b.items())
        return (diff / sum(float(w.square().sum()) for w in b.values())) \
            ** 0.5
    out = {'forward': max(float((g - w).abs().max())
                          / max(1.0, float(w.abs().max()))
                          for g, w in zip(evals, w_evals)),
           'grad': l2(grads, w_grads)}
    if w_stats:
        out['stat'] = l2(stats, w_stats)
    return out


def family_errors(got, want, limits=None):
    """family_distances over their limits (OPTIONAL_TOL by default)."""
    limits = limits or OPTIONAL_TOL
    return {k: v / limits[k] for k, v in family_distances(got,
                                                          want).items()}


def time_family(model, xs, gen):
    """(eval ms, train step ms) at the inputs' batch: the eval forward,
    and a train step (train-mode forward, backward of the mean square of
    the outputs, Adam), CUDA events over OPTIONAL_ITERS calls after a
    warm-up."""
    import torch
    kw = {} if gen is None else {'generator': gen}
    model.eval()

    def forward():
        with torch.no_grad():
            model(*xs, **kw)
    eval_ms = cuda_ms(forward, OPTIONAL_ITERS)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        outs = family_outputs(model(*xs, **kw))
        sum(o.float().square().mean() for o in outs).backward()
        opt.step()
    train_ms = cuda_ms(step, OPTIONAL_ITERS)
    torch.cuda.synchronize()
    return eval_ms, train_ms


def check_optional_models(dev, kernels, card):
    """The optional model families (models/legacy.py, rgbd_fusion.py,
    transformer_extra.py) at full width, float32 with TF32 off, weights
    from torch seed 0 (optional_families):
    1. the card against the CPU port at OPTIONAL_CHECK_BATCH: eval
       outputs, then one train step's gradients and running statistics'
       change (family_pass), DETR's layers at dropout 0, within the
       limits of OPTIONAL_TOL and OPTIONAL_BUDGET (the CPU's float32
       against its float64 pass); the control (the CPU's pass on moved
       inputs) fails every limit.
    2. timed at BATCH: eval forward and a train step with Adam (DETR's
       dropout 0.1 from a card generator), ms each and the peak GiB.
    3. no kernel launched across the phase.
    One line, a JSON object by family."""
    import copy
    import torch
    from keypointfusion_torch.models.layers import set_compute_dtype
    t0 = time.perf_counter()
    reset(kernels)
    families = {}
    for name, (make, shapes) in optional_families().items():
        t1 = time.perf_counter()
        is_tr = name in ('detr_decoder', 'spatial_aggregate_tr')
        torch.manual_seed(0)
        cpu = make(dropout=0.0) if is_tr else make()
        xs_cpu = family_inputs(shapes(OPTIONAL_CHECK_BATCH), 1, 'cpu')
        rng = np.random.RandomState(2)
        moved = [x + OPTIONAL_CONTROL * float(x.abs().max())
                 * torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
                 for x in xs_cpu]
        with torch.no_grad():
            cots = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32))
                    for o in family_outputs(cpu.eval()(*xs_cpu))]
        want = family_pass(copy.deepcopy(cpu), xs_cpu, cots)
        own = family_distances(want, family_pass(
            set_compute_dtype(copy.deepcopy(cpu).double(), torch.float64),
            [x.double() for x in xs_cpu], [c.double() for c in cots]))
        limits = {k: OPTIONAL_TOL[k] if k == 'forward' else
                  max(OPTIONAL_TOL[k], OPTIONAL_BUDGET * v)
                  for k, v in own.items()}
        control = family_pass(copy.deepcopy(cpu), moved, cots)
        got = family_pass(copy.deepcopy(cpu).to(dev),
                          [x.to(dev) for x in xs_cpu],
                          [c.to(dev) for c in cots])
        errs = family_errors(got, want, limits)
        ctrl = family_errors(control, want, limits)
        bad = [k for k, v in errs.items() if not v <= 1.0]
        bad += [f'control {k} passed' for k, v in ctrl.items()
                if not v > 1.0]
        if bad or not all(bool(torch.isfinite(e).all()) for e in got[0]):
            raise AssertionError(f'optional_models {name}: {bad} (over '
                                 f'limit: {errs}, control {ctrl})')
        del got, want, control
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = make()
        model.load_state_dict(cpu.state_dict())
        model = model.to(dev)
        xs = family_inputs(shapes(BATCH), 3, dev)
        gen = torch.Generator(device=dev).manual_seed(4) if is_tr else None
        eval_ms, train_ms = time_family(model, xs, gen)
        families[name] = {
            'limits': {k: float(f'{v:.3g}') for k, v in limits.items()},
            'cpu_float32_vs_float64': {k: float(f'{v:.3g}')
                                       for k, v in own.items()},
            'over_tol': {k: float(f'{v:.3g}') for k, v in errs.items()},
            'control_over_tol': {k: float(f'{v:.3g}')
                                 for k, v in ctrl.items()},
            'params_m': round(sum(p.numel() for p in model.parameters())
                              / 1e6, 3),
            'eval_ms': round(eval_ms, 4), 'train_step_ms': round(train_ms, 4),
            'peak_gib': round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
            'seconds': round(time.perf_counter() - t1, 2)}
        del model, xs
        torch.cuda.empty_cache()
    launched = counts(kernels)
    if any(launched.values()):
        raise AssertionError(f'optional_models launched kernels: {launched}')
    log('optional_models', batch=BATCH, check_batch=OPTIONAL_CHECK_BATCH,
        tol=json.dumps(OPTIONAL_TOL), budget=OPTIONAL_BUDGET,
        control=OPTIONAL_CONTROL,
        families=json.dumps(families), launches=json.dumps(launched),
        seconds=round(time.perf_counter() - t0, 2), card=json.dumps(card))


def extra_host_ms(patch_warp, extra_datasets):
    """Host ms a call of the [extra_data] functions at the datasets' own
    sizes, on frames drawn from a seed (EXTRA_HOST_ITERS calls each after
    one untimed): patch_augmentation's train and eval draws on a FreiHAND
    frame; preprocess_rhd, imcrop (padding: the hand lies at the frame's
    edge) of the frame and of its mask, unify_mask of the cropped mask
    and pad_img_to_fit_bbox on an RHD frame; create_heatmap;
    make_gaussian_heatmap on BATCH frames."""
    import random
    rng = np.random.RandomState(9)
    f, r, hm = EXTRA_FREIHAND, EXTRA_RHD, EXTRA_HEATMAP
    frei = rng.randint(0, 256, (f, f, 3)).astype(np.uint8)
    bbox = (40.0, 30.0, 150.0, 160.0)
    rhd = rng.randint(0, 256, (r, r, 3)).astype(np.uint8)
    mask = np.zeros((r, r, 3), np.uint8)
    mask[200:310, 230:320] = rng.randint(2, 18, (110, 90, 1))
    mask[20:60, 30:70] = rng.randint(18, 34, (40, 40, 1))
    uv = rng.uniform(0, r, (42, 2))
    xyz = rng.uniform(-0.2, 0.2, (42, 3))
    spec = extra_datasets.preprocess_rhd(rhd, mask, uv, xyz)
    center, size = spec[3], spec[4]
    crop_mask = extra_datasets.imcrop(spec[1][:, :, 0].copy(), center,
                                      size)[0]
    heat_uv = rng.uniform(0, hm, (21, 2))
    gauss_uv = rng.uniform(0, hm, (BATCH, 21, 2)).astype(np.float32)
    aug = random.Random(0)
    calls = {
        'patch_augmentation_train': lambda: patch_warp.patch_augmentation(
            frei, bbox, True, EXTRA_PATCH, rng=aug),
        'patch_augmentation_eval': lambda: patch_warp.patch_augmentation(
            frei, bbox, False, EXTRA_PATCH),
        'preprocess_rhd': lambda: extra_datasets.preprocess_rhd(
            rhd, mask, uv, xyz),
        'imcrop_image': lambda: extra_datasets.imcrop(spec[0], center,
                                                      size),
        'imcrop_mask': lambda: extra_datasets.imcrop(
            spec[1][:, :, 0].copy(), center, size),
        'unify_mask': lambda: extra_datasets.unify_mask(crop_mask, spec[5]),
        'pad_img_to_fit_bbox': lambda: extra_datasets.pad_img_to_fit_bbox(
            rhd, -40, r + 40, -40, r + 40),
        'create_heatmap': lambda: extra_datasets.create_heatmap(heat_uv,
                                                                hm),
        'make_gaussian_heatmap': lambda: extra_datasets.make_gaussian_heatmap(
            gauss_uv, (hm, hm)),
    }
    if center[0] + size <= r:
        raise AssertionError('extra_data: the timed RHD crop does not pad')
    out = {}
    for name, fn in calls.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(EXTRA_HOST_ITERS):
            fn()
        out[name] = round((time.perf_counter() - t0) / EXTRA_HOST_ITERS
                          * 1e3, 4)
    return out


def load_test_cases(name):
    """tests/<name>.py (numpy only), loaded by path: the card's machine has
    an installed package named `tests` that hides the repo's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'tests', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_extra_data(dev, kernels, card):
    """The off-path data modules on the card's host (no cv2, no JAX):
    1. data/patch_warp.py and data/extra_datasets.py on the inputs of
       EXTRA_FIXTURE (tests/torch_port_extra_cases.py's calls:
       patch_augmentation's train and eval draws, imcrop,
       pad_img_to_fit_bbox, preprocess_rhd, unify_mask, create_heatmap,
       make_gaussian_heatmap) against the JAX package's outputs stored
       there, bit for bit (dtype, shape, values).
    2. host ms a call of the same functions at the datasets' own sizes
       (extra_host_ms).
    3. data/occlusion.py's mask_image (draws from a CPU generator, moved
       to the card) and joint_visibility on the card against the CPU on
       the same inputs, expected equal; ms a call on the card at batch 64
       (mask_image with its draws from a card generator), a
       EXTRA_MASK_SIZE crop and EXTRA_POINTS cloud points.
    4. no kernel launched."""
    import os
    import torch
    from keypointfusion_torch.data import extra_datasets, occlusion
    from keypointfusion_torch.data import patch_warp
    cases = load_test_cases('torch_port_extra_cases')
    t0 = time.perf_counter()
    reset(kernels)
    stored = np.load(os.path.join(REPO, EXTRA_FIXTURE))
    inp = {k[3:]: stored[k] for k in stored.files if k.startswith('in_')}
    got = cases.case_outputs(patch_warp, extra_datasets, inp)
    differ = [k for k, v in got.items()
              if not (v.dtype == stored[k].dtype and v.shape ==
                      stored[k].shape and np.array_equal(v, stored[k]))]
    if differ or len(got) != len(stored.files) - len(inp):
        raise AssertionError(f'extra_data: {len(differ)} of {len(got)} '
                             f'outputs differ from the fixture: {differ}')

    host = extra_host_ms(patch_warp, extra_datasets)

    rng = np.random.RandomState(5)
    b, s = BATCH, EXTRA_MASK_SIZE
    depth = torch.from_numpy(rng.uniform(-1, 0.5, (b, s, s, 1)).astype(
        np.float32))
    joints = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, 21, 3)).astype(
        np.float32))
    pcl = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, EXTRA_POINTS, 3))
                           .astype(np.float32))
    draws = occlusion.mask_image_draws(
        b, 21, 6, torch.Generator().manual_seed(6), 'cpu')
    want_mask = occlusion.mask_image_from_draws(depth, joints, *draws)
    got_mask = occlusion.mask_image_from_draws(
        depth.to(dev), joints.to(dev), *[d.to(dev) for d in draws]).cpu()
    want_vis = occlusion.joint_visibility(pcl, joints, EXTRA_KERNEL)
    got_vis = occlusion.joint_visibility(pcl.to(dev), joints.to(dev),
                                         EXTRA_KERNEL).cpu()
    mask_differ = int((got_mask != want_mask).sum())
    vis_differ = int((got_vis != want_vis).sum())
    if mask_differ or vis_differ or got_mask.device.type != 'cpu':
        raise AssertionError(f'extra_data: the card differs from the CPU on '
                             f'{mask_differ} mask pixels and {vis_differ} '
                             f'visibilities')
    gen = torch.Generator(device=dev).manual_seed(7)
    d_dev, j_dev, p_dev = depth.to(dev), joints.to(dev), pcl.to(dev)
    mask_ms = cuda_ms(lambda: occlusion.mask_image(d_dev, j_dev, gen), 20)
    vis_ms = cuda_ms(lambda: occlusion.joint_visibility(p_dev, j_dev,
                                                        EXTRA_KERNEL), 20)
    launched = counts(kernels)
    if any(launched.values()):
        raise AssertionError(f'extra_data launched kernels: {launched}')
    log('extra_data', fixture_outputs=len(got), differ=len(differ),
        host_ms_a_call=json.dumps(host),
        masked_share=round(float((want_mask == 1).float().mean()), 4),
        visible_share=round(float(want_vis.float().mean()), 4),
        mask_pixels_differ=mask_differ, visibility_differ=vis_differ,
        mask_image_ms=round(mask_ms, 4), joint_visibility_ms=round(vis_ms, 4),
        batch=b, crop=s, points=EXTRA_POINTS,
        host_sizes=json.dumps({'freihand': EXTRA_FREIHAND, 'rhd': EXTRA_RHD,
                               'patch': EXTRA_PATCH, 'heatmap': EXTRA_HEATMAP,
                               'gaussian_batch': BATCH}),
        launches=json.dumps(launched),
        seconds=round(time.perf_counter() - t0, 2), card=json.dumps(card))

def replica_errors(got, want, ref32, dtype):
    """The replicas' answer against one engine's: float32 within
    SERVING_TOL; bfloat16 within the bfloat16 engine's budget of serve()
    (twice the one engine's distance from the float32 engine `ref32`, plus
    a bfloat16 unit), M equal. Returns {key: (error, limit)}."""
    import torch
    out = {}
    for key, unit in (('joint_xyz_mm', 125.0), ('joint_uvd', 1.0),
                      ('M', 0.0)):
        err = float(np.abs(got[key] - want[key]).max())
        if dtype == torch.float32 or key == 'M':
            limit = SERVING_TOL[key]
        else:
            limit = 2 * float(np.abs(want[key] - ref32[key]).max()) \
                + 2 ** -8 * unit
        out[key] = (err, limit)
    return out


def parallel_references(dev, cfg, batch, weights):
    """The world-1 steps the ranks are held to, on the card, in float64
    arithmetic: the whole batch's (global-batch statistics) and the mean
    over its rows of each row's step (per-shard statistics: the mean
    gradient applied to the start, SGD's first step, and the mean
    statistics). Returns (start, {sync: state64 after}, the parameters'
    names), float64 CPU dicts."""
    import torch
    from keypointfusion_torch.models.layers import set_compute_dtype
    from keypointfusion_torch.training.train_step import (
        batch_to_device, create_train_state, make_train_step,
    )

    def step(b):
        b = batch_to_device(b, dev)
        state = create_train_state(cfg, b, device=dev, seed=0, dropout=0.0)
        state.model.load_state_dict(weights)
        set_compute_dtype(state.model.double(), torch.float64)
        # a float64 tensor on the CPU is its own state64: copy it
        start = {k: v.clone() for k, v in state64(state.model).items()}
        state, _ = make_train_step(cfg)(state, b, None, 0)
        return start, state64(state.model), step_grads(state.model)

    start, whole, _ = step(batch)
    rows = [step({k: v[i:i + 1] for k, v in batch.items()})
            for i in range(len(batch['rgb']))]
    shard = {k: sum(r[1][k] for r in rows) / len(rows) for k in whole}
    for k in rows[0][2]:
        shard[k] = start[k] - cfg.lr * sum(r[2][k] for r in rows) / len(rows)
    return start, {True: whole, False: shard}, list(rows[0][2])


def global_batch_norm_errors(dev, group):
    """models/norm.py:global_batch_norm over the process group `group`
    against torch's train-mode batch_norm (TorchBatchNorm) on
    PARALLEL_BN_ROWS x 128 seeded values on `dev`: {'out', 'grad', 'mean',
    'var': max abs error over the reference's max abs} for the outputs,
    the input gradients and the running statistics."""
    import copy
    import torch
    from keypointfusion_torch.models.norm import (
        TorchBatchNorm, global_batch_norm,
    )
    gen = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(PARALLEL_BN_ROWS, 128, device=dev, generator=gen) * 3
         + 1).requires_grad_()
    w = torch.randn(PARALLEL_BN_ROWS, 128, device=dev, generator=gen)
    bn = TorchBatchNorm(128).to(dev).train()
    bn_sync = copy.deepcopy(bn)
    y = bn(x)
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    y_sync = global_batch_norm(x, bn_sync, group)
    (gx_sync,) = torch.autograd.grad((y_sync * w).sum(), x)
    errors = {}
    for key, a, ref in (('out', y_sync, y), ('grad', gx_sync, gx),
                        ('mean', bn_sync.running_mean, bn.running_mean),
                        ('var', bn_sync.running_var, bn.running_var)):
        a, ref = a.detach(), ref.detach()
        errors[key] = float((a - ref).abs().max() / ref.abs().max())
    return errors


def check_parallel(dev, kernels, card):
    """The multi-device paths on the one card. It tells nothing of speed
    across cards: both replicas and both ranks share this card.
    1. Engine replicas: StreamingEngine(devices=[card, card]) at batch 64,
       full frames, in float32 and bfloat16, against the one-replica
       engine (the same weights and point draws) within replica_errors'
       limits; a request's launches, counters set to 0 just before it
       and read just after: K2 twice and K1 four times (each replica once
       and twice); ms a request over REQUESTS requests through
       process_stream, one and two replicas.
    2. Two gloo ranks on the card (parallel/dryrun.py:run_ranks and
       train_ranks): one SGD step of the model at batch 2 (a row a rank,
       256 points, dropout 0) under each BatchNorm policy, against the
       world-1 references (parallel_references) within
       TRAIN_TOL['float32'] and the controls outside it
       (train_step_failures); rank 1 holds rank 0's state bit for bit.
       Both sides compute in float64 (the model's float32 parts aside):
       in float32 the rows' convolutions at batch 1 round otherwise than
       at batch 2, which moved a point across a ball's edge in block 2
       (the update 0.297 from the reference's, block 2's DESA fusion
       statistics 4.9x their limit, on an H100 at 700 W).
    3. An NCCL process group of one rank: the train step under it
       against the plain step within TRAIN_TOL['float32'], and
       models/norm.py:global_batch_norm (its all-reduces on NCCL) against
       torch's train-mode batch_norm on PARALLEL_BN_ROWS x 128 within
       PARALLEL_BN_TOL of scale, outputs, input gradients and running
       statistics."""
    import os
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.synthetic import (
        synthetic_batch, synthetic_frames,
    )
    from keypointfusion_torch.parallel.dryrun import run_ranks, train_ranks
    from keypointfusion_torch.parallel.mesh import init_process_group
    from keypointfusion_torch.serving import StreamingEngine
    from keypointfusion_torch.training.train_step import (
        batch_to_device, create_train_state, make_train_step,
    )

    t0 = time.perf_counter()
    # 1. engine replicas
    rng = np.random.RandomState(11)
    requests = [synthetic_frames(BATCH, rng=rng) for _ in range(REQUESTS + 1)]
    keys = ('depth', 'rgb', 'centers', 'cube', 'cam')
    serving, ref32 = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        engines = [StreamingEngine(Config(), batch_size=BATCH,
                                   img_hw=(480, 640), dtype=dtype, seed=0,
                                   device=dev, devices=[dev] * n)
                   for n in (1, PARALLEL_REPLICAS)]
        answers = []
        for eng in engines:
            answers.append(eng._unpack(eng.submit(
                *[requests[0][k] for k in keys]).cpu().numpy()))
        if dtype == torch.float32:
            ref32 = answers[0]
        errors = replica_errors(answers[1], answers[0], ref32, dtype)
        if any(not e <= lim for e, lim in errors.values()):
            raise AssertionError(f'parallel {name}: {PARALLEL_REPLICAS} '
                                 f'replicas against one engine: {errors}')
        torch.cuda.synchronize()
        reset(kernels)
        engines[1].submit(*[requests[1][k] for k in keys])
        torch.cuda.synchronize()
        launches = counts(kernels)
        suffix = '' if dtype == torch.float32 else '_serving'
        want = dict.fromkeys(kernels, 0)
        want['pixel_sampler' + suffix] = PARALLEL_REPLICAS
        want['desa_dense' + suffix] = 2 * PARALLEL_REPLICAS
        if launches != want:
            raise AssertionError(f'parallel {name}: a request launched '
                                 f'{launches}, expected {want}')
        ms = {}
        for n, eng in zip((1, PARALLEL_REPLICAS), engines):
            list(eng.process_stream(iter(requests[:1])))
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs = list(eng.process_stream(iter(requests[1:])))
            torch.cuda.synchronize()
            ms[n] = round((time.perf_counter() - t) / REQUESTS * 1e3, 3)
            if len(outs) != REQUESTS or not all(
                    np.isfinite(v).all() for o in outs for v in o.values()):
                raise AssertionError(f'parallel {name}: bad stream answers')
        serving[name] = {'errors': {k: [float(f'{e:.3g}'), float(f'{l:.3g}')]
                                    for k, (e, l) in errors.items()},
                         'launches_per_request': launches,
                         'ms_per_request': ms}
        del engines

    # 2. gloo ranks on the card
    tol = TRAIN_TOL['float32']
    cfg_fields = {'opt': 'sgd', 'lr': TRAIN_LR, 'point_num': 256}
    batch = synthetic_batch(batch_size=PARALLEL_STEP_BATCH, point_num=256,
                            seed=42)
    weights = create_train_state(
        Config(**cfg_fields), batch_to_device(batch, 'cpu'), device='cpu',
        seed=0, dropout=0.0).model.state_dict()
    start, refs, params = parallel_references(dev, Config(**cfg_fields),
                                              batch, weights)
    workdir = tempfile.mkdtemp(prefix='kpf_parallel_')
    ranks = {}
    try:
        torch.save({'device': str(dev), 'weights': weights, 'grads': True,
                    'batch': {k: torch.from_numpy(v)
                              for k, v in batch.items()},
                    'steps': [{'config': dict(cfg_fields, sync_batchnorm=s),
                               'float64': True} for s in (True, False)]},
                   os.path.join(workdir, 'in.pt'))
        t = time.perf_counter()
        run_ranks(PARALLEL_RANKS, train_ranks, workdir, timeout_s=600)
        ranks_s = time.perf_counter() - t
        out = torch.load(os.path.join(workdir, 'out_0.pt'),
                         weights_only=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for sync, run in zip((True, False), out['steps']):
        got = {k: v.double() for k, v in run['state'].items()
               if v.is_floating_point()}
        grads = {k: run['grads'][k].double() if k in run['grads']
                 else torch.zeros_like(start[k]) for k in params}
        failures, errors, controls = train_step_failures(
            got, refs[sync], start, grads, TRAIN_LR, tol)
        if failures:
            raise AssertionError(
                f'parallel gloo {"sync" if sync else "per-shard"}: '
                f'{failures}; {errors}, controls {controls}')
        ranks['sync' if sync else 'per_shard'] = {
            'worst_param_over_tol': round(errors['param'][0], 5),
            'worst_stat_over_tol': round(errors['stat'][0], 5),
            'update_rel': float(f"{errors['update']:.3g}"),
            'own_update_rel': float(f"{errors['own_update']:.3g}"),
            'stat_change_rel': float(f"{errors['stat_change']:.3g}"),
            'loss': run['metrics']['loss']}

    # 3. NCCL, one rank
    store_dir = tempfile.mkdtemp(prefix='kpf_nccl_')
    try:
        group = init_process_group(
            'nccl', 0, 1, store=dist.FileStore(
                os.path.join(store_dir, 'store'), 1))
        try:
            cfg = Config(**cfg_fields)
            b = batch_to_device(batch, dev)
            states = []
            for g in (None, group):
                state = create_train_state(cfg, b, device=dev, seed=0,
                                           dropout=0.0)
                state.model.load_state_dict(weights)
                state, _ = make_train_step(cfg, g)(state, b, None, 0)
                states.append(state.model)
            failures, nccl_errors, _ = train_step_failures(
                state64(states[1]), state64(states[0]), start,
                step_grads(states[1]), TRAIN_LR, tol)
            if failures:
                raise AssertionError(f'parallel nccl step: {failures}; '
                                     f'{nccl_errors}')
            bn_err = global_batch_norm_errors(dev, group)
            if any(not e <= PARALLEL_BN_TOL for e in bn_err.values()):
                raise AssertionError(f'parallel nccl global_batch_norm: '
                                     f'{bn_err}')
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)

    log('parallel', replicas=PARALLEL_REPLICAS, batch=BATCH,
        serving=json.dumps(serving), ranks=PARALLEL_RANKS,
        rank_backend='gloo', rank_step_batch=PARALLEL_STEP_BATCH,
        rank_step_dtype='float64',
        rank_steps=json.dumps(ranks), ranks_seconds=round(ranks_s, 2),
        nccl_world1_step=json.dumps({
            'worst_param_over_tol': round(nccl_errors['param'][0], 5),
            'update_rel': float(f"{nccl_errors['update']:.3g}")}),
        nccl_global_batch_norm=json.dumps(
            {k: float(f'{v:.3g}') for k, v in bn_err.items()}),
        tol=json.dumps(tol), seconds=round(time.perf_counter() - t0, 2),
        card=json.dumps(card))


def native_fixture_differences():
    """The fixture's test split through the eval __getitem__'s default
    (native) route against the JAX package's default route's samples
    stored in native_samples.npz. Returns (values compared, values that
    differ); raises where a sample's dtype or shape differs."""
    from keypointfusion_torch.data.datasets import DexYCBDataset
    fixture = os.path.join(REPO, DATA_FIXTURE)
    stored = np.load(os.path.join(fixture, 'native_samples.npz'))
    ds = DexYCBDataset('s0', 'test', fixture, sample_num=1024, seed=7)
    values = differ = 0
    for i in sorted({int(key.split('_')[1]) for key in stored.files}):
        for k, v in ds[i].items():
            want = stored[f'test_{i}_{k}']
            if v.shape != want.shape or v.dtype != want.dtype:
                raise AssertionError(f'native: sample {i} {k} is '
                                     f'{v.dtype}{v.shape}')
            values += v.size
            differ += int((v != want).sum())
    return values, differ


def check_native(dev, card):
    """The native eval core (data/native.py, csrc/host/preprocess.cc) on
    the card's host: its build; the fixture's test split through the
    default (native) route against the JAX package's default route's
    samples stored beside it (native_samples.npz), every value compared
    (tolerance 0); then on a DexYCB tree of NATIVE_TEST test annotations
    over the fixture's frames, by each route (native and numpy): the
    eval __getitem__'s ms a sample on one thread, and BatchLoader's
    samples/s at NATIVE_THREADS threads over the split (ctypes releases
    the interpreter lock for the core's calls)."""
    import os
    import shutil
    import tempfile
    from keypointfusion_torch.data import native
    from keypointfusion_torch.data.datasets import DexYCBDataset
    from keypointfusion_torch.data.pipeline import BatchLoader

    t0 = time.perf_counter()
    fixture = os.path.join(REPO, DATA_FIXTURE)
    native.CORE.load()
    build_s = time.perf_counter() - t0
    values, differ = native_fixture_differences()
    if differ or values == 0:
        raise AssertionError(f'native: {differ} of {values} values differ '
                             f'from the JAX core\'s')
    root = tempfile.mkdtemp(prefix='kpf_native_')
    getitem_ms, loader = {}, {}
    try:
        write_dexycb_tree(root, fixture, 0, NATIVE_TEST)
        for route, use_native in (('native', True), ('numpy', False),
                                  ('native_again', True)):
            ds = DexYCBDataset('s0', 'test', root, sample_num=1024)
            ds.use_native = use_native
            ds[0]
            t = time.perf_counter()
            for i in range(NATIVE_TEST):
                ds[i]
            getitem_ms[route] = round(
                (time.perf_counter() - t) / NATIVE_TEST * 1e3, 3)
            loader[route] = {}
            for threads in NATIVE_THREADS:
                batches = BatchLoader(ds, BATCH, num_workers=threads,
                                      drop_last=False)
                t = time.perf_counter()
                n = sum(len(b['rgb']) for b in batches)
                loader[route][threads] = round(
                    n / (time.perf_counter() - t), 2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log('native', fixture_values=values, differ=differ,
        build_s=round(build_s, 2), test_samples=NATIVE_TEST,
        getitem_ms=json.dumps(getitem_ms),
        loader_samples_per_s=json.dumps(loader), cpu_count=os.cpu_count(),
        seconds=round(time.perf_counter() - t0, 2), card=json.dumps(card))


def vis_fixture_differences():
    """utils/vis.py's debug renderers on VIS_FIXTURE's stored inputs
    (tests/torch_port_vis_cases.py's calls; the written PNGs read back by
    data/image_io.py:imread, the .obj files as bytes) against the JAX
    package's digests stored there. Returns (the number of outputs, the
    keys that differ or are missing on one side)."""
    import tempfile
    from keypointfusion_torch.data.image_io import imread
    from keypointfusion_torch.utils import vis
    cases = load_test_cases('torch_port_vis_cases')
    stored = np.load(os.path.join(REPO, VIS_FIXTURE))
    inp = {k[3:]: stored[k] for k in stored.files if k.startswith('in:')}
    with tempfile.TemporaryDirectory(prefix='kpf_vis_') as workdir:
        got = cases.case_outputs(vis, imread, workdir, inp)
    return len(got), cases.differing(got, stored)


def check_vis_debug(dev, kernels, card):
    """The debug renderers of utils/vis.py on the card's host (no cv2, no
    JAX):
    1. vis_fixture_differences(): every output bit for bit with the JAX
       package's (tolerance 0).
    2. A float32 eval forward of KPFusion-resnet-18 at full width and
       depth, batch VIS_BATCH, on the card: K2 'highest' once and K1
       'highest' twice, counters set to 0 just before it. Its outputs,
       moved to the host, rendered into a temporary directory:
       draw_heatmap and debug_img_heatmap from img_offset's heatmap
       channels 3J:4J, draw_offset_field from its offsets (channels
       j*3+axis), debug_pcl_pose from the point cloud and b2_3d; host ms
       a call over VIS_ITERS calls after one; the counters read 0 across
       the renderers."""
    import tempfile
    import torch
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.models.kpfusion import build_kpfusion
    from keypointfusion_torch.utils import vis

    t0 = time.perf_counter()
    n_outputs, differ = vis_fixture_differences()
    if differ:
        raise AssertionError(f'vis_debug: {len(differ)} of {n_outputs} '
                             f'outputs differ from the fixture: {differ}')

    cfg = Config()
    batch = synthetic_batch(batch_size=VIS_BATCH, point_num=cfg.point_num,
                            seed=4)
    model = build_kpfusion(cfg, device=dev, seed=0)
    inputs = model_inputs(batch, dev)
    torch.cuda.synchronize()
    reset(kernels)
    with torch.inference_mode():
        res, _ = model(*inputs)
    torch.cuda.synchronize()
    forward_launches = counts(kernels)
    want = dict.fromkeys(kernels, 0)
    want['pixel_sampler'], want['desa_dense'] = 1, 2
    if forward_launches != want:
        raise AssertionError(f'vis_debug: the eval forward launched '
                             f'{forward_launches}, expected {want}')
    j = cfg.joint_num
    dense = res[OUTPUTS.index('img_offset')].float().cpu().numpy()
    b2_3d = res[OUTPUTS.index('b2_3d')].float().cpu().numpy()
    heat = np.ascontiguousarray(dense[..., 3 * j:4 * j].transpose(0, 3, 1, 2))
    depth, pcl = batch['depth'], batch['pcl']
    if not (np.isfinite(dense).all() and np.isfinite(b2_3d).all()):
        raise AssertionError('vis_debug: the forward gave non-finite values')

    reset(kernels)
    host, shapes = {}, {}
    with tempfile.TemporaryDirectory(prefix='kpf_vis_debug_') as workdir:
        calls = {
            'draw_heatmap': lambda: vis.draw_heatmap(depth[0], heat[0, 0]),
            'debug_img_heatmap': lambda: vis.debug_img_heatmap(
                depth, heat, 0, workdir, depth.shape[1], save=True),
            'draw_offset_field': lambda: vis.draw_offset_field(
                depth[0], dense[0], joint_id=0),
            'debug_pcl_pose': lambda: vis.debug_pcl_pose(
                pcl, b2_3d, 0, 'dexycb', workdir, 'pcl'),
        }
        for name, fn in calls.items():
            out = fn()
            shapes[name] = None if out is None else list(out.shape)
            t = time.perf_counter()
            for _ in range(VIS_ITERS):
                fn()
            host[name] = round((time.perf_counter() - t) / VIS_ITERS * 1e3,
                               3)
        files = sorted(os.listdir(workdir))
    launched = counts(kernels)
    if any(launched.values()):
        raise AssertionError(f'vis_debug: the renderers launched {launched}')
    want_files = VIS_BATCH * j + VIS_BATCH
    if len(files) != want_files:
        raise AssertionError(f'vis_debug: {len(files)} files written, '
                             f'expected {want_files}')
    log('vis_debug', fixture_outputs=n_outputs, differ=len(differ),
        batch=VIS_BATCH, forward_launches=json.dumps(forward_launches),
        renderer_launches=json.dumps(launched),
        host_ms_a_call=json.dumps(host), shapes=json.dumps(shapes),
        files=len(files), seconds=round(time.perf_counter() - t0, 2),
        card=json.dumps(card))


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.kernels import build
    from keypointfusion_torch.kernels import desa_dense as k1
    from keypointfusion_torch.kernels import grouped_mlp_pool as k3
    from keypointfusion_torch.kernels import pixel_sampler as k2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    kernels = {k.name: k for k in (k2.KERNEL, k1.KERNEL, k2.SERVING_KERNEL,
                                   k1.SERVING_KERNEL, k3.KERNEL)}

    t_start = t0 = time.perf_counter()
    times = build.build(kernels.values())
    for k in kernels.values():
        k.load()                          # bind now, not inside a timing
        usage = [ln.strip() for ln in k.build_log.splitlines()
                 if 'registers' in ln or 'spill' in ln]
        log('build', kernel=k.name, seconds=round(times.get(k.name, 0.0), 2),
            ptxas=json.dumps(usage))
    log('build', total_s=round(time.perf_counter() - t0, 2))

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log('device', torch_name=torch.cuda.get_device_name(0),
        nvidia_smi=json.dumps(card), torch=torch.__version__,
        cuda=torch.version.cuda)

    batch = synthetic_batch(batch_size=BATCH, point_num=1024, seed=1)
    stats = {'pixel_sampler': check_pixel_sampler(dev, batch, 'highest'),
             'desa_dense': check_desa(dev, batch, 'highest'),
             'pixel_sampler_serving': check_pixel_sampler(dev, batch,
                                                          'default'),
             'desa_dense_serving': check_desa(dev, batch, 'default'),
             'grouped_mlp_pool': check_grouped_mlp_pool(dev, batch, kernels)}
    check_forward(dev, batch)
    launches = check_serving(dev, kernels, card, torch.float32)
    launches_bf = check_serving(dev, kernels, card, torch.bfloat16)
    for name in ('pixel_sampler_serving', 'desa_dense_serving'):
        launches[name] = launches_bf[name]
    launches['grouped_mlp_pool'] = stats['grouped_mlp_pool'].pop('launches')
    for compute_dtype in ('float32', 'mixed', 'bfloat16'):
        check_train(dev, kernels, card, compute_dtype)
    check_trainer(dev, kernels, card)
    check_data(dev, kernels, card)
    check_demo(dev, kernels, card)
    check_backbones(dev, kernels, card, batch)
    check_feature_types(dev, kernels, card)
    check_mano(dev, card)
    check_desa_dense_train(dev, kernels, card)
    check_optional_models(dev, kernels, card)
    check_extra_data(dev, kernels, card)
    check_parallel(dev, kernels, card)
    check_native(dev, card)
    check_vis_debug(dev, kernels, card)

    replaces = {'pixel_sampler': 'pixel_sampler_pallas.py:212',
                'desa_dense': 'desa_dense_pallas.py:257',
                'grouped_mlp_pool': 'desa_pallas.py:97'}
    rows = []
    for name, k in kernels.items():
        rows.append(dict(
            name=name, route='cuda',
            source=f'keypointfusion_torch/csrc/{k.source.name}',
            replaces='keypointfusion_tpu/kernels/' + replaces[
                name.replace('_serving', '')],
            launches=launches[name], library_ms=None, **stats[name]))
    log('done', seconds=round(time.perf_counter() - t_start, 2))
    print(json.dumps({'kernels': rows}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
