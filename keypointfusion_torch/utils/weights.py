"""Weight carry-over from the JAX package's KPFusion variables.

`jax_kpfusion_to_state_dict` turns JAX KPFusion variables
({'params', 'batch_stats'} as nested dicts of numpy arrays) into the
port's state_dict, `jax_desa_to_state_dict` a DESA module's subtrees into
the port's DESA state_dict. The port's parameters carry the reference torch names,
the ones keypointfusion_tpu/utils/torch_convert.py:convert_kpfusion_checkpoint
reads, and this function is that converter's exact inverse:
  * flax Conv kernels [kh,kw,I,O] -> torch Conv2d weights [O,I,kh,kw];
  * flax Dense kernels [I,O] -> Linear [O,I], Conv1d [O,I,1] or 1x1 Conv2d
    [O,I,1,1] weights, as the reference module is;
  * flax MHA q/k/v kernels [C,H,C/H] -> Linear weights [C,C] (BERT) or one
    packed in_proj_weight [3C,C] (the cross decoder), out kernels
    [H,C/H,C] -> [C,C];
  * flax's `pcl_feat_emb_rgb` -> the reference's `pcl_feat_emb_RGB`.
Because the names are the ones convert_kpfusion_checkpoint reads, a
released reference state_dict holds every key of the port;
`load_kpfusion_weights` loads it, dropping the modules the reference
builds but never runs. No released checkpoint is in the repository, so
that load is tested on fabricated ones.

Warm starts (the trainer's `load_model`, `finetune_dir` and `pretrain`):
`load_torch_checkpoint` reads a `.pth` (`{'model': state_dict}` or a bare
state_dict, the DataParallel `module.` prefix stripped) and
`merge_partial` takes from it each tensor the model has under the same
name and shape, the reference's filtered merge with the JAX package's
shape gate (keypointfusion_tpu/utils/torch_convert.py:merge_partial).

`jax_mano_head_to_state_dict` and `mano_head_state_dict_to_jax` carry the
MANO regression head's Dense layers both ways.

The optional families carry one way each, from their JAX variables:
`jax_posenet_to_state_dict`, `jax_cbam_to_state_dict`,
`jax_centernet_to_state_dict`, `jax_rgbd_resnet_unet_to_state_dict`
(with `jax_rgbd_fusion_to_state_dict`, `jax_acfusion_to_state_dict` and
`jax_fsp_to_state_dict` for the fusion layers alone),
`jax_detr_decoder_to_state_dict` and
`jax_spatial_aggregate_tr_to_state_dict`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from keypointfusion_torch.models.convnext import MODEL_LIST, resolve_size
from keypointfusion_torch.models.resnet import STAGES

StateDict = Dict[str, torch.Tensor]

# (JAX name, reference name) of the UNet decoders' Residuals; a Residual
# whose widths differ carries its `skip` conv in both trees
UNET_RESIDUALS = (
    ('up4', 'up4.0'), ('skip_layer4', 'skip_layer4'),
    ('fusion_layer4', 'fusion_layer4'), ('up3', 'up3.0'),
    ('skip_layer3', 'skip_layer3'), ('fusion_layer3', 'fusion_layer3'),
    ('up2', 'up2.0'), ('skip_layer2', 'skip_layer2'),
    ('fusion_layer2', 'fusion_layer2'))
CONVNEXT_RESIDUALS = UNET_RESIDUALS + (('result_emb', 'result_emb'),)
EMBEDDINGS = (('pcl_feat_emb', 'pcl_feat_emb'),
              ('pcl_xyz_emb', 'pcl_xyz_emb'),
              ('pcl_pose_emb', 'pcl_pose_emb'),
              ('pcl_feat_emb_rgb', 'pcl_feat_emb_RGB'),
              ('joint_feat_emb', 'joint_feat_emb'),
              ('joint_xyz_emb', 'joint_xyz_emb'))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv2d(sd: StateDict, name: str, p: dict) -> None:
    sd[f'{name}.weight'] = _t(np.transpose(np.asarray(p['kernel']),
                                           (3, 2, 0, 1)))
    if 'bias' in p:
        sd[f'{name}.bias'] = _t(p['bias'])


def _dense(sd: StateDict, name: str, p: dict, trailing: int = 0) -> None:
    """Dense [I,O] -> a weight [O,I] followed by `trailing` unit axes
    (0: Linear, 1: Conv1d, 2: 1x1 Conv2d)."""
    w = np.asarray(p['kernel']).T
    sd[f'{name}.weight'] = _t(w.reshape(w.shape + (1,) * trailing))
    if 'bias' in p:
        sd[f'{name}.bias'] = _t(p['bias'])


def _bn(sd: StateDict, name: str, p: dict, s: dict) -> None:
    sd[f'{name}.weight'] = _t(p['scale'])
    sd[f'{name}.bias'] = _t(p['bias'])
    sd[f'{name}.running_mean'] = _t(s['mean'])
    sd[f'{name}.running_var'] = _t(s['var'])
    sd[f'{name}.num_batches_tracked'] = torch.tensor(0)


def _layernorm(sd: StateDict, name: str, p: dict) -> None:
    sd[f'{name}.weight'] = _t(p['scale'])
    sd[f'{name}.bias'] = _t(p['bias'])


def _resnet(sd: StateDict, pre: str, p: dict, s: dict, depth: int) -> None:
    _conv2d(sd, f'{pre}conv1', p['conv1'])
    _bn(sd, f'{pre}bn1', p['bn1'], s['bn1'])
    kind, sizes = STAGES[depth]
    convs = (1, 2) if kind == 'basic' else (1, 2, 3)
    for stage, nblocks in enumerate(sizes):
        for i in range(nblocks):
            jn, tn = f'layer{stage + 1}_{i}', f'{pre}layer{stage + 1}.{i}'
            for c in convs:
                _conv2d(sd, f'{tn}.conv{c}', p[jn][f'conv{c}'])
                _bn(sd, f'{tn}.bn{c}', p[jn][f'bn{c}'], s[jn][f'bn{c}'])
            if 'downsample_conv' in p[jn]:
                _conv2d(sd, f'{tn}.downsample.0', p[jn]['downsample_conv'])
                _bn(sd, f'{tn}.downsample.1', p[jn]['downsample_bn'],
                    s[jn]['downsample_bn'])


def _residual(sd: StateDict, pre: str, p: dict, s: dict) -> None:
    """The port's Residual (models/unet.py) under `pre`."""
    for c in (1, 2, 3):
        _bn(sd, f'{pre}.bn{c}', p[f'bn{c}'], s[f'bn{c}'])
        _conv2d(sd, f'{pre}.conv{c}.conv', p[f'conv{c}'])
    if 'skip' in p:
        _conv2d(sd, f'{pre}.skip_layer.conv', p['skip'])


def _decoder(sd: StateDict, pre: str, p: dict, s: dict, residuals) -> None:
    for jn, tn in residuals:
        _residual(sd, f'{pre}{tn}', p[jn], s[jn])
    for i in range(3):
        _conv2d(sd, f'{pre}finals.{i}', p[f'final_{i}'])


def _resnet_unet(sd: StateDict, pre: str, p: dict, s: dict,
                 depth: int) -> None:
    _resnet(sd, f'{pre}backbone.', p['backbone'], s['backbone'], depth)
    _decoder(sd, pre, p, s, UNET_RESIDUALS)


def _convnext(sd: StateDict, pre: str, p: dict, depths) -> None:
    """ConvNeXt encoder params (LayerNorm only, no statistics)."""
    _conv2d(sd, f'{pre}downsample_layers.0.0', p['stem_conv'])
    _layernorm(sd, f'{pre}downsample_layers.0.1', p['stem_norm'])
    for i in range(1, 4):
        _layernorm(sd, f'{pre}downsample_layers.{i}.0', p[f'down_norm{i}'])
        _conv2d(sd, f'{pre}downsample_layers.{i}.1', p[f'down_conv{i}'])
    for i, nblocks in enumerate(depths):
        for j in range(nblocks):
            bp, tn = p[f'stage{i}_block{j}'], f'{pre}stages.{i}.{j}'
            _conv2d(sd, f'{tn}.dwconv', bp['dwconv'])
            _layernorm(sd, f'{tn}.norm', bp['norm'])
            _dense(sd, f'{tn}.pwconv1', bp['pwconv1'])
            _dense(sd, f'{tn}.pwconv2', bp['pwconv2'])
            sd[f'{tn}.gamma'] = _t(bp['gamma'])


def _convnext_unet(sd: StateDict, pre: str, p: dict, s: dict,
                   size: str) -> None:
    depths, _ = MODEL_LIST[resolve_size(size)]
    _convnext(sd, f'{pre}backbone.', p['backbone'], depths)
    _decoder(sd, pre, p, s, CONVNEXT_RESIDUALS)


def _head_kernel(k) -> np.ndarray:
    """flax MHA q/k/v kernel [C,H,D] -> Linear weight [H*D, C]."""
    k = np.asarray(k)
    return k.reshape(k.shape[0], -1).T


def _mha_out(sd: StateDict, name: str, p: dict) -> None:
    k = np.asarray(p['kernel'])                       # [H, D, C]
    sd[f'{name}.weight'] = _t(k.reshape(-1, k.shape[-1]).T)
    sd[f'{name}.bias'] = _t(p['bias'])


def _keypoint_encoder(sd: StateDict, pre: str, p: dict) -> None:
    sd[f'{pre}.position_embeddings.weight'] = _t(
        p['position_embeddings']['embedding'])
    _dense(sd, f'{pre}.img_embedding', p['img_embedding'])
    i = 0
    while f'layer_{i}' in p:
        lp, lt = p[f'layer_{i}'], f'{pre}.encoder.layer.{i}'
        for name in ('query', 'key', 'value'):
            a = lp['attn'][name]
            sd[f'{lt}.attention.self.{name}.weight'] = _t(
                _head_kernel(a['kernel']))
            sd[f'{lt}.attention.self.{name}.bias'] = _t(
                np.asarray(a['bias']).reshape(-1))
        _mha_out(sd, f'{lt}.attention.output.dense', lp['attn']['out'])
        _layernorm(sd, f'{lt}.attention.output.LayerNorm', lp['ln_attn'])
        _dense(sd, f'{lt}.intermediate.dense', lp['ffn_in'])
        _dense(sd, f'{lt}.output.dense', lp['ffn_out'])
        _layernorm(sd, f'{lt}.output.LayerNorm', lp['ln_ffn'])
        i += 1


def _kp_interaction(sd: StateDict, pre: str, p: dict) -> None:
    _keypoint_encoder(sd, f'{pre}.bert', p['bert'])
    _dense(sd, f'{pre}.cls_head', p['cls_head'])
    _dense(sd, f'{pre}.residual', p['residual'])


def _cross_decoder(sd: StateDict, pre: str, p: dict) -> None:
    i = 0
    while f'layer_{i}' in p:
        lp, lt = p[f'layer_{i}'], f'{pre}.decoder.{i}'
        for name in ('self_posembed', 'cross_posembed'):
            sd[f'{lt}.{name}.weight'] = _t(lp[name]['embedding'])
        a = lp['cross_attn']
        sd[f'{lt}.multihead_attn.in_proj_weight'] = _t(np.concatenate(
            [_head_kernel(a[n]['kernel']) for n in ('query', 'key',
                                                    'value')]))
        sd[f'{lt}.multihead_attn.in_proj_bias'] = _t(np.concatenate(
            [np.asarray(a[n]['bias']).reshape(-1)
             for n in ('query', 'key', 'value')]))
        _mha_out(sd, f'{lt}.multihead_attn.out_proj', a['out'])
        _layernorm(sd, f'{lt}.norm2', lp['norm2'])
        _layernorm(sd, f'{lt}.norm3', lp['norm3'])
        _dense(sd, f'{lt}.linear1', lp['linear1'])
        _dense(sd, f'{lt}.linear2', lp['linear2'])
        i += 1


def _desa(sd: StateDict, pre: str, p: dict, s: dict) -> None:
    """The DESA subtree (params p, batch_stats s) under prefix `pre.`."""
    i = 0
    while f'conv_l0_{i}' in p:
        _dense(sd, f'{pre}.conv_l0_blocks.{i}', p[f'conv_l0_{i}'], 2)
        _bn(sd, f'{pre}.bn_l0_blocks.{i}', p[f'bn_l0_{i}'], s[f'bn_l0_{i}'])
        _dense(sd, f'{pre}.conv_f0_blocks.{i}', p[f'conv_f0_{i}'], 2)
        _bn(sd, f'{pre}.bn_f0_blocks.{i}', p[f'bn_f0_{i}'], s[f'bn_f0_{i}'])
        k = 0
        while f'conv_{i}_{k}' in p:
            _dense(sd, f'{pre}.conv_blocks.{i}.{k}', p[f'conv_{i}_{k}'], 2)
            _bn(sd, f'{pre}.bn_blocks.{i}.{k}', p[f'bn_{i}_{k}'],
                s[f'bn_{i}_{k}'])
            k += 1
        i += 1
    _dense(sd, f'{pre}.fusion.0', p['fusion'], 1)
    _bn(sd, f'{pre}.fusion.1', p['fusion_bn'], s['fusion_bn'])


def jax_desa_to_state_dict(params: dict, batch_stats: dict) -> StateDict:
    """A JAX DESA module's {'params'} and {'batch_stats'} subtrees (numpy
    leaves) -> the port's DESA state_dict."""
    sd: StateDict = {}
    _desa(sd, 'FA', params, batch_stats)
    return {k[len('FA.'):]: v for k, v in sd.items()}


def _fusion_block(sd: StateDict, pre: str, p: dict, s: dict) -> None:
    for jn, tn in EMBEDDINGS:
        _dense(sd, f'{pre}.{tn}.0', p[jn]['dense'], 1)
        _bn(sd, f'{pre}.{tn}.1', p[jn]['bn'], s[jn]['bn'])
    _desa(sd, f'{pre}.FA', p['FA'], s['FA'])
    _kp_interaction(sd, f'{pre}.init_TR', p['init_TR'])
    _kp_interaction(sd, f'{pre}.final_TR', p['final_TR'])
    _cross_decoder(sd, f'{pre}.crossTR', p['crossTR'])
    _conv2d(sd, f'{pre}.atten_spatial', p['atten_spatial'])
    sd[f'{pre}.fc_spatial2joint_feature.weight'] = _t(
        np.asarray(p['fc_spatial2joint_w']).T)
    sd[f'{pre}.fc_spatial2joint_feature.bias'] = _t(p['fc_spatial2joint_b'])
    sd[f'{pre}.weight_dis'] = _t(p['weight_dis'])


def jax_kpfusion_to_state_dict(variables: dict,
                               net: str = 'KPFusion-resnet-18'
                               ) -> StateDict:
    """JAX KPFusion variables {'params', 'batch_stats'} (numpy leaves) ->
    the port's KPFusion state_dict (float32 CPU tensors), for either
    backbone family (`net` as Config.net)."""
    size = net.split('-')[-1]
    p, s = variables['params'], variables['batch_stats']
    sd: StateDict = {}
    for name in ('backbone_d', 'backbone_rgb'):
        if 'convnext' in net:
            _convnext_unet(sd, f'{name}.', p[name], s[name], size)
        else:
            _resnet_unet(sd, f'{name}.', p[name], s[name], int(size))
    i = 1
    while f'block{i}' in p:
        _fusion_block(sd, f'block{i}', p[f'block{i}'], s[f'block{i}'])
        i += 1
    return sd


def strip_module_prefix(sd: StateDict) -> StateDict:
    """The DataParallel `module.` prefix taken off every key."""
    return {(k[7:] if k.startswith('module.') else k): v
            for k, v in sd.items()}


def merge_partial(init: StateDict, loaded: StateDict
                  ) -> Tuple[StateDict, List[str], List[str]]:
    """Every key of `init`, from `loaded` where it holds the key with the
    same shape, from `init` otherwise (a 21-joint checkpoint then
    warm-starts a 14-joint model). Returns (merged, used: the keys taken
    from `loaded`, skipped: those it holds with another shape)."""
    merged, used, skipped = {}, [], []
    for key, value in init.items():
        cand = loaded.get(key)
        if cand is not None and tuple(cand.shape) == tuple(value.shape):
            merged[key] = cand
            used.append(key)
        else:
            if cand is not None:
                skipped.append(key)
            merged[key] = value
    return merged, used, skipped


def load_torch_checkpoint(path: str) -> StateDict:
    """A `.pth`'s state_dict on the CPU: `{'model': sd}` (the reference's
    and the port trainer's checkpoints) or a bare sd, with the `module.`
    prefix stripped. The port's names are the reference's, so a released
    checkpoint needs no conversion."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    return strip_module_prefix(ckpt.get('model', ckpt))


def load_kpfusion_weights(model: torch.nn.Module, sd: StateDict) -> None:
    """Every tensor of `model` from `sd` (a released reference state_dict
    or a port checkpoint's): raises if one is missing or of another shape,
    as the JAX package's converter does. Other keys are the reference's
    modules that its forward never runs, and are dropped: the ConvNeXt
    decoder's `feat_emb`, the skip convs of equal-width Residuals, the
    cross decoder's norm1."""
    missing = model.load_state_dict(sd, strict=False).missing_keys
    if missing:
        raise KeyError(f'{len(missing)} weights missing from the '
                       f'checkpoint: {missing[:8]}')


def jax_mano_head_to_state_dict(params: dict) -> StateDict:
    """A JAX ManoRegHead's {'params'} subtree (numpy leaves) -> the port's
    mano/mano_head.py:ManoRegHead state_dict: each flax Dense kernel
    [in, out] and bias -> nn.Linear weight [out, in] and bias, under the
    flax module's names (base_0, base_1, ... for its `neurons`, pose_reg,
    shape_reg). The reference's mano_regHead names could not be read
    here, and no released checkpoint holds this head (the reference never
    wires it into KPFusion), so the names are the flax module's."""
    sd: StateDict = {}
    for name, p in params.items():
        _dense(sd, name, p)
    return sd


def mano_head_state_dict_to_jax(sd: StateDict) -> dict:
    """The inverse of jax_mano_head_to_state_dict: the port's ManoRegHead
    state_dict -> flax params {name: {'kernel' [in, out], 'bias'}} (numpy
    float32)."""
    params: dict = {}
    for key, v in sd.items():
        name, leaf = key.rsplit('.', 1)
        v = v.detach().cpu().float().numpy()
        layer = params.setdefault(name, {})
        if leaf == 'weight':
            layer['kernel'] = v.T.copy()
        else:
            layer['bias'] = v.copy()
    return params


# ------------------------------------------------- the optional families --

def _conv_bn_relu(sd: StateDict, pre: str, p: dict, s: dict) -> None:
    _conv2d(sd, f'{pre}.conv', p['conv'])
    if 'bn' in p:
        _bn(sd, f'{pre}.bn', p['bn'], s['bn'])


def _hourglass(sd: StateDict, pre: str, p: dict, s: dict) -> None:
    for name in ('up1', 'low1', 'low3'):
        _residual(sd, f'{pre}.{name}', p[name], s[name])
    if 'up1' in p['low2']:
        _hourglass(sd, f'{pre}.low2', p['low2'], s['low2'])
    else:
        _residual(sd, f'{pre}.low2', p['low2'], s['low2'])


def jax_posenet_to_state_dict(variables: dict) -> StateDict:
    """A JAX PoseNet's variables {'params', 'batch_stats'} (numpy leaves)
    -> the port's models/legacy.py:PoseNet state_dict."""
    p, s = variables['params'], variables['batch_stats']
    sd: StateDict = {}
    _conv_bn_relu(sd, 'pre_conv', p['pre_conv'], s['pre_conv'])
    for name in ('pre_res1', 'pre_res2', 'pre_res3'):
        _residual(sd, name, p[name], s[name])
    i = 0
    while f'hg_{i}' in p:
        _hourglass(sd, f'hg_{i}', p[f'hg_{i}'], s[f'hg_{i}'])
        _residual(sd, f'feat_res_{i}', p[f'feat_res_{i}'],
                  s[f'feat_res_{i}'])
        _conv_bn_relu(sd, f'feat_conv_{i}', p[f'feat_conv_{i}'],
                      s[f'feat_conv_{i}'])
        for name in ('out1', 'out2', 'out3', 'merge_preds', 'merge_feats'):
            if f'{name}_{i}' in p:
                _conv2d(sd, f'{name}_{i}', p[f'{name}_{i}'])
        i += 1
    return sd


def jax_cbam_to_state_dict(variables: dict) -> StateDict:
    """A JAX CBAM's variables -> the port's models/legacy.py:CBAM
    state_dict (channel_gate.fc1/fc2, spatial_gate.spatial_conv/_bn)."""
    p = variables['params']
    sd: StateDict = {}
    for name in ('fc1', 'fc2'):
        _dense(sd, f'channel_gate.{name}', p['channel_gate'][name])
    if 'spatial_gate' in p:
        g, gs = p['spatial_gate'], variables['batch_stats']['spatial_gate']
        _conv2d(sd, 'spatial_gate.spatial_conv', g['spatial_conv'])
        _bn(sd, 'spatial_gate.spatial_bn', g['spatial_bn'], gs['spatial_bn'])
    return sd


def jax_centernet_to_state_dict(variables: dict,
                                depth: int = 18) -> StateDict:
    """A JAX CenterNetRegressor's variables -> the port's
    models/legacy.py:CenterNetRegressor state_dict (the ResNet under
    `backbone.` with torchvision's names, `fc`)."""
    p, s = variables['params'], variables['batch_stats']
    sd: StateDict = {}
    _resnet(sd, 'backbone.', p['backbone'], s['backbone'], depth)
    _dense(sd, 'fc', p['fc'])
    return sd


def jax_rgbd_fusion_to_state_dict(params: dict) -> StateDict:
    """A JAX RGBDFusion's {'params'} -> the port's RGBDFusion
    state_dict."""
    sd: StateDict = {}
    for name in ('gate_rgb', 'gate_depth'):
        _conv2d(sd, name, params[name])
    return sd


def jax_acfusion_to_state_dict(params: dict) -> StateDict:
    """A JAX ACFusion's {'params'} -> the port's ACFusion state_dict."""
    sd: StateDict = {}
    for name in ('cam_rgb', 'cam_depth'):
        _conv2d(sd, name, params[name])
    return sd


def jax_fsp_to_state_dict(params: dict) -> StateDict:
    """A JAX FSP's {'params'} -> the port's FSP state_dict."""
    sd: StateDict = {}
    for name in ('fc1', 'fc2'):
        _dense(sd, f'filter.{name}', params['filter'][name])
    return sd


def _prefixed(sd: StateDict, pre: str, part: StateDict) -> None:
    sd.update({f'{pre}{k}': v for k, v in part.items()})


def jax_rgbd_resnet_unet_to_state_dict(variables: dict,
                                       depth: int = 18) -> StateDict:
    """A JAX RGBDResNetUNet's variables -> the port's
    models/rgbd_fusion.py:RGBDResNetUNet state_dict."""
    p, s = variables['params'], variables['batch_stats']
    bp, bs = p['backbone'], s['backbone']
    sd: StateDict = {}
    for tag in ('', 'depth_'):
        _conv2d(sd, f'backbone.{tag}conv1', bp[f'{tag}conv1'])
        _bn(sd, f'backbone.{tag}bn1', bp[f'{tag}bn1'], bs[f'{tag}bn1'])
    for stage, nblocks in enumerate(STAGES[depth][1]):
        for i in range(nblocks):
            jn, tn = f'layer{stage + 1}_{i}', f'backbone.layer{stage + 1}.{i}'
            for name, leaf in bp[jn].items():
                if name.startswith(('conv', 'depth_conv', 'downsample_conv')):
                    _conv2d(sd, f'{tn}.{name}', leaf)
                else:
                    _bn(sd, f'{tn}.{name}', leaf, bs[jn][name])
        _prefixed(sd, f'backbone.rgbd_fusion_{stage}.',
                  jax_rgbd_fusion_to_state_dict(bp[f'rgbd_fusion_{stage}']))
    for name, _ in UNET_RESIDUALS:
        _residual(sd, name, p[name], s[name])
    i = 0
    while f'final_{i}' in p:
        _conv2d(sd, f'finals.{i}', p[f'final_{i}'])
        i += 1
    return sd


def _image_cross_layers(sd: StateDict, p: dict, pos_name: str) -> None:
    i = 0
    while f'layer_{i}' in p:
        lp, lt = p[f'layer_{i}'], f'layer_{i}'
        sd[f'{pos_name}_{i}.weight'] = _t(p[f'{pos_name}_{i}']['embedding'])
        a = lp['cross_attn']
        names = ('query', 'key', 'value')
        sd[f'{lt}.cross_attn.in_proj_weight'] = _t(np.concatenate(
            [_head_kernel(a[n]['kernel']) for n in names]))
        sd[f'{lt}.cross_attn.in_proj_bias'] = _t(np.concatenate(
            [np.asarray(a[n]['bias']).reshape(-1) for n in names]))
        _mha_out(sd, f'{lt}.cross_attn.out_proj', a['out'])
        for name in ('norm2', 'norm3'):
            _layernorm(sd, f'{lt}.{name}', lp[name])
        for name in ('linear1', 'linear2'):
            _dense(sd, f'{lt}.{name}', lp[name])
        i += 1


def jax_detr_decoder_to_state_dict(params: dict) -> StateDict:
    """A JAX DetrDecoder's {'params'} -> the port's
    models/transformer_extra.py:DetrDecoder state_dict."""
    sd: StateDict = {}
    _image_cross_layers(sd, params, 'query_pos')
    return sd


def jax_spatial_aggregate_tr_to_state_dict(params: dict) -> StateDict:
    """A JAX SpatialAggregateTR's {'params'} -> the port's
    SpatialAggregateTR state_dict."""
    sd: StateDict = {}
    _image_cross_layers(sd, params, 'key_pos')
    return sd
