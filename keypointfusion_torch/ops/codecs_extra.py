"""The feature-type dispatch of the pixel stage's codecs (port of the
default branch of keypointfusion_tpu/ops/codecs_extra.py).

Only the 'weight_offset' feature type, the configuration's default, is
ported: the other encodings and decodings are ROADMAP.md §1 item 17 and
raise NotImplementedError.
"""

from __future__ import annotations

import torch

from keypointfusion_torch.ops.codecs import (
    joint_to_offset, offset_to_joint_weight,
)


def _not_ported(ftype: str) -> NotImplementedError:
    return NotImplementedError(
        f'feature type {ftype!r} is not ported (ROADMAP.md §1 item 17); '
        "only 'weight_offset' is")


def joint_to_feature(joint, depth, feature_paras, feature_size,
                     feature_types):
    """GT encoding: per (para, type) pair the dense map of that type,
    concatenated on the channels. 'weight_offset' is joint_to_offset's
    [B,fs,fs,4J]."""
    feats = []
    for para, ftype in zip(feature_paras, feature_types):
        if ftype != 'weight_offset':
            raise _not_ported(ftype)
        feats.append(joint_to_offset(joint, depth, para, feature_size))
    return torch.cat(feats, dim=-1)


def feature_to_joint(depth, pixel_pd, feature_types, feature_paras,
                     joint_num=None):
    """Prediction decode by the first feature type: 'weight_offset' is
    offset_to_joint_weight over the whole 5J map (joint_num is unused
    there, as in the JAX function)."""
    ftype = feature_types[0]
    if ftype != 'weight_offset':
        raise _not_ported(ftype)
    return offset_to_joint_weight(pixel_pd, depth, feature_paras[0])
