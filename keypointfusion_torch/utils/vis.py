"""Pose visualization: the skeleton overlays of the demo and the
trainer's eval images (port of keypointfusion_tpu/utils/vis.py, the
reference's util/vis_tool.py).

The colour and skeleton tables, their getters, and the single-image
renderers draw_point, draw_pose, draw_visible, draw_2d_pose,
draw_2d_pose_only and draw_2d_pose_rgb, drawing with utils/raster.py so
that an overlay equals the JAX package's cv2 one bit for bit. The JAX
module's debug renderers (draw_heatmap, draw_offset_field, draw_pcl*, the
debug_* writers, draw_muti_pic, debug_mesh), which no caller of the JAX
package uses, are not ported.
"""

from __future__ import annotations

import numpy as np

from keypointfusion_torch.utils import raster

# ---------------------------------------------------------------------------
# color tables (vis_tool.py:185-202, BGR)

COLORS = {
    'RED': (0, 0, 255),
    'GREEN': (75, 255, 66),
    'BLUE': (255, 0, 0),
    'YELLOW': (204, 153, 17),
    'PURPLE': (255, 255, 0),
    'CYAN': (255, 0, 255),
    'BROWN': (204, 153, 17),
}
FINGER_COLORS = {
    'T': (0, 0, 255),      # thumb
    'I': (75, 255, 66),    # index
    'M': (255, 0, 0),      # middle
    'R': (17, 240, 244),   # ring
    'L': (255, 255, 0),    # little
    'W': (255, 0, 255),    # wrist
    'O': (255, 0, 255),    # root
}
THUMB, INDEX, MIDDLE = FINGER_COLORS['T'], FINGER_COLORS['I'], \
    FINGER_COLORS['M']
RING, LITTLE, WRIST = FINGER_COLORS['R'], FINGER_COLORS['L'], \
    FINGER_COLORS['W']


def _expand(spec: str, table=FINGER_COLORS):
    """'T*4 I*4' -> [THUMB x4, INDEX x4]; single letters allowed."""
    out = []
    for tok in spec.split():
        if '*' in tok:
            key, n = tok.split('*')
            out.extend([table[key]] * int(n))
        else:
            out.append(table[tok])
    return out


# ---------------------------------------------------------------------------
# skeletons (vis_tool.py:74-129)

# MANO visualization order skeleton (vis_tool.py:76-82)
HAND_SKELETON = [
    [0, 13], [13, 14], [14, 15], [15, 20],
    [0, 1], [1, 2], [2, 3], [3, 16],
    [0, 4], [4, 5], [5, 6], [6, 17],
    [0, 10], [10, 11], [11, 12], [12, 19],
    [0, 7], [7, 8], [8, 9], [9, 18],
]
NYU_SKELETON = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [9, 10], [1, 13],
                [3, 13], [5, 13], [7, 13], [10, 13], [11, 13], [12, 13]]
NYU_ALL_SKELETON = (
    [[4 * f + k, 4 * f + k + 1] for f in range(5) for k in range(3)]
    + [[3, 20], [7, 20], [11, 20], [15, 20], [19, 20], [20, 21], [20, 22]])
ICVL_SKELETON = [[0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6],
                 [0, 7], [7, 8], [8, 9], [0, 10], [10, 11], [11, 12],
                 [0, 13], [13, 14], [14, 15]]
MSRA_SKELETON = [[0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7],
                 [7, 8], [0, 9], [9, 10], [10, 11], [11, 12], [0, 13],
                 [13, 14], [14, 15], [15, 16], [0, 17], [17, 18], [18, 19],
                 [19, 20]]
ITOP_SKELETON = [[0, 1], [1, 2], [2, 4], [4, 6], [1, 3], [3, 5], [5, 7],
                 [1, 8], [8, 9], [9, 11], [11, 13], [8, 10], [10, 12],
                 [12, 14]]
SHREC_SKELETON = [[0, 1],
                  [0, 2], [2, 3], [3, 4], [4, 5],
                  [0, 6], [6, 7], [7, 8], [8, 9],
                  [0, 10], [10, 11], [11, 12], [12, 13],
                  [0, 14], [14, 15], [15, 16], [16, 17],
                  [0, 18], [18, 19], [19, 20], [20, 21]]


def get_sketch_setting(dataset: str):
    """Bone list per dataset (vis_tool.py:74-129). MANO order is the
    default (DexYCB/HO3D/STB/FHAD/hands*)."""
    if dataset == 'nyu':
        return NYU_SKELETON
    if dataset == 'nyu_all':
        return NYU_ALL_SKELETON
    if dataset == 'icvl':
        return ICVL_SKELETON
    if dataset == 'msra':
        return MSRA_SKELETON
    if dataset == 'itop':
        return ITOP_SKELETON
    if dataset == 'shrec' or 'DHG' in dataset:
        return SHREC_SKELETON
    return HAND_SKELETON


# back-compat alias used by utils/graph.py and older call sites
def get_skeleton(dataset: str):
    return get_sketch_setting(dataset)


# per-bone colors (vis_tool.py:205-261)
_SKETCH_COLORS = {
    'default': _expand('T*4 I*4 M*4 R*4 L*4'),
    'nyu': _expand('L R M I T T L R M I T T W W'),
    'nyu_all': _expand('L*3 R*3 M*3 I*3 T*3 L R M I T T W W'),
    'icvl': _expand('T*3 I*3 M*3 R*3 L*3'),
    'msra': _expand('I*4 M*4 R*4 L*4 T*4'),
    'itop': _expand('RED GREEN*3 BLUE*3 CYAN YELLOW*3 PURPLE*3', COLORS),
    'shrec': _expand('O T*4 I*4 M*4 R*4 L*4'),
}
# per-joint colors (vis_tool.py:264-322)
_JOINT_COLORS = {
    'default': _expand('O I*3 M*3 L*3 R*3 T*3 I M L R T'),
    'nyu': _expand('L*2 R*2 M*2 I*2 T*3 W*3'),
    'nyu_all': _expand('L*4 R*4 M*4 I*4 T*4 W*3'),
    'icvl': _expand('O T*3 I*3 M*3 R*3 L*3'),
    'msra': _expand('W I*4 M*4 R*4 L*4 T*4'),
    'itop': _expand(
        'RED BROWN GREEN BLUE GREEN BLUE GREEN BLUE CYAN '
        'YELLOW PURPLE YELLOW PURPLE YELLOW PURPLE', COLORS),
    'shrec': _expand('O*2 T*4 I*4 M*4 R*4 L*4'),
}


def _color_key(dataset: str):
    if dataset in ('nyu', 'nyu_all', 'icvl', 'msra', 'itop'):
        return dataset
    if dataset == 'shrec' or 'DHG' in dataset:
        return 'shrec'
    return 'default'


def get_sketch_color(dataset: str):
    return _SKETCH_COLORS[_color_key(dataset)]


def get_joint_color(dataset: str):
    return _JOINT_COLORS[_color_key(dataset)]


def get_hierarchy_mapping(dataset: str):
    """Joint-grouping pyramid per dataset (vis_tool.py:132-143)."""
    if 'nyu_all' == dataset:
        return [[[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10, 11],
                 [12, 13], [14, 15], [16, 17], [18, 19], [20]],
                [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10]],
                [[0, 1, 2, 3, 4, 5]]]
    if 'nyu' == dataset:
        return [[[0, 1], [2, 3], [4, 5], [6, 7], [8, 9, 10], [11, 12, 13]]]
    # mano / hands*
    return [[[0], [1, 2], [3, 16], [4, 5], [6, 17], [10, 11], [12, 19],
             [7, 8], [9, 18], [13, 14], [15, 20]],
            [[0], [1, 2], [3, 4], [7, 8], [5, 6], [9, 10]],
            [[0, 1, 2, 3, 4, 5]]]


def get_hierarchy_sketch(dataset: str):
    """Skeletons at each hierarchy level (vis_tool.py:157-182)."""
    if 'nyu_all' == dataset:
        return (NYU_ALL_SKELETON,
                [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [1, 10], [3, 10],
                 [5, 10], [7, 10], [9, 10]],
                [[0, 5], [1, 5], [2, 5], [3, 5], [4, 5]],
                [[0, 0]])
    if 'nyu' == dataset:
        return (NYU_SKELETON,
                [[0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [1, 5], [2, 5],
                 [3, 5], [4, 5]])
    # mano / hands*
    return (HAND_SKELETON,
            [[0, 1], [0, 3], [0, 5], [0, 7], [0, 9], [1, 2], [3, 4],
             [5, 6], [7, 8], [9, 10]],
            [[0, 1], [0, 2], [0, 3], [0, 4], [0, 5]],
            [[0, 0]])


# ---------------------------------------------------------------------------
# single-image renderers

def draw_point(dataset: str, img: np.ndarray, pose: np.ndarray
               ) -> np.ndarray:
    """Root-colored dots at each joint (vis_tool.py:325-331 — the
    reference indexes colors_joint[0] for every point, replicated)."""
    img = np.ascontiguousarray(img)
    color = get_joint_color(dataset)[0]
    for pt in np.asarray(pose):
        raster.circle(img, (int(pt[0]), int(pt[1])), 3, color, -1)
    return img


def draw_pose(dataset: str, img: np.ndarray, joint_uvd: np.ndarray,
              scale: int = 1) -> np.ndarray:
    """Skeleton overlay with the dataset's per-joint / per-bone colors;
    joint_uvd in pixel coords [J,>=2] (vis_tool.py:334-351, including its
    stop conditions: extra joints beyond the color table are not drawn,
    bones referencing missing joints end the sketch)."""
    img = np.ascontiguousarray(img)
    pose = np.asarray(joint_uvd)
    joint_colors = get_joint_color(dataset)
    for j in range(min(pose.shape[0], len(joint_colors))):
        raster.circle(img, (int(pose[j, 0]), int(pose[j, 1])), 2 * scale,
                      joint_colors[j], -1)
    bone_colors = get_sketch_color(dataset)
    for i, (a, b) in enumerate(get_sketch_setting(dataset)):
        if a >= pose.shape[0] or b >= pose.shape[0]:
            break
        raster.line(img, (int(pose[a, 0]), int(pose[a, 1])),
                    (int(pose[b, 0]), int(pose[b, 1])), bone_colors[i],
                    1 * scale)
    return img


def draw_visible(dataset: str, img: np.ndarray, pose: np.ndarray,
                 visible: np.ndarray) -> np.ndarray:
    """Joints colored by visibility (RED=occluded idx 0, BLUE=visible
    idx 1), brown bones (vis_tool.py:513-524)."""
    img = np.ascontiguousarray(img)
    vis_colors = [COLORS['RED'], COLORS['BLUE']]
    pose = np.asarray(pose)
    for j, pt in enumerate(pose):
        raster.circle(img, (int(pt[0]), int(pt[1])), 3,
                      vis_colors[int(visible[j])], -1)
    for a, b in get_sketch_setting(dataset):
        raster.line(img, (int(pose[a, 0]), int(pose[a, 1])),
                    (int(pose[b, 0]), int(pose[b, 1])), COLORS['BROWN'], 1)
    return img


def draw_2d_pose(depth_hw1: np.ndarray, joint_uvd_nl: np.ndarray,
                 dataset: str = 'dexycb') -> np.ndarray:
    """Depth crop [S,S,1] in [-1,1] + normalized uvd → BGR overlay
    (vis_tool.py:487-492)."""
    s = depth_hw1.shape[0]
    joints = (np.asarray(joint_uvd_nl) + 1) / 2 * s
    gray = ((np.asarray(depth_hw1)[..., 0] + 1) / 2 * 255).astype(np.uint8)
    return draw_pose(dataset, raster.gray_to_bgr(gray), joints)


def draw_2d_pose_only(joint_uvd_nl: np.ndarray, size: int,
                      dataset: str = 'dexycb') -> np.ndarray:
    """Skeleton on a white background (vis_tool.py:494-500, which
    overwrites the input image with 1s)."""
    white = np.full((size, size, 1), 1.0, np.float32)
    return draw_2d_pose(white, joint_uvd_nl, dataset)


def draw_2d_pose_rgb(rgb_hw3: np.ndarray, joint_uvd_nl: np.ndarray,
                     dataset: str = 'dexycb') -> np.ndarray:
    """RGB crop [S,S,3] in [0,1] + normalized uvd → overlay
    (vis_tool.py:502-510)."""
    s = rgb_hw3.shape[0]
    joints = (np.asarray(joint_uvd_nl) + 1) / 2 * s
    img = (np.asarray(rgb_hw3) * 255).astype(np.uint8)
    return draw_pose(dataset, img, joints)
