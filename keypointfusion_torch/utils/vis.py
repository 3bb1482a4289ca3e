"""Pose visualization and the debug renderers (port of
keypointfusion_tpu/utils/vis.py, the reference's util/vis_tool.py).

The colour and skeleton tables and their getters; the single-image
renderers draw_point, draw_pose, draw_visible, draw_2d_pose,
draw_2d_pose_only and draw_2d_pose_rgb, which the demo and the trainer's
eval images use; and the debug family: draw_heatmap, draw_offset_field,
draw_pcl, draw_pcl_batch, the batch writers debug_2d_img, debug_2d_pose,
debug_2d_pose_select, debug_img_heatmap, debug_2d_heatmap,
debug_visible_joint and debug_pcl_pose, the montage draw_muti_pic and
the mesh dump debug_mesh. They are host numpy: a tensor is passed after
.cpu().

Every renderer equals the JAX package's, which draws with cv2, bit for
bit, returned arrays and written files alike: the drawing is
utils/raster.py's, the resizes, colour map, blend and float-to-uint8
conversion data/cv_ops.py's, the PNGs data/image_io.py's imwrite (read
back, they hold the same pixels). The one divergence is draw_muti_pic's
caption: cv2 5.0 draws FONT_HERSHEY_COMPLEX through an embedded,
anti-aliased TrueType face, which the port does not carry; it draws the
caption at the same origin and in the same colour in a 5x7 bitmap font
(_FONT), every pixel of it inside the box cv2.getTextSize gives for
cv2's caption. Outside that box the montage is cv2's, bit for bit.
"""

from __future__ import annotations

import os

import numpy as np

from keypointfusion_torch.data import cv_ops
from keypointfusion_torch.data.image_io import imwrite
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


def draw_heatmap(depth_hw1, heatmap_hw, alpha: float = 0.5) -> np.ndarray:
    """Overlay a per-joint heatmap on a depth crop (debug renderer,
    vis_tool.py heatmap debug family)."""
    s = depth_hw1.shape[0]
    gray = ((np.asarray(depth_hw1)[..., 0] + 1) / 2 * 255).astype(np.uint8)
    base = raster.gray_to_bgr(gray)
    hm = np.asarray(heatmap_hw)
    hm = hm / (hm.max() + 1e-8)
    hm_img = cv_ops.apply_colormap_jet((hm * 255).astype(np.uint8))
    if hm_img.shape[:2] != (s, s):
        hm_img = cv_ops.resize(hm_img, (s, s))
    return cv_ops.add_weighted(base, 1 - alpha, hm_img, alpha, 0)


def draw_offset_field(depth_hw1, offset_map, joint_id: int = 0,
                      stride: int = 4) -> np.ndarray:
    """Arrow rendering of a joint's dense unit-offset field — the
    equivalent of the reference's plt.quiver dump (vis_tool.py:410-426).
    offset_map [H,W,4J+] with joint-major 3J offsets (channel j*3+axis,
    as ops/codecs.py encodes them)."""
    s = depth_hw1.shape[0]
    gray = ((np.asarray(depth_hw1)[..., 0] + 1) / 2 * 255).astype(np.uint8)
    img = raster.gray_to_bgr(gray)
    off = np.asarray(offset_map)
    h, w = off.shape[:2]
    scale = s / h
    for y in range(0, h, stride):
        for x in range(0, w, stride):
            du = off[y, x, joint_id * 3 + 0]
            dv = off[y, x, joint_id * 3 + 1]
            if du == 0 and dv == 0:
                continue
            p0 = (int(x * scale), int(y * scale))
            p1 = (int(x * scale + du * 8), int(y * scale + dv * 8))
            raster.arrowed_line(img, p0, p1, (0, 255, 0), 1, tip_length=0.3)
    return img


def draw_pcl(pcl, size: int = 256) -> np.ndarray:
    """Top-down scatter of one normalized point cloud, depth-colored
    (debug renderer)."""
    img = np.zeros((size, size, 3), np.uint8)
    pts = np.asarray(pcl)
    uv = ((pts[:, :2] + 1) / 2 * size).astype(int)
    keep = (uv[:, 0] >= 0) & (uv[:, 0] < size) & (uv[:, 1] >= 0) & \
        (uv[:, 1] < size)
    depth_color = ((pts[keep, 2] + 1) / 2 * 255).astype(np.uint8)
    for (u, v), c in zip(uv[keep], depth_color):
        raster.circle(img, (u, v), 1, (int(c), 128, 255 - int(c)), -1)
    return img


def draw_pcl_batch(pcl, img_size: int, background_value: float = 1.0
                   ) -> np.ndarray:
    """Batched binary scatter: [B,N,3] normalized xyz → [B,S,S,1] float
    maps with background_value and -1 at occupied pixels
    (vis_tool.py:537-547), one scatter per batch."""
    pts = np.asarray(pcl)
    b, n = pts.shape[:2]
    ix = np.clip(np.floor((pts[..., 0] + 1) / 2 * img_size), 0,
                 img_size - 1).astype(np.int64)
    iy = np.clip(np.floor((pts[..., 1] + 1) / 2 * img_size), 0,
                 img_size - 1).astype(np.int64)
    img = np.full((b, img_size, img_size), background_value, np.float32)
    bi = np.repeat(np.arange(b), n)
    img[bi, iy.reshape(-1), ix.reshape(-1)] = -1.0
    return img[..., None]


# ---------------------------------------------------------------------------
# batch debug renderers / file dumpers (vis_tool.py:354-534,572-591)
# All take NHWC numpy batches; `save=True`/a data_dir writes the
# reference's file layout so debug dirs are diffable across frameworks.

def _write(path: str, img) -> None:
    """cv2.imwrite(path, img) of a PNG: uint8 and uint16 as they are, any
    other depth through convertTo(CV_8U)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        img = cv_ops.to_u8_saturate(img)
    imwrite(path, img)


def _to_u8_gray(img_b_hw1):
    return ((np.asarray(img_b_hw1)[..., 0] + 1) / 2 * 255).astype(np.uint8)


def debug_2d_img(img, batch_index: int, data_dir: str, name: str,
                 save: bool = True) -> np.ndarray:
    """Dump each [-1,1] gray channel as a PNG (vis_tool.py:446-455).
    img [B,S,S,C] → [B*C,S,S,3]."""
    arr = np.asarray(img)
    b, s = arr.shape[0], arr.shape[1]
    out = []
    for bi in range(b):
        for c in range(arr.shape[-1]):
            gray = ((arr[bi, ..., c] + 1) / 2 * 255).astype(np.uint8)
            bgr = raster.gray_to_bgr(gray)
            if save:
                _write(os.path.join(
                    data_dir, f'{b * batch_index + bi}_{c}_{name}.png'), bgr)
            out.append(bgr)
    return np.stack(out, axis=0)


def debug_2d_pose(img, joint_uvd_nl, batch_index: int, dataset: str,
                  data_dir: str, name: str, save: bool = False
                  ) -> np.ndarray:
    """Batch skeleton overlays on depth crops (vis_tool.py:458-469).
    img [B,S,S,1] in [-1,1], joint_uvd_nl [B,J,3] normalized."""
    gray = _to_u8_gray(img)
    b, s = gray.shape[0], gray.shape[1]
    joints = (np.asarray(joint_uvd_nl) + 1) / 2 * s
    out = []
    for bi in range(b):
        shown = draw_pose(dataset, raster.gray_to_bgr(gray[bi]), joints[bi],
                          max(s // 128, 1))
        if save:
            _write(os.path.join(
                data_dir, f'{b * batch_index + bi}_{name}.png'), shown)
        out.append(shown)
    return np.stack(out, axis=0)


def debug_2d_pose_select(img, joint_uvd_nl, batch_index: int, dataset: str,
                         data_dir: str, name: str, select_id,
                         save: bool = False) -> None:
    """Like debug_2d_pose but files are named by select_id (the sample's
    global id), used for worst-case dumps (vis_tool.py:473-485)."""
    gray = _to_u8_gray(img)
    b, s = gray.shape[0], gray.shape[1]
    joints = (np.asarray(joint_uvd_nl) + 1) / 2 * s
    for bi, sample_id in enumerate(np.asarray(select_id).tolist()):
        shown = draw_pose(dataset, raster.gray_to_bgr(gray[bi]), joints[bi],
                          max(s // 128, 1))
        if save:
            _write(os.path.join(
                data_dir, f'{b * batch_index + int(sample_id)}_{name}.png'),
                shown)


def debug_img_heatmap(img, heatmap, batch_index: int, data_dir: str,
                      size: int, img_type: str = 'heatmap',
                      save: bool = False) -> np.ndarray:
    """Per-joint jet-colored heatmaps blended onto the (resized) depth
    crop, one PNG per (sample, joint) (vis_tool.py:354-377).
    img [B,S,S,1] in [-1,1]; heatmap [B,J,h,w]. Returns the float32
    images, squeezed."""
    hm = np.asarray(heatmap, np.float32)
    b, j = hm.shape[:2]
    flat = hm.reshape(b, j, -1)
    flat = flat - flat.min(axis=-1, keepdims=True)
    flat = flat / (flat.max(axis=-1, keepdims=True) + 1e-8)
    hm = flat.reshape(hm.shape)
    gray = _to_u8_gray(img)
    out = []
    for bi in range(b):
        base = cv_ops.resize(gray[bi], (size, size))
        base = raster.gray_to_bgr(base).astype(np.float32) / 2
        for ji in range(j):
            hmap = cv_ops.resize_linear(hm[bi, ji], (size, size))
            # reference maps 1-h through jet; COLORMAP_JET(255*(1-h))
            color = cv_ops.apply_colormap_jet(
                (255 * (1 - hmap)).astype(np.uint8)).astype(np.float32)
            shown = base + color
            if save:
                _write(os.path.join(
                    data_dir, f'{img_type}_{b * batch_index + bi}_{ji}.png'),
                    shown)
            out.append(shown)
    return np.stack(out, axis=0).squeeze()


def debug_2d_heatmap(heatmap, batch_index: int, data_dir: str, size: int,
                     img_type: str = 'heatmap', save: bool = False):
    """Jet-colored raw heatmaps, no image blend (vis_tool.py:380-407);
    0 for an empty batch."""
    hm = np.asarray(heatmap, np.float32)
    b, j = hm.shape[:2]
    if b == 0:
        return 0
    out = []
    for bi in range(b):
        for ji in range(j):
            hmap = cv_ops.resize_linear(hm[bi, ji], (size, size))
            color = cv_ops.apply_colormap_jet(
                (255 * np.clip(1 - hmap, 0, 1)).astype(np.uint8)
            ).astype(np.float32)
            if save:
                _write(os.path.join(
                    data_dir, f'{img_type}_{b * batch_index + bi}_{ji}.png'),
                    color)
            out.append(color)
    return np.stack(out, axis=0).squeeze()


def debug_visible_joint(img, joint_uvd_nl, visible, batch_index: int,
                        dataset: str, data_dir: str, name: str) -> None:
    """Visibility-colored batch overlays written to disk
    (vis_tool.py:527-534)."""
    gray = _to_u8_gray(img)
    b, s = gray.shape[0], gray.shape[1]
    joints = (np.asarray(joint_uvd_nl) + 1) / 2 * s
    vis = np.asarray(visible).astype(np.int32)
    for bi in range(b):
        shown = draw_visible(dataset, raster.gray_to_bgr(gray[bi]),
                             joints[bi], vis[bi])
        _write(os.path.join(
            data_dir, f'{b * batch_index + bi}_{name}.png'), shown)


def debug_pcl_pose(pcl, joint_xyz_nl, batch_index: int, dataset: str,
                   data_dir: str, name: str) -> None:
    """Point-cloud scatter + skeleton overlay per sample
    (vis_tool.py:550-569)."""
    pts = np.asarray(pcl)
    b = pts.shape[0]
    if b == 0:
        return
    imgs = draw_pcl_batch(pts, 128)
    joints = (np.asarray(joint_xyz_nl) + 1) / 2 * 128
    for bi in range(b):
        gray = ((imgs[bi, ..., 0] + 1) / 2 * 255).astype(np.uint8)
        shown = draw_pose(dataset, raster.gray_to_bgr(gray), joints[bi])
        _write(os.path.join(
            data_dir, f'{b * batch_index + bi}-{name}.png'), shown)


# The caption font: printable ASCII (32-126), a glyph's columns left to
# right, bit r of a column's byte set where row r (0 at the top) is inked;
# a glyph's advance is its width + 1 (the space's 3), never more than
# cv2 5.0's advance for FONT_HERSHEY_COMPLEX at scale 0.5 (3-13 px).
_FONT = (
    '', '5f', '070007', '147f147f14', '242a7f2a12', '2313086462',
    '3649552250', '0503', '1c2241', '41221c', '142a1c2a14', '08083e0808',
    '5030', '0808080808', '6060', '2010080402', '3e5149453e', '427f40',
    '4261514946', '2141454b31', '1814127f10', '2745454539', '3c4a494930',
    '0171090503', '3649494936', '064949291e', '3636', '5636', '08142241',
    '1414141414', '41221408', '0201510906', '3249794136', '7e1111117e',
    '7f49494936', '3e41414122', '7f4141221c', '7f49494941', '7f09090101',
    '3e41415132', '7f0808087f', '417f41', '2040413f01', '7f08142241',
    '7f40404040', '7f020c027f', '7f0408107f', '3e4141413e', '7f09090906',
    '3e4151215e', '7f09192946', '4649494931', '01017f0101', '3f4040403f',
    '1f2040201f', '3f4038403f', '6314081463', '0304780403', '6151494543',
    '7f4141', '0204081020', '41417f', '0402010204', '4040404040', '010204',
    '2054545478', '7f48444438', '3844444420', '384444487f', '3854545418',
    '087e0902', '0c5252523e', '7f08040478', '7d', '403d', '7f102844', '7f',
    '7c04180478', '7c08040478', '3844444438', '7c14141408', '081414187c',
    '7c080404', '4854545420', '043f4440', '3c4040207c', '1c2040201c',
    '3c4030403c', '4428102844', '0c5050503c', '4464544c44', '083641', '7f',
    '413608', '0804081008',
)
_FONT_ROWS = 7
_SPACE = 3


def _put_caption(img: np.ndarray, text: str, org, color) -> None:
    """Draw text with its baseline's left end at org = (x, y), in place,
    clipped to a uint8 image (cv2 5.0's putText refuses other depths); a
    character outside printable ASCII is drawn as '?'."""
    px = raster._pixel(img, color)
    h, w = img.shape[:2]
    x, base = int(org[0]), int(org[1])
    for ch in text:
        code = ord(ch) if 32 <= ord(ch) <= 126 else ord('?')
        cols = bytes.fromhex(_FONT[code - 32])
        for i, col in enumerate(cols):
            for r in range(_FONT_ROWS):
                y = base - _FONT_ROWS + r
                if col >> r & 1 and 0 <= x + i < w and 0 <= y < h:
                    img[y, x + i] = px
        x += (len(cols) + 1) if cols else _SPACE


def draw_muti_pic(batch_img_list, index: int, data_dir: str, name: str,
                  text=None, save: bool = True, max_col: int = 7,
                  batch_size=None) -> list:
    """Montage: one image per sample, tiling each renderer's output in
    rows of max_col (vis_tool.py:572-591; same name kept, typo and all).
    batch_img_list: list of [B,S,S,3] arrays. Returns the montages.

    text[bi], where given, is drawn at (15, 15) in (100, 200, 200) in the
    5x7 bitmap font of _put_caption, where the JAX function calls
    cv2.putText(FONT_HERSHEY_COMPLEX, 0.5, thickness 1), which cv2 5.0
    renders as anti-aliased TrueType: the caption's pixels differ from
    cv2's inside the box cv2.getTextSize gives (height above the
    baseline, baseline below it, 2 px around), and nowhere else. As
    cv2.putText, a caption needs uint8 tiles (TypeError otherwise)."""
    if batch_size is None:
        batch_size = np.asarray(batch_img_list[0]).shape[0]
    montages = []
    for bi in range(batch_size):
        rows, row = [], []
        for imgs in batch_img_list:
            row.append(np.asarray(imgs)[bi].squeeze())
            if len(row) == max_col:
                rows.append(np.hstack(row))
                row = []
        if row:
            # pad the last partial row to full width with black tiles
            if rows:
                tile = np.zeros_like(row[0])
                row += [tile] * (max_col - len(row))
            rows.append(np.hstack(row))
        montage = np.concatenate(rows, axis=0)
        if text is not None:
            montage = np.ascontiguousarray(montage)
            _put_caption(montage, text[bi], (15, 15), (100, 200, 200))
        if save:
            _write(os.path.join(
                data_dir, f'{name}_{batch_size * index + bi}.png'), montage)
        montages.append(montage)
    return montages


def debug_mesh(verts, faces, batch_index: int, data_dir: str,
               img_type: str) -> None:
    """Wavefront .obj dump of a batch of MANO meshes (vis_tool.py:145-155,
    1-indexed faces)."""
    verts = np.asarray(verts)
    faces = np.asarray(faces).astype(np.int64) + 1
    b = verts.shape[0]
    for bi in range(b):
        path = os.path.join(data_dir,
                            f'{b * batch_index + bi}_{img_type}.obj')
        with open(path, 'w') as fp:
            for v in verts[bi]:
                fp.write('v %f %f %f\n' % (v[0], v[1], v[2]))
            for f in faces:
                fp.write('f %d %d %d\n' % (f[0], f[1], f[2]))
