"""The calls behind tests/fixtures/torch_port_vis/vis_debug.npz: every
debug renderer of utils/vis.py on inputs made with numpy from a seed.
numpy and the standard library only, so that
scripts/make_torch_port_vis_fixture.py runs them through the JAX package
(cv2 5.0) and chip_smoke.py's [vis_debug] phase and the tests through the
port, on the same inputs, and compare bit for bit.

The inputs are those of a KPFusion batch: 4 depth crops of 128 x 128 in
[-1, 1], 21 joints (some outside the crop), 32 x 32 heatmaps, a 32 x 32
dense map of 5J = 105 channels (joint-major offsets, heatmaps, weights;
zero outside each joint's kernel, as ops/codecs.py encodes them),
1024-point clouds, a 778-vertex mesh with 1538 faces; and a 3-image
montage without a caption.
"""

import hashlib
import os

import numpy as np

FIXTURE = 'tests/fixtures/torch_port_vis/vis_debug.npz'
BATCH, SIZE, JOINTS, MAP, POINTS = 4, 128, 21, 32, 1024
VERTS, FACES = 778, 1538
KERNEL = 0.4          # the dense map's kernel, in normalized units


def case_inputs() -> dict:
    """The inputs, numpy arrays, from RandomState(0)."""
    rng = np.random.RandomState(0)
    b, j = BATCH, JOINTS
    # depth on a 1/512 grid (the fixture compresses), a nearer hand blob
    yy, xx = np.mgrid[:SIZE, :SIZE] / (SIZE / 2.0) - 1.0
    depth = np.empty((b, SIZE, SIZE, 1), np.float32)
    for i in range(b):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        blob = (xx - cx) ** 2 + (yy - cy) ** 2 < rng.uniform(0.2, 0.4)
        d = np.where(blob, rng.uniform(-0.6, 0.2, (SIZE, SIZE)),
                     rng.uniform(0.9, 1.0, (SIZE, SIZE)))
        depth[i, ..., 0] = np.round(d * 512) / 512
    joints = rng.uniform(-0.9, 0.9, (b, j, 3)).astype(np.float32)
    joints[0, 20] = (1.3, -0.2, 0.1)             # outside the crop
    joints[1, 5] = (-1.0, 1.0, 0.0)              # on its edges
    grid = (np.arange(MAP) + 0.5) / (MAP / 2.0) - 1.0
    u, v = np.meshgrid(grid, grid)                 # [MAP, MAP]
    dx = joints[:, None, None, :, 0] - u[None, :, :, None]
    dy = joints[:, None, None, :, 1] - v[None, :, :, None]
    dist = np.sqrt(dx ** 2 + dy ** 2)              # [B, MAP, MAP, J]
    inside = dist < KERNEL
    heat = np.where(inside, 1 - dist / KERNEL, 0.0)
    offset = np.zeros((b, MAP, MAP, 5 * j), np.float32)
    offset[..., 0:3 * j:3] = np.where(inside, dx / KERNEL, 0)
    offset[..., 1:3 * j:3] = np.where(inside, dy / KERNEL, 0)
    offset[..., 2:3 * j:3] = np.where(
        inside, rng.uniform(-0.5, 0.5, dist.shape), 0)
    offset[..., 3 * j:4 * j] = heat
    offset[..., 4 * j:] = np.where(inside, rng.uniform(0, 1, dist.shape), 0)
    heatmap = np.where(inside, np.exp(-dist ** 2 / 0.02), 0).transpose(
        0, 3, 1, 2).astype(np.float32)             # [B, J, MAP, MAP]
    return {'depth': depth, 'joints': joints,
            'visible': rng.randint(0, 2, (b, j)).astype(np.int64),
            'heatmap': heatmap, 'offset': offset,
            'pcl': rng.uniform(-1.1, 1.1, (b, POINTS, 3)).astype(np.float32),
            'verts': (rng.randn(b, VERTS, 3) * 0.1).astype(np.float32),
            'faces': rng.randint(0, VERTS, (FACES, 3)).astype(np.int32),
            'select_id': np.array([7, 3, 9, 1], np.int64)}


def read_file(path, imread):
    """A written file's content: a PNG through `imread`, an .obj's bytes."""
    if path.endswith('.png'):
        return imread(path)
    with open(path, 'rb') as f:
        return np.frombuffer(f.read(), np.uint8)


def case_outputs(vis, imread, workdir, inp) -> dict:
    """Every renderer of `vis` (the JAX package's utils/vis.py or the
    port's) on the inputs `inp` (case_inputs()): the returned arrays under
    their names, and each file written into `workdir` (empty) as `imread`
    reads it back (PNG) or as bytes (.obj), under 'file:<name>'."""
    depth, joints, hm = inp['depth'], inp['joints'], inp['heatmap']
    off, pcl = inp['offset'], inp['pcl']
    out = {}
    for i in range(BATCH):
        out[f'draw_heatmap_{i}'] = vis.draw_heatmap(
            depth[i], hm[i, 5 * i], alpha=(0.5, 0.3, 0.75, 0.5)[i])
        out[f'draw_offset_field_{i}'] = vis.draw_offset_field(
            depth[i], off[i], joint_id=5 * i, stride=(4, 2, 4, 1)[i])
        out[f'draw_pcl_{i}'] = vis.draw_pcl(pcl[i], (256, 128, 64, 200)[i])
    # the heatmap at the crop's size: no resize
    out['draw_heatmap_full'] = vis.draw_heatmap(
        depth[0], np.kron(hm[0, 0], np.ones((4, 4), np.float32)))
    out['draw_pcl_batch'] = vis.draw_pcl_batch(pcl, SIZE)
    out['draw_pcl_batch_bg'] = vis.draw_pcl_batch(pcl, 50, -0.5)
    two = np.concatenate([depth, depth * 0.5], -1)
    out['debug_2d_img'] = vis.debug_2d_img(two, 1, workdir, 'img')
    out['debug_2d_pose'] = vis.debug_2d_pose(depth, joints, 0, 'dexycb',
                                             workdir, 'pose', save=True)
    vis.debug_2d_pose_select(depth, joints, 2, 'dexycb', workdir, 'worst',
                             inp['select_id'], save=True)
    out['debug_img_heatmap'] = vis.debug_img_heatmap(
        depth, hm, 0, workdir, SIZE, 'heatmap', save=True)
    out['debug_2d_heatmap'] = vis.debug_2d_heatmap(hm, 1, workdir, 64,
                                                   'raw', save=True)
    out['debug_2d_heatmap_empty'] = np.asarray(vis.debug_2d_heatmap(
        hm[:0], 0, workdir, 64))
    vis.debug_visible_joint(depth, joints, inp['visible'], 0, 'dexycb',
                            workdir, 'visible')
    vis.debug_pcl_pose(pcl, joints, 0, 'dexycb', workdir, 'pcl')
    montage = [out['debug_2d_pose'],
               np.stack([out[f'draw_heatmap_{i}'] for i in range(BATCH)]),
               np.stack([out[f'draw_offset_field_{i}']
                         for i in range(BATCH)])]
    for i, m in enumerate(vis.draw_muti_pic(montage, 0, workdir, 'montage',
                                            max_col=2)):
        out[f'draw_muti_pic_{i}'] = m
    vis.debug_mesh(inp['verts'], inp['faces'], 0, workdir, 'mesh')
    for name in sorted(os.listdir(workdir)):
        out[f'file:{name}'] = read_file(os.path.join(workdir, name), imread)
    return out


def digest(a: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f'{a.dtype.str}{a.shape}'.encode())
    h.update(a.tobytes())
    return h.hexdigest()


def differing(outputs: dict, stored) -> list:
    """The keys whose digest differs from the fixture's ('out:<key>'),
    and the keys on one side only."""
    want = {k[4:]: str(stored[k]) for k in stored.files
            if k.startswith('out:')}
    keys = sorted(set(want) | set(outputs))
    return [k for k in keys
            if k not in want or k not in outputs
            or digest(outputs[k]) != want[k]]
