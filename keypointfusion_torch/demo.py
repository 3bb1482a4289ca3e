"""In-the-wild RGB-D single-frame inference (port of
keypointfusion_tpu/demo.py and of root demo_RGBD.py's CLI).

    model = ModelRGBD(cfg, cam_para=(fx, fy, fu, fv))
    meta_info_list, outputs_list = model.estimate_pose_rgbd(
        [{'rgb': bgr_img, 'depth': depth_mm, 'bbox': xywh,
          'hand_type': 'right'}])

A bbox gives the depth centre of mass inside it; the frame is cropped,
normalized and sampled to a point cloud on the host (data/
preprocessing.py, the JAX demo's numpy steps bit for bit), KPFusion runs
on the card (K2 once and K1 once per fusion block, at batch 1), and the
joints go back to the frame's pixels and to metres. The meta and output
dicts are the JAX demo's, with the skeleton overlays of utils/vis.py.

    python -m keypointfusion_torch.demo [--rgb R --depth D --bbox cx cy w h
        --out_dir O --load_model M.pth --fx --fy --fu --fv]

takes root demo_RGBD.py's flags and defaults, reads the images with
data/image_io.py, falls back to a synthetic frame when --rgb is missing,
and writes box_{cropRGB,cropD,poseRGB,poseD}.png with image_io.imwrite.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from keypointfusion_torch.config import Config
from keypointfusion_torch.data import preprocessing as pp
from keypointfusion_torch.data.image_io import imread, imwrite
from keypointfusion_torch.geometry.camera import (
    CropFrame, uvd_nl_to_xyz_nl, xyz_nl_to_uvd_nl,
)
from keypointfusion_torch.models.kpfusion import build_kpfusion
from keypointfusion_torch.ops.codecs import offset_to_joint_weight
from keypointfusion_torch.utils.device import resolve_device
from keypointfusion_torch.utils.vis import draw_2d_pose, draw_2d_pose_rgb
from keypointfusion_torch.utils.weights import (
    load_kpfusion_weights, load_torch_checkpoint,
)

MANO2HO3D = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
             20, 16, 17, 19, 18]


def get_center_from_bbox(depth: np.ndarray, bbox, upper=1500, lower=171
                         ) -> np.ndarray:
    """Masked-mean depth CoM inside the bbox (reference
    demo_RGBD.py:253-276, linspace and all)."""
    center = np.array([0.0, 0.0, 300.0])
    x0, y0 = int(bbox[0]), int(bbox[1])
    crop = depth[y0:int(bbox[1] + bbox[3]), x0:int(bbox[0] + bbox[2])]
    flag = np.logical_and(crop <= upper, crop >= lower)
    if flag.any():
        xv, yv = np.meshgrid(
            np.linspace(0, crop.shape[1], crop.shape[1]),
            np.linspace(0, crop.shape[0], crop.shape[0]))
        center[0] = np.mean(xv[flag]) + bbox[0]
        center[1] = np.mean(yv[flag]) + bbox[1]
        center[2] = np.mean(crop[flag])
        if center[2] <= 0:
            center[2] = 300.0
    return center


def smoke_frame():
    """The JAX demo's synthetic frame (keypointfusion_tpu/demo.py:_main):
    (input dict for estimate_pose_rgbd, camera). A 720x1280 frame, a
    120x120 patch of depth 400-600 mm at (560, 300) on an empty
    background, random BGR colour."""
    rng = np.random.RandomState(0)
    depth = np.zeros((720, 1280), np.float32)
    depth[300:420, 560:680] = rng.uniform(400, 600, (120, 120))
    rgb = rng.randint(0, 255, (720, 1280, 3)).astype(np.uint8)
    return ({'rgb': rgb, 'depth': depth, 'bbox': [560, 300, 120, 120],
             'hand_type': 'right'}, (906.96, 906.79, 956.75, 547.23))


class ModelRGBD:
    """KPFusion for single RGB-D frames. `state_dict` (the port's names,
    which are the reference's) or, without it, `cfg.load_model` (a
    released reference `.pth` or a checkpoint file of the port's trainer)
    gives the weights; with neither they are drawn from `seed`. The model
    computes in cfg.compute_dtype (float32 by default: K1 and K2 in their
    'highest' modes, as the JAX demo's Config(phase='test')) on the CUDA
    card unless `device` names another. The point cloud is sampled with
    np.random.RandomState(cfg.seed), drawn frame after frame as the JAX
    demo draws it."""

    def __init__(self, cfg: Config, cam_para: Tuple[float, float, float,
                                                    float],
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device=None, seed: int = 0):
        self.cfg = cfg
        self.cam_para = cam_para
        self.img_size = cfg.input_size
        self.cube = list(cfg.cube_size)
        self.sample_num = cfg.point_num
        self.device = resolve_device(device)
        self.model = build_kpfusion(cfg, device=self.device, seed=seed)
        if state_dict is None and cfg.load_model:
            state_dict = load_torch_checkpoint(cfg.load_model)
        if state_dict is not None:
            load_kpfusion_weights(self.model, state_dict)
        self.np_rng = np.random.RandomState(cfg.seed)

    def process_depth(self, cube_size, depth, center_uvd):
        """Crop + normalize + sample the point cloud (reference
        demo_RGBD.py:305-343)."""
        depth_crop, M = pp.crop_area_3d(depth.astype(np.float32),
                                        center_uvd, cube_size,
                                        (self.img_size, self.img_size),
                                        self.cam_para)
        imgD = pp.normalize_img(depth_crop.max(), depth_crop, center_uvd,
                                cube_size)
        com3d = pp.joint_img_to_3d(center_uvd, self.cam_para)
        pcl = pp.get_pcl(imgD.copy(), com3d, np.asarray(cube_size), M,
                         self.cam_para)
        pcl = np.clip(pp.sample_pcl(pcl, self.sample_num, self.np_rng),
                      -1, 1)
        return imgD, pcl, com3d, M, np.asarray(cube_size, np.float32)

    @torch.inference_mode()
    def _joints(self, rgb_in, depth_in, pcl_in, frame: CropFrame):
        """The normalized uvd and xyz joints of every stage, [J, 3] each
        on the host."""
        t = lambda a: torch.from_numpy(a).to(self.device)
        depth = t(depth_in)
        results, _ = self.model(t(rgb_in), depth, t(pcl_in), frame,
                                self.cfg.feature_para[0])
        uvd_list, xyz_list = [], []
        for index, stage in enumerate(self.cfg.stage_type):
            if stage == 1:
                uvd = offset_to_joint_weight(results[index].float(), depth,
                                             self.cfg.feature_para[0])
                xyz = uvd_nl_to_xyz_nl(uvd, frame)
            else:
                xyz = results[index].float()
                uvd = xyz_nl_to_uvd_nl(xyz, frame)
            uvd_list.append(uvd[0].cpu().numpy())
            xyz_list.append(xyz[0].cpu().numpy())
        return uvd_list, xyz_list

    def estimate_pose_rgbd(self, inputs: Sequence[Dict]
                           ) -> Tuple[List[Dict], List[Dict]]:
        meta_info_list, outputs_list = [], []
        for inp in inputs:
            rgb_full, depth_full = inp['rgb'], inp['depth']
            bbox = inp['bbox']
            center_uvd = get_center_from_bbox(depth_full, bbox)

            crop_rgb, _ = pp.crop_area_3d(
                rgb_full.astype(np.float32), center_uvd, self.cube,
                (self.img_size, self.img_size), self.cam_para,
                thresh_z=False)
            imgD, pcl, com3d, M, cube = self.process_depth(
                self.cube, depth_full.astype(np.float32), center_uvd)

            rgb_in = (crop_rgb / 255.0)[None].astype(np.float32)
            depth_in = imgD[None, ..., None].astype(np.float32)
            frame = CropFrame.from_batch(
                np.asarray(self.cam_para, np.float32)[None],
                com3d[None].astype(np.float32), M[None].astype(np.float32),
                cube[None], img_size=self.img_size, device=self.device)
            joint_uvd_list, joint_xyz_list = self._joints(
                rgb_in, depth_in, pcl[None], frame)

            joint_xyz_world = (joint_xyz_list[-1] * cube / 2 + com3d)
            joint_xyz_world = joint_xyz_world[MANO2HO3D] \
                * np.array([1, -1, -1]) / 1000

            # index 2 = first KFAM 3D stage, as in demo_RGBD.py:144
            joint_uvd = joint_uvd_list[2].copy()
            pose_d = draw_2d_pose(depth_in[0], joint_uvd, 'dexycb')
            pose_rgb = draw_2d_pose_rgb(rgb_in[0], joint_uvd, 'dexycb')

            joint_uvd[:, :2] = (joint_uvd[:, :2] + 1) / 2 * self.img_size
            joint_uvd[:, 2] = joint_uvd[:, 2] * cube[0] / 2 + com3d[2]
            coord_uvd_full = pp.transform_points_2d(joint_uvd,
                                                    np.linalg.inv(M))

            meta_info_list.append({
                'crop_img': (rgb_in[0] * 255).astype(np.uint8),
                'crop_img_d': ((depth_in[0, ..., 0] + 1) / 2 * 255).astype(
                    np.uint8),
                'img2bb_trans': M,
                'bb2img_trans': np.linalg.inv(M),
                'center': com3d,
                'pose_rgb': pose_rgb,
                'pose_d': pose_d,
            })
            outputs_list.append({
                'mesh_uvd': None,
                'mesh_xyz': None,
                'joint_uvd': coord_uvd_full,
                'joint_xyz': joint_xyz_world,
            })
        return meta_info_list, outputs_list


OUTPUT_FILES = {'crop_img': 'box_cropRGB.png', 'crop_img_d': 'box_cropD.png',
                'pose_rgb': 'box_poseRGB.png', 'pose_d': 'box_poseD.png'}


def build_parser() -> argparse.ArgumentParser:
    """Root demo_RGBD.py's flags and defaults."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--rgb', default='./visualization/box.png')
    parser.add_argument('--depth', default='./visualization/box_d.png')
    parser.add_argument('--bbox', nargs=4, type=float,
                        default=[885, 515.5, 178.0, 127.0],
                        help='cx cy w h (center-style, like the reference)')
    parser.add_argument('--out_dir', default='./visualization')
    parser.add_argument('--load_model', default='')
    parser.add_argument('--fx', type=float, default=906.96)
    parser.add_argument('--fy', type=float, default=906.79)
    parser.add_argument('--fu', type=float, default=956.75)
    parser.add_argument('--fv', type=float, default=547.23)
    return parser


def main(argv: Optional[Sequence[str]] = None, device=None):
    """The demo CLI (root demo_RGBD.py): one frame, four PNGs in
    --out_dir. Returns (meta_info_list, outputs_list)."""
    args = build_parser().parse_args(argv)
    bbox = list(args.bbox)
    bbox[0] -= bbox[2] / 2
    bbox[1] -= bbox[3] / 2

    if os.path.exists(args.rgb):
        rgb = imread(args.rgb)
        depth = imread(args.depth, anydepth=True)
        if rgb is None or depth is None:
            raise ValueError(f'cannot read {args.rgb} or {args.depth}')
        depth = depth.astype(np.float32)
    else:
        print(f'{args.rgb} not found — running on a synthetic frame')
        rng = np.random.RandomState(0)
        depth = np.zeros((1080, 1920), np.float32)
        y, x = int(bbox[1]), int(bbox[0])
        depth[y:y + int(bbox[3]), x:x + int(bbox[2])] = rng.uniform(
            400, 600, (int(bbox[3]), int(bbox[2])))
        rgb = rng.randint(0, 255, (1080, 1920, 3)).astype(np.uint8)

    cfg = Config(phase='test', load_model=args.load_model)
    model = ModelRGBD(cfg, cam_para=(args.fx, args.fy, args.fu, args.fv),
                      device=device)
    meta, result = model.estimate_pose_rgbd(
        [{'rgb': rgb, 'depth': depth, 'bbox': bbox, 'hand_type': 'right'}])

    os.makedirs(args.out_dir, exist_ok=True)
    for key, name in OUTPUT_FILES.items():
        imwrite(os.path.join(args.out_dir, name), meta[0][key])
    print('joint_xyz (m):', result[0]['joint_xyz'][:3], '...')
    print(f'overlays written to {args.out_dir}/')
    return meta, result


if __name__ == '__main__':
    main()
