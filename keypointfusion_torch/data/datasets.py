"""Dataset loaders: DexYCB, HO3D (v2/v3), NYU, STB (port of
keypointfusion_tpu/data/datasets.py).

The four reference dataset classes on one shared sample builder
(build_rgbd_sample: crop, augment, normalize, point cloud). COCO-format
json indexes are parsed with plain `json`. Images are read by
data/image_io.py (cv2.imread's results without cv2) and the STB
extrinsics' rotation by data/cv_ops.py:rodrigues; the rest is the JAX
module's numpy, so a dataset built with the same seed draws the same
augmentations and gives the same samples. Every dataset holds one
random.Random and one np.random.RandomState, seeded alike and drawn in
the JAX module's order. The eval samples take the JAX module's default
route, its fused C++ eval core, here data/native.py: the depth crop,
normalization and point cloud in two native passes, bit for bit with the
JAX core (which is not bit for bit with the numpy route: 4.2e-7 in
normalized units). `use_native = False` on a dataset takes the numpy
route instead, the JAX route where its core is not built.

Every sample is a dict of float32 numpy arrays (images NHWC):
  rgb [S,S,3], depth [S,S,1], pcl [N,3], xyz_gt [J,3], uvd_gt [J,3],
  center [3], M [3,3], cube [3], cam_para [4]
— the unbatched analogue of the reference 9-tuple (loader.py:1204).
"""

from __future__ import annotations

import json
import os.path as osp
import random as _random
from typing import Dict, List

import numpy as np

from keypointfusion_torch.data import cv_ops, native
from keypointfusion_torch.data import preprocessing as pp
from keypointfusion_torch.data.image_io import imread

# joint reorderings to MANO convention (reference loader.py:24-57)
DexYCB2MANO = [0, 5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3,
               8, 12, 20, 16, 4]
HO3D2MANO = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
             17, 18, 20, 19, 16]
MANO2HO3D = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
             20, 16, 17, 19, 18]
NYU_JOINT_SELECT = np.array([0, 1, 3, 5, 6, 7, 9, 11, 12, 13, 15, 17,
                             18, 19, 21, 23, 24, 25, 27, 28, 32, 30, 31])


def load_coco_index(path: str) -> List[dict]:
    """Minimal COCO-json join of annotations with their images
    (replaces pycocotools, reference loader.py:1045-1052)."""
    with open(path) as f:
        db = json.load(f)
    images = {img['id']: img for img in db['images']}
    return [dict(ann, image=images[ann['image_id']])
            for ann in db['annotations']]


def _read(path: str, anydepth: bool = False) -> np.ndarray:
    """imread that raises IOError where the JAX module's cv2.imread(...)
    would have given None and failed on it (`.astype` of None)."""
    img = imread(path, anydepth)
    if img is None:
        raise IOError(f'Fail to read {path}')
    return img


def build_rgbd_sample(depth, rgb, joint_xyz_mm, center_xyz, cam_para,
                      cube_size, train: bool, aug_para, py_rng, np_rng,
                      img_size=128, sample_num=1024, color_factor=0.0,
                      clamp_pcl=False, flip=1.0,
                      use_native: bool = True) -> Dict[str, np.ndarray]:
    """The shared crop→augment→normalize→pcl pipeline every dataset runs
    per sample (reference loader.py:1129-1204 and clones). An eval sample
    (no augmentation, flip 1) takes the native core (data/native.py)
    unless use_native is False, as the JAX module's does."""
    center_uvd = pp.joint_3d_to_img(center_xyz, cam_para, flip)
    gt3Dcrop = joint_xyz_mm - center_xyz

    if not train and use_native and flip == 1.0:
        return _build_eval_sample_native(
            depth, rgb, gt3Dcrop, center_xyz, center_uvd, cam_para,
            cube_size, img_size, sample_num, clamp_pcl, np_rng)

    depth_crop, trans = pp.crop_area_3d(
        depth, center_uvd, cube_size, (img_size, img_size), cam_para)
    rgb_crop, trans_rgb = pp.crop_area_3d(
        rgb.astype(np.float32), center_uvd, cube_size, (img_size, img_size),
        cam_para, thresh_z=False)

    if train:
        mode, off, rot, sc = pp.rand_augment(
            py_rng, sigma_com=aug_para[0], sigma_sc=aug_para[1],
            rot_range=aug_para[2])
        imgD, cur_label, cube, com2d, M, _ = _aug(depth_crop, gt3Dcrop,
                                                  center_uvd, cube_size,
                                                  trans, mode, off, rot, sc,
                                                  cam_para, flip, rgb=False)
        imgRGB, _, _, _, _, _ = _aug(rgb_crop, gt3Dcrop, center_uvd,
                                     cube_size, trans_rgb, mode, off, rot,
                                     sc, cam_para, flip, rgb=True)
        if color_factor:
            scale = np.array([py_rng.uniform(1 - color_factor,
                                             1 + color_factor)
                              for _ in range(3)])
            imgRGB = np.clip(imgRGB * scale[None, None, :], 0, 255)
        cur_label = cur_label / (cube[2] / 2.0)
    else:
        imgD = pp.normalize_img(depth_crop.max(), depth_crop, center_xyz,
                                cube_size)
        imgRGB = rgb_crop
        cur_label = gt3Dcrop / (cube_size[2] / 2.0)
        cube = np.asarray(cube_size, np.float64)
        com2d = center_uvd
        M = trans

    com3d = pp.joint_img_to_3d(com2d, cam_para, flip)
    joint_img = pp.transform_points_2d(
        pp.joint_3d_to_img(cur_label * (cube[0] / 2.0) + com3d, cam_para,
                           flip), M)
    joint_img[:, :2] = joint_img[:, :2] / (img_size / 2) - 1
    joint_img[:, 2] = (joint_img[:, 2] - com3d[2]) / (cube[0] / 2.0)

    pcl = pp.get_pcl(imgD.copy(), com3d, np.asarray(cube), M, cam_para, flip)
    pcl_sample = pp.sample_pcl(pcl, sample_num, np_rng)
    if clamp_pcl:  # HO3D clamps (loader.py:1399)
        pcl_sample = np.clip(pcl_sample, -1, 1)

    return {
        'rgb': (imgRGB / 255.0).astype(np.float32),
        'depth': imgD.astype(np.float32)[..., None],
        'pcl': pcl_sample.astype(np.float32),
        'xyz_gt': cur_label.astype(np.float32),
        'uvd_gt': joint_img.astype(np.float32),
        'center': com3d.astype(np.float32),
        'M': np.asarray(M, np.float32),
        'cube': np.asarray(cube, np.float32),
        'cam_para': np.asarray(cam_para, np.float32),
    }


def _build_eval_sample_native(depth, rgb, gt3Dcrop, center_xyz, center_uvd,
                              cam_para, cube_size, img_size, sample_num,
                              clamp_pcl, np_rng) -> Dict[str, np.ndarray]:
    """An eval sample through the native core (the JAX module's
    _build_eval_sample_native): the depth crop and the point cloud
    native, the colour crop and the labels in numpy."""
    cam = np.asarray(cam_para, np.float32)
    cube = np.asarray(cube_size, np.float32)
    imgD, M = native.crop_normalize(depth.astype(np.float32),
                                    np.asarray(center_uvd, np.float32),
                                    cube, cam, img_size)
    rgb_crop, _ = pp.crop_area_3d(rgb.astype(np.float32), center_uvd,
                                  cube_size, (img_size, img_size), cam_para,
                                  thresh_z=False)
    com3d = pp.joint_img_to_3d(center_uvd, cam_para)
    cur_label = gt3Dcrop / (cube[2] / 2.0)
    joint_img = pp.transform_points_2d(
        pp.joint_3d_to_img(cur_label * (cube[0] / 2.0) + com3d, cam_para),
        M)
    joint_img[:, :2] = joint_img[:, :2] / (img_size / 2) - 1
    joint_img[:, 2] = (joint_img[:, 2] - com3d[2]) / (cube[0] / 2.0)

    pcl = native.depth_to_pcl(imgD, M, cam, com3d.astype(np.float32), cube)
    pcl_sample = pp.sample_pcl(pcl, sample_num, np_rng)
    if clamp_pcl:
        pcl_sample = np.clip(pcl_sample, -1, 1)
    return {
        'rgb': (rgb_crop / 255.0).astype(np.float32),
        'depth': imgD.astype(np.float32)[..., None],
        'pcl': pcl_sample.astype(np.float32),
        'xyz_gt': cur_label.astype(np.float32),
        'uvd_gt': joint_img.astype(np.float32),
        'center': com3d.astype(np.float32),
        'M': np.asarray(M, np.float32),
        'cube': cube,
        'cam_para': cam,
    }


def _aug(img, gt3Dcrop, com, cube, M, mode, off, rot, sc, paras, flip, rgb):
    out, new_joints, cube_out, com_out, M_out, rot_out = pp.augment_crop(
        img, gt3Dcrop, com, cube, M, mode, off, rot, sc, paras, flip=flip,
        rgb=rgb)
    return out, new_joints, cube_out, com_out, M_out, rot_out


class _Base:
    """Common plumbing: deterministic per-worker RNGs, len/getitem.
    use_native: the eval samples' route (True: the native core)."""
    use_native = True

    def __init__(self, seed: int = 23455):
        self.py_rng = _random.Random(seed)
        self.np_rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.datalist)


class DexYCBDataset(_Base):
    """DexYCB s0/s1/s2/s3 (reference loader.py:1023-1204). Left hands are
    mirrored to right (image + u flip)."""
    cube = [250., 250., 250.]
    flip = 1.0

    def __init__(self, setup: str, split: str, root_dir: str,
                 img_size: int = 128, aug_para=(10, 0.2, 180),
                 sample_num: int = 1024, seed: int = 23455):
        super().__init__(seed)
        self.setup, self.split = setup, split
        self.root_dir = osp.join(root_dir, 'DexYCB')
        self.img_size, self.aug_para = img_size, tuple(aug_para)
        self.sample_num = sample_num
        ann_file = osp.join(self.root_dir, 'annotations',
                            f'DEX_YCB_{setup}_{split}_data.json')
        self.datalist = []
        for ann in load_coco_index(ann_file):
            joints = np.array(ann['joints_coord_cam'],
                              np.float32).reshape(21, 3)
            if joints.sum() == -63:      # invalid frame marker
                continue
            self.datalist.append({
                'img_path': osp.join(self.root_dir,
                                     ann['image']['color_file_name']),
                'img_shape': (ann['image']['height'],
                              ann['image']['width']),
                'joints_coord_cam': joints / 1000.0,   # meters
                'cam_param': ann['cam_param'],
                'hand_type': ann['hand_type'],
                'mano_pose': np.array(ann['mano_param']['pose'], np.float32),
                'mano_shape': np.array(ann['mano_param']['shape'],
                                       np.float32),
            })

    def __getitem__(self, idx):
        d = self.datalist[idx]
        rgb = imread(d['img_path'])
        if rgb is None:
            raise IOError(f"Fail to read {d['img_path']}")
        depth_path = d['img_path'].replace(
            'color_', 'aligned_depth_to_color_').replace('jpg', 'png')
        depth = _read(depth_path, anydepth=True).astype(np.float32)

        cam = d['cam_param']
        cam_para = (cam['focal'][0], cam['focal'][1],
                    cam['princpt'][0], cam['princpt'][1])
        joint_xyz = d['joints_coord_cam'][DexYCB2MANO, :] * 1000
        joint_uvd = pp.joint_3d_to_img(joint_xyz, cam_para)

        if d['hand_type'] == 'left':
            rgb = rgb[:, ::-1].copy()
            depth = depth[:, ::-1].copy()
            joint_uvd[:, 0] = d['img_shape'][1] - joint_uvd[:, 0] - 1
        joint_xyz = pp.joint_img_to_3d(joint_uvd, cam_para)
        center_xyz = joint_xyz.mean(0)

        return build_rgbd_sample(
            depth, rgb, joint_xyz, center_xyz, cam_para, self.cube,
            self.split == 'train', self.aug_para, self.py_rng, self.np_rng,
            self.img_size, self.sample_num, use_native=self.use_native)


class HO3D(_Base):
    """HO3D v2/v3 (reference loader.py:1207-1500)."""
    flip = 1.0

    def __init__(self, split: str, root_dir: str, version: str = 'v2',
                 img_size: int = 128, center_type: str = 'refine',
                 aug_para=(10, 0.2, 180), cube=(280, 280, 280),
                 color_factor: float = 0.2, sample_num: int = 1024,
                 seed: int = 23455):
        super().__init__(seed)
        self.split = split
        self.version = version
        self.root_dir = osp.join(root_dir, f'HO3D_{version}')
        self.img_size, self.aug_para = img_size, tuple(aug_para)
        self.cube = list(cube)
        self.color_factor = color_factor
        self.sample_num = sample_num
        self.center_type = center_type
        if center_type == 'refine':
            self.center_xyz = np.loadtxt(osp.join(
                self.root_dir, 'annotations',
                f'{split}_refine_center_xyz.txt'))
        ann_file = osp.join(self.root_dir, 'annotations',
                            f'HO3D_{split}_data.json')
        self.datalist = []
        for ann in load_coco_index(ann_file):
            entry = {
                'img_path': osp.join(self.root_dir,
                                     ann['image']['file_name']),
                'img_shape': (ann['image']['height'],
                              ann['image']['width']),
                'cam_param': ann['cam_param'],
            }
            if split in ('train', 'test', 'train_all'):
                joints = np.array(ann['joints_coord_cam'],
                                  np.float32).reshape(21, 3)
                entry['joints_coord_cam'] = joints
                uv = pp.joint_3d_to_img(
                    joints * 1000,
                    (ann['cam_param']['focal'][0],
                     ann['cam_param']['focal'][1],
                     ann['cam_param']['princpt'][0],
                     ann['cam_param']['princpt'][1]))
                bbox = self._bbox_from_joints(uv[:, :2], 1.5)
                if self._process_bbox(bbox, entry['img_shape'][1],
                                      entry['img_shape'][0]) is None:
                    continue
            else:
                entry['root_joint_cam'] = np.array(ann['root_joint_cam'],
                                                   np.float32)
            self.datalist.append(entry)

    @staticmethod
    def _bbox_from_joints(uv, expansion=1.0):
        mn, mx = uv.min(0), uv.max(0)
        c = (mn + mx) / 2.
        wh = (mx - mn) * expansion
        return np.array([c[0] - wh[0] / 2, c[1] - wh[1] / 2, wh[0], wh[1]],
                        np.float32)

    @staticmethod
    def _process_bbox(bbox, img_w, img_h, expansion=1.0):
        x, y, w, h = bbox
        x1, y1 = max(0, x), max(0, y)
        x2 = min(img_w - 1, x1 + max(0, w - 1))
        y2 = min(img_h - 1, y1 + max(0, h - 1))
        if w * h > 0 and x2 >= x1 and y2 >= y1:
            return np.array([x1, y1, x2 - x1, y2 - y1])
        return None

    @staticmethod
    def read_depth_img(path):
        """HO3D 2-channel depth decode (loader.py:1482-1488)."""
        depth_scale = 0.00012498664727900177
        img = _read(path).astype(np.int32)
        return ((img[:, :, 2] + img[:, :, 1] * 256)
                * depth_scale * 1000).astype(np.float32)

    def __getitem__(self, idx):
        d = self.datalist[idx]
        if self.version == 'v2':
            rgb = imread(d['img_path'])
        else:
            rgb = imread(d['img_path'].replace('png', 'jpg'))
        if rgb is None:
            raise IOError(f"Fail to read {d['img_path']}")
        depth = self.read_depth_img(d['img_path'].replace('rgb', 'depth'))

        cam = d['cam_param']
        cam_para = (cam['focal'][0], cam['focal'][1],
                    cam['princpt'][0], cam['princpt'][1])
        if 'joints_coord_cam' in d:
            joint_xyz = d['joints_coord_cam'][HO3D2MANO, :] * 1000
        else:   # eval split without labels (loader.py:1308-1316)
            joint_xyz = np.ones([21, 3], np.float32)
        if self.center_type == 'refine':
            center_xyz = np.asarray(self.center_xyz[idx], np.float64)
        else:
            center_xyz = joint_xyz.mean(0)

        return build_rgbd_sample(
            depth, rgb, joint_xyz, center_xyz, cam_para, self.cube,
            'train' in self.split, self.aug_para, self.py_rng, self.np_rng,
            self.img_size, self.sample_num, color_factor=self.color_factor
            if 'train' in self.split else 0.0, clamp_pcl=True,
            use_native=self.use_native)


class NYUDataset(_Base):
    """NYU hand dataset (reference loader.py:1503-1638): .mat labels, the
    23-joint selection, refined centers, per-joint decode kernels, and the
    5/6 test-cube shrink for samples >= 2440."""
    paras = (588.03, 587.07, 320., 240.)
    flip = 1.0
    joint_kernel = (np.array([0.15, 0.15, 0.15, 0.25] * 4
                             + [0.25, 0.25, 0.25, 0.35, 0.4, 0.4, 0.4])
                    * 1.1)

    def __init__(self, root_dir: str, split: str, img_size: int = 128,
                 aug_para=(10, 0.1, 180), cube=(250, 250, 250),
                 center_type: str = 'refine', sample_num: int = 1024,
                 seed: int = 23455):
        super().__init__(seed)
        import scipy.io as sio
        self.split = split
        self.img_size, self.aug_para = img_size, tuple(aug_para)
        self.cube = np.array(cube, np.float64)
        self.sample_num = sample_num
        self.data_path = f'{root_dir}/{split}'
        labels = sio.loadmat(f'{self.data_path}/joint_data.mat')
        uvd = labels['joint_uvd'][0][:, NYU_JOINT_SELECT, :]
        xyz = labels['joint_xyz'][0][:, NYU_JOINT_SELECT, :]
        # stored labels use the y-flipped convention; convert to flip=+1
        # (loader.py:1527)
        self.all_joints_xyz = pp.joint_img_to_3d(
            pp.joint_3d_to_img(xyz, self.paras, flip=-1), self.paras)
        if center_type == 'refine':
            c = np.loadtxt(f'{self.data_path}/center_{split}_refined.txt')
            self.center_xyz = pp.joint_img_to_3d(
                pp.joint_3d_to_img(c, self.paras, flip=-1), self.paras)
        else:
            self.center_xyz = self.all_joints_xyz.mean(1)
        n = len(self.all_joints_xyz)
        self.test_cube = np.ones([n, 3]) * self.cube
        if split == 'test' and n >= 2440:
            self.test_cube[2440:] *= 5.0 / 6.0
        self.datalist = list(range(n))

    @staticmethod
    def read_depth(path):
        img = _read(path).astype(np.int32)
        return np.asarray(img[:, :, 0] + img[:, :, 1] * 256, np.float32)

    def read_model_para(self, data_rt: str, view: int = 0) -> np.ndarray:
        """Optional fitted-MANO parameter files (reference
        loader.py:1007-1020): concat [quat(3), theta(45), shape(10),
        scale(1), trans(3)] per sample."""
        base = f'{data_rt}/posePara_lm_collosion/nyu-{self.split}-{view}'
        theta = np.loadtxt(f'{base}-pose.txt').reshape(-1, 45)
        quat = np.loadtxt(f'{base}-glb.txt').reshape(-1, 3)
        scale = np.loadtxt(f'{base}-scale.txt').reshape(-1, 1)
        trans = np.loadtxt(f'{base}-trans.txt').reshape(-1, 3)
        shape = np.loadtxt(f'{base}-shape.txt').reshape(-1, 10)
        return np.concatenate([quat, theta, shape, scale, trans], axis=-1)

    def __getitem__(self, idx):
        path = f'{self.data_path}/depth_1_{idx + 1:07d}.png'
        depth = self.read_depth(path)
        rgb = imread(path.replace('depth', 'rgb'))
        if rgb is None:
            rgb = np.zeros((480, 640, 3), np.uint8)
        cube = self.test_cube[idx] if self.split == 'test' else self.cube
        return build_rgbd_sample(
            depth, rgb, self.all_joints_xyz[idx].copy(),
            self.center_xyz[idx], self.paras, cube,
            self.split == 'train', self.aug_para, self.py_rng, self.np_rng,
            self.img_size, self.sample_num, use_native=self.use_native)


class STBDataset(_Base):
    """STB stereo benchmark (reference dataset_STB.py:21-179): fixed SK
    intrinsics + extrinsics, keypoint reorder, wrist extrapolation."""
    cube = [200., 200., 200.]
    flip = 1.0
    R = np.array([0.00531, -0.01196, 0.00301])
    T = np.array([-24.0381, -0.4563, -1.2326])
    cam_para = (607.92271, 607.88192, 314.78337, 236.42484)
    # palm-first STB order → MANO-ish order (preprocess.py:201-211)
    KP_ORDER = [0] + list(range(20, 0, -1))

    def __init__(self, split: str, root_dir: str, img_size: int = 128,
                 aug_para=(10, 0.2, 180), color_factor: float = 0.2,
                 sample_num: int = 1024, seed: int = 23455):
        super().__init__(seed)
        import scipy.io as sio
        self.split = split
        self.root = osp.join(root_dir, 'STB')
        self.img_size, self.aug_para = img_size, tuple(aug_para)
        self.color_factor = color_factor
        self.sample_num = sample_num
        seqs = (['B2Counting', 'B2Random', 'B3Counting', 'B3Random',
                 'B4Counting', 'B4Random', 'B5Counting', 'B5Random',
                 'B6Counting', 'B6Random'] if split == 'train'
                else ['B1Counting'])
        self.datalist = []
        for seq in seqs:
            mat = sio.loadmat(f'{self.root}/labels/{seq}_SK.mat')
            for i in range(1500):
                self.datalist.append({
                    'rgb': f'{self.root}/{seq}/SK_color_{i}.png',
                    'depth': f'{self.root}/{seq}/SK_depth_{i}.png',
                    'xyz': mat['handPara'][:, :, i],
                })

    @staticmethod
    def read_depth(path):
        img = _read(path).astype(np.int32)
        return ((img[:, :, 2] + img[:, :, 1] * 256)
                * 0.001 * 1000).astype(np.float32)

    def __getitem__(self, idx):
        d = self.datalist[idx]
        rgb = _read(d['rgb'])
        depth = self.read_depth(d['depth'])
        fx, fy, tx, ty = self.cam_para
        K = np.array([[fx, 0, tx], [0, fy, ty], [0, 0, 1.]])
        rot = cv_ops.rodrigues(self.R)
        xyz = d['xyz'].T                              # [21,3]
        # project through the SK extrinsics (preprocess.py:40-48)
        uvd = (K @ (rot.T @ (xyz.T - self.T.reshape(3, 1)))).T
        uvd = np.concatenate([uvd[:, :2] / uvd[:, 2:3], xyz[:, 2:3]], 1)
        # reorder + extrapolate the wrist (preprocess.py:267-277)
        uvd = uvd[self.KP_ORDER]
        wrist = uvd[16] + 2.0 * (uvd[0] - uvd[16])
        uvd = np.concatenate([wrist[None], uvd[1:]], 0)
        xyz = np.stack([(uvd[:, 0] - tx) * uvd[:, 2] / fx,
                        (uvd[:, 1] - ty) * uvd[:, 2] / fx,
                        uvd[:, 2]], -1)
        center_xyz = xyz.mean(0)
        sample = build_rgbd_sample(
            depth, rgb, xyz, center_xyz, self.cam_para, self.cube,
            self.split == 'train', self.aug_para, self.py_rng, self.np_rng,
            self.img_size, self.sample_num,
            color_factor=self.color_factor if self.split == 'train' else 0.,
            use_native=self.use_native)
        # STB applies ImageNet Normalize to the 0-255 floats BEFORE /255
        # (reference dataset_STB.py:19,47,121,131 — ToTensor on float32
        # arrays does not rescale, so the mean/std act on the 255 scale)
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        std = np.array([0.229, 0.224, 0.225], np.float32)
        sample['rgb'] = ((sample['rgb'] * 255.0 - mean) / std / 255.0
                         ).astype(np.float32)
        return sample


def make_dataset(cfg, split: str):
    """Dataset factory keyed by Config.dataset (reference train.py:124-191)."""
    if cfg.dataset == 'dexycb':
        return DexYCBDataset(cfg.dexycb_setup, split, cfg.root_dir,
                             cfg.input_size, cfg.augment_para,
                             cfg.point_num, cfg.seed)
    if cfg.dataset == 'ho3d':
        return HO3D(split, cfg.root_dir, cfg.ho3d_version, cfg.input_size,
                    cfg.center_type, cfg.augment_para,
                    tuple(cfg.cube_size), cfg.color_factor, cfg.point_num,
                    cfg.seed)
    if cfg.dataset == 'nyu':
        return NYUDataset(cfg.root_dir, split, cfg.input_size,
                          cfg.augment_para, tuple(cfg.cube_size),
                          cfg.center_type, cfg.point_num, cfg.seed)
    if cfg.dataset == 'STB':
        return STBDataset(split, cfg.root_dir, cfg.input_size,
                          cfg.augment_para, cfg.color_factor,
                          cfg.point_num, cfg.seed)
    raise ValueError(cfg.dataset)
