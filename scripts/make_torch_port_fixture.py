"""Write tests/fixtures/torch_port_dexycb/: a DexYCB-layout tree of four
480x640 frames with cv2's decode of each image and the JAX package's
samples of it, which the PyTorch port's data path is held to where there
is no cv2 and no JAX (chip_smoke.py's [data] phase, the card tests) and
on the CPU (tests/test_torch_port_datasets.py).

    JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py

Needs cv2 and the JAX package; the port itself is not used. The frames
are smooth (gradients and shapes, no noise) so that the tree stays small:
  * DexYCB/imgs/color_00000{0..3}.jpg: BGR colour at cv2's JPEG defaults
    (quality 95, 4:2:0);
  * DexYCB/imgs/aligned_depth_to_color_00000{0..3}.png: 16-bit depth in
    mm, a far background plane and a hand-sized blob at ~600 mm;
  * DexYCB/annotations/DEX_YCB_s0_{train,test}_data.json: one annotation
    per frame (21 joints in camera mm around the blob; right and left
    hands in turn);
  * decoded.npz: cv2.imread of each colour file (uint8 BGR) and
    cv2.imread(..., IMREAD_ANYDEPTH) of each depth file (uint16);
  * samples.npz: keypointfusion_tpu's DexYCBDataset('s0', split, seed=
    SEED, 1024 points) read at TRAIN_INDICES of the train split and
    TEST_INDICES of the test split, in that order, through its numpy
    route (the native eval core off); keys '{split}_{index}_{key}';
  * native_samples.npz: the test split read at NATIVE_INDICES by a fresh
    dataset of the same seed through its default eval route, the native
    core (keypointfusion_tpu/native); keys 'test_{index}_{key}'. The
    port's native core (keypointfusion_torch/data/native.py) is held to
    it bit for bit by chip_smoke.py's [native] phase and
    tests/test_torch_port_native.py.
"""

import json
import os
import os.path as osp
import shutil
import sys

import cv2
import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
OUT = osp.join(REPO, 'tests', 'fixtures', 'torch_port_dexycb')
FX, FY, FU, FV = 616.0, 616.4, 321.1, 238.9
SEED = 7
TRAIN_INDICES = (1, 2)
TEST_INDICES = (0, 3)
NATIVE_INDICES = (0, 1, 2, 3)
# hand blob centres (pixels) and depths (mm) of the four frames
HANDS = ((300, 250, 610.), (380, 210, 560.), (250, 300, 650.),
         (420, 280, 590.))


def colour_frame(i: int) -> np.ndarray:
    h, w = 480, 640
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([90 + 60 * np.sin(x / 90 + i) + y / 8,
                    120 + 50 * np.cos(y / 70 - i),
                    60 + x / 6], -1)
    cv2.rectangle(img, (40 + 30 * i, 330), (260 + 30 * i, 450),
                  (40, 90, 160), -1)
    cv2.circle(img, (520 - 20 * i, 110), 60, (200, 200, 60), -1)
    cx, cy, _ = HANDS[i]
    cv2.ellipse(img, (cx, cy), (45, 60), 15 * i, 0, 360, (120, 150, 210),
                -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def depth_frame(i: int) -> np.ndarray:
    h, w = 480, 640
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = 1150 + 0.3 * x + 0.2 * y                  # far background
    cx, cy, z = HANDS[i]
    r2 = ((x - cx) / 45) ** 2 + ((y - cy) / 60) ** 2
    palm = r2 < 1
    depth[palm] = z + 25 * r2[palm]                    # a dome
    for k in range(5):                                 # fingers
        fx0 = cx - 36 + 18 * k
        finger = (np.abs(x - fx0) < 6) & (y > cy - 115 + 8 * abs(k - 2)) \
            & (y < cy - 50)
        depth[finger] = z - 10 + 0.2 * (cy - y[finger])
    depth[:, :12] = 0                                  # invalid columns
    return np.round(depth).astype(np.uint16)


def annotations(n: int):
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(n):
        cx, cy, z = HANDS[i]
        centre = np.array([(cx - FU) * z / FX, (cy - 80 - FV) * z / FY, z])
        joints = centre + rng.uniform(-45, 45, (21, 3)) * [1, 1, 0.4]
        images.append({'id': i, 'color_file_name':
                       f'imgs/color_{i:06d}.jpg', 'height': 480,
                       'width': 640})
        anns.append({'id': i, 'image_id': i,
                     'joints_coord_cam': joints.round(3).tolist(),
                     'cam_param': {'focal': [FX, FY], 'princpt': [FU, FV]},
                     'hand_type': 'right' if i % 2 == 0 else 'left',
                     'mano_param': {'pose': [0.0] * 48,
                                    'shape': [0.0] * 10,
                                    'trans': [0.0] * 3}})
    return {'images': images, 'annotations': anns}


def main():
    sys.path.insert(0, REPO)
    from keypointfusion_tpu import native
    from keypointfusion_tpu.data.datasets import DexYCBDataset

    shutil.rmtree(OUT, ignore_errors=True)
    imgs = osp.join(OUT, 'DexYCB', 'imgs')
    os.makedirs(imgs)
    os.makedirs(osp.join(OUT, 'DexYCB', 'annotations'))
    decoded = {}
    for i in range(len(HANDS)):
        colour = osp.join(imgs, f'color_{i:06d}.jpg')
        depth = osp.join(imgs, f'aligned_depth_to_color_{i:06d}.png')
        assert cv2.imwrite(colour, colour_frame(i))
        assert cv2.imwrite(depth, depth_frame(i))
        decoded[f'color_{i:06d}'] = cv2.imread(colour)
        decoded[f'aligned_depth_to_color_{i:06d}'] = cv2.imread(
            depth, cv2.IMREAD_ANYDEPTH)
    db = annotations(len(HANDS))
    for split in ('train', 'test'):
        with open(osp.join(OUT, 'DexYCB', 'annotations',
                           f'DEX_YCB_s0_{split}_data.json'), 'w') as f:
            json.dump(db, f)
    np.savez_compressed(osp.join(OUT, 'decoded.npz'), **decoded)

    if not native.available():
        raise RuntimeError('the JAX native core did not build (g++)')
    ds = DexYCBDataset('s0', 'test', OUT, sample_num=1024, seed=SEED)
    np.savez_compressed(osp.join(OUT, 'native_samples.npz'), **{
        f'test_{i}_{k}': v for i in NATIVE_INDICES for k, v in ds[i].items()})

    native.available = lambda: False     # the numpy route
    samples = {}
    for split, indices in (('train', TRAIN_INDICES), ('test', TEST_INDICES)):
        ds = DexYCBDataset('s0', split, OUT, sample_num=1024, seed=SEED)
        for i in indices:
            for k, v in ds[i].items():
                samples[f'{split}_{i}_{k}'] = v
    np.savez_compressed(osp.join(OUT, 'samples.npz'), **samples)
    total = sum(osp.getsize(osp.join(d, f)) for d, _, fs in os.walk(OUT)
                for f in fs)
    print(f'wrote {OUT}: {total} bytes')


if __name__ == '__main__':
    main()
