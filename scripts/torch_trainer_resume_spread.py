#!/usr/bin/env python3
"""Run-to-run spread of the trainer on the card, beside its resume.

    python3 scripts/torch_trainer_resume_spread.py [--repeats 3]

chip_smoke.py's [trainer] configuration (KPFusion-resnet-18, float32,
batch 64, 1024 points, 256 training and 104 test samples, 2 epochs,
random weights from seed 0): `--repeats` straight runs, then
chip_smoke.py's resume check (a one-epoch run, a resumed run and a
control resumed without the optimizer's state), once with cuDNN's
default algorithms and once with its deterministic ones. Prints one JSON
line per setting: each straight run's distance from the first, the
resumed run's and the control's, as chip_smoke.py:resume_errors measures
them (L2 over every tensor at once), and the card's name and power
limit. chip_smoke.py's RESUME_TOL is set from these lines.
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--repeats', type=int, default=3)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.synthetic import synthetic_dataset
    from keypointfusion_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]

    @dataclasses.dataclass(frozen=True)
    class TrainerConfig(Config):
        epochs: int = cs.TRAINER_EPOCHS

        @property
        def max_epoch(self) -> int:
            return self.epochs

    cfg = TrainerConfig(batch_size=cs.BATCH, point_num=1024, seed=0,
                        pretrain='')
    train_set = synthetic_dataset(cs.TRAINER_TRAIN, 1024, seed=1000)
    test_set = synthetic_dataset(cs.TRAINER_TEST, 1024, seed=5000)
    root = tempfile.mkdtemp(prefix='kpf_spread_')
    try:
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            sub = os.path.join(root, str(deterministic))
            make = lambda name, c=cfg: Trainer(
                c, train_set, test_set, model_dir=os.path.join(sub, name),
                device=dev)
            ends = []
            for i in range(args.repeats):
                t = make(f'straight{i}')
                start = cs.trainer_state(t)
                t.train()
                ends.append(cs.trainer_state(t))
            failures, errors, control, _ = cs.resume_runs(
                make, cfg, start, ends[0])
            print(json.dumps({
                'cudnn_deterministic': deterministic,
                'straight_vs_first': [cs.resume_errors(e, ends[0], start)
                                      for e in ends[1:]],
                'resumed': errors, 'control': control,
                'failures': failures, 'tol': cs.RESUME_TOL,
                'card': card}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
