"""Command line of the port: train, test or evaluate KPFusion on a dataset
(port of the repository's train.py over keypointfusion_torch's Config).

    python -m keypointfusion_torch.train --phase train --dataset dexycb \\
        --root_dir DATA --batch_size 64
    python -m keypointfusion_torch.train --phase test --dataset dexycb \\
        --root_dir DATA --load_model best

Every bool, str, int and float field of the Config is a flag of its own
name (bools take 1/true/yes/y, anything else is false), as in train.py;
tuple fields keep their defaults. One flag is not a Config field:
--loader_threads, the data loader's threads (8, as train.py's trainer;
1 makes the draws of augmentations and point samples, and so test()'s
errors, repeat from run to run). The phase picks Trainer.train(),
test() or evaluation(); the trainer loads cfg.dataset's splits from
--root_dir and runs on the CUDA card (`main(argv, device='cpu')` runs on
the CPU). Float32 means float32 there: main() turns TF32 off for
cuBLAS and cuDNN (PyTorch lets cuDNN's convolutions take TF32 by
default), as the port's parity checks run. The XLA compile cache that
train.py turns on has no counterpart. After the phase, one JSON line
gives the phase, the samples of each split, the phase's result and the
launches of each CUDA kernel in it.

On several cards, one rank per card:

    python -m torch.distributed.run --nproc_per_node N \
        -m keypointfusion_torch.train --phase train --dataset dexycb ...

Under torch.distributed.run (WORLD_SIZE above 1 in the environment) each
rank joins the process group that the environment names and runs on
cuda:LOCAL_RANK, or on the CPU with `main(argv, device='cpu')`. The
backend is NCCL on the card and gloo on the CPU; nothing falls back to
another. The trainer takes the world that divides
--batch_size (training/trainer.py); --sync_batchnorm (default true)
picks global-batch BatchNorm statistics over per-rank ones. Rank 0
prints the JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

from keypointfusion_torch.config import Config


def _str2bool(v) -> bool:
    return str(v).lower() in ('1', 'true', 'yes', 'y')


def _parse(argv, config):
    parser = argparse.ArgumentParser(
        prog='python -m keypointfusion_torch.train')
    for f in dataclasses.fields(config):
        if isinstance(f.default, bool):
            parser.add_argument(f'--{f.name}', type=_str2bool,
                                default=f.default)
        elif isinstance(f.default, (str, int, float)):
            parser.add_argument(f'--{f.name}', type=type(f.default),
                                default=f.default)
    parser.add_argument('--loader_threads', type=int, default=8)
    args = vars(parser.parse_args(argv))
    threads = args.pop('loader_threads')
    return config(**args), threads


def parse_config(argv: Optional[Sequence[str]] = None,
                 config=Config) -> Config:
    """A `config` (the Config class, or a dataclass derived from it) from
    command-line flags (sys.argv[1:] when argv is None)."""
    return _parse(argv, config)[0]


def _join_launch(device):
    """(device, group) of a rank started by torch.distributed.run, or
    (device, None) outside such a launch."""
    import os
    import torch
    from keypointfusion_torch.parallel.mesh import init_process_group
    if int(os.environ.get('WORLD_SIZE', '1')) <= 1:
        return device, None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass '
                               'device="cpu" to run the ranks on the CPU')
        device = torch.device('cuda', int(os.environ['LOCAL_RANK']))
        torch.cuda.set_device(device)
    device = torch.device(device)
    return device, init_process_group(
        'nccl' if device.type == 'cuda' else 'gloo')


def main(argv: Optional[Sequence[str]] = None, device=None, config=Config):
    """Run the phase that the flags name; returns (trainer, result)."""
    import torch
    import torch.distributed as dist
    from keypointfusion_torch.kernels import desa_dense, grouped_mlp_pool, \
        pixel_sampler
    from keypointfusion_torch.training.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (pixel_sampler.KERNEL, desa_dense.KERNEL,
               pixel_sampler.SERVING_KERNEL, desa_dense.SERVING_KERNEL,
               grouped_mlp_pool.KERNEL)
    cfg, threads = _parse(argv, config)
    if cfg.phase not in ('train', 'test', 'eval'):
        raise ValueError(f'unknown phase {cfg.phase}')
    device, group = _join_launch(device)
    try:
        trainer = Trainer(cfg, device=device, loader_threads=threads,
                          group=group)
        before = {k.name: k.launches for k in kernels}
        if cfg.phase == 'train':
            result = trainer.train()
        elif cfg.phase == 'test':
            result = trainer.test()
        else:
            result = trainer.evaluation()
        if not trainer.idle and trainer.rank == 0:
            sizes = {name: (len(data) if data is not None else None)
                     for name, data in (('train_samples', trainer.train_data),
                                        ('test_samples', trainer.test_data))}
            print(json.dumps({
                'phase': cfg.phase, **sizes, 'result': result,
                'kernel_launches': {k.name: k.launches - before[k.name]
                                    for k in kernels}}))
    finally:
        if group is not None:
            dist.destroy_process_group()
    return trainer, result


if __name__ == '__main__':
    main()
