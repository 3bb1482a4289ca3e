"""Run-provenance source snapshot (port of
keypointfusion_tpu/utils/provenance.py).

The reference copies its core source files into `<model_dir>/files/` when
its trainer is built, so that a run can be rebuilt from its checkpoint
directory (reference train.py:60-66). Here the port's package sources
(Python, CUDA sources and headers; not `_build/`, the libraries nvcc
built) and its entry scripts (`chip_smoke.py`, `scripts/torch_*.py`)
are copied, with a MANIFEST.json of the git SHA and the versions of
torch, CUDA, numpy and nvcc that the run used.
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
import shutil
import subprocess

import numpy as np
import torch

SOURCE_SUFFIXES = ('.py', '.cu', '.cuh', '.cc')
ENTRY_SCRIPTS = ('chip_smoke.py', 'scripts/torch_*.py')


def _run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=10)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _versions() -> dict:
    versions = {'torch': torch.__version__, 'cuda': torch.version.cuda,
                'numpy': np.__version__}
    from keypointfusion_torch.kernels.build import _nvcc
    try:
        nvcc = _run([_nvcc(), '--version'])
    except RuntimeError:
        nvcc = None
    if nvcc:
        versions['nvcc'] = nvcc.splitlines()[-1]
    return versions


def snapshot_sources(dest_dir: str, pkg_dir: str = None) -> None:
    """Copy the port's sources (those of the package at `pkg_dir`, this
    one by default) and the entry scripts beside it into `dest_dir`, and
    write MANIFEST.json there. A failure to copy never stops a run."""
    if pkg_dir is None:
        import keypointfusion_torch
        pkg_dir = osp.dirname(osp.abspath(keypointfusion_torch.__file__))
    repo_dir = osp.dirname(pkg_dir)
    os.makedirs(dest_dir, exist_ok=True)
    try:
        for root, dirs, files in os.walk(pkg_dir):
            dirs[:] = [d for d in dirs
                       if d not in ('_build', '__pycache__')]
            rel = osp.relpath(root, pkg_dir)
            for f in files:
                if not f.endswith(SOURCE_SUFFIXES):
                    continue
                out = osp.join(dest_dir, 'keypointfusion_torch', rel, f)
                os.makedirs(osp.dirname(out), exist_ok=True)
                shutil.copy2(osp.join(root, f), out)
        for pattern in ENTRY_SCRIPTS:
            for src in glob.glob(osp.join(repo_dir, pattern)):
                out = osp.join(dest_dir, osp.relpath(src, repo_dir))
                os.makedirs(osp.dirname(out), exist_ok=True)
                shutil.copy2(src, out)
        with open(osp.join(dest_dir, 'MANIFEST.json'), 'w') as f:
            json.dump({'git_sha': _run(['git', '-C', repo_dir, 'rev-parse',
                                        'HEAD']),
                       'versions': _versions()}, f, indent=1)
    except OSError:
        pass
