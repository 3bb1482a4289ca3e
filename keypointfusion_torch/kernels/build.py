"""Build and bind the port's CUDA kernels.

Each source under keypointfusion_torch/csrc/ is compiled by nvcc for
sm_90a into a shared library with a plain C interface and loaded with
ctypes. Nothing is built when a module is imported: a kernel is built the
first time it is launched, or by `build()`, which starts one nvcc per
missing library, all at once. Libraries land in keypointfusion_torch/_build/
under a name that carries a hash of the source, the shared headers
(csrc/*.cuh) and the flags, so an edited source or header is rebuilt and a
stale library is never loaded.

Every C entry point launches on the stream it is given and returns
cudaGetLastError() as an int; `CudaKernel.launch` raises when that is not
0 and counts the launches that succeeded.

Host code of the data path (csrc/host/*.cc, the image decoders) takes the
same road with g++ (`HostLibrary`): built at first use into _build/ under
a name that hashes its source and flags, bound with ctypes, which
releases the GIL for the call. Without g++ it raises; there is no Python
stand-in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from keypointfusion_torch.utils.profiling import span

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
GXX_FLAGS = ('-std=c++17', '-O3', '-shared', '-fPIC')


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels are built on '
                           'a machine with the CUDA toolkit')
    return path


class CudaKernel:
    """One C entry point of one .cu source, built on first use.

    `launches` counts the launches that returned without error. Under
    torch's profiler each launch sits in a span `kpf.kernel.<name>`
    (utils/profiling.py), so the trace puts the kernel's device time and
    the idle gap before it down to the kernel: the ctypes call opens no
    torch operator of its own."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.span = 'kpf.kernel.' + name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ''
        self._fn = None

    @property
    def library(self) -> Path:
        headers = b''.join(h.read_bytes()
                           for h in sorted(CSRC_DIR.glob('*.cuh')))
        digest = hashlib.sha256(self.source.read_bytes() + headers
                                + ' '.join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        return BUILD_DIR / f'{self.source.stem}-{digest}.so'

    def load(self):
        """Build (if missing) and bind the C entry point."""
        if self._fn is None:
            if not self.library.exists():
                build([self])
            lib = ctypes.CDLL(str(self.library))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        fn = self.load()
        with span(self.span):
            rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f'{self.name}: kernel launch failed with '
                               f'cudaError {rc}')
        self.launches += 1


def check_tensor(t, name: str, shape, device,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise unless t is a contiguous tensor of `dtype` and `shape` on
    `device`: what every kernel wrapper takes."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def build(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Compile every kernel whose library is missing, one nvcc process
    per source, all started together. Returns {name: seconds}; raises with
    nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List = []
    for k in kernels:
        if k.library.exists():
            continue
        tmp = k.library.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(k.source)]
        procs.append((k, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    times: Dict[str, float] = {}
    failed: Optional[str] = None
    for k, tmp, t0, p in procs:
        out, _ = p.communicate()
        times[k.name] = time.perf_counter() - t0
        k.build_log = out
        if p.returncode != 0:
            failed = failed or f'nvcc failed for {k.source.name}:\n{out}'
            continue
        os.replace(tmp, k.library)
    if failed:
        raise RuntimeError(failed)
    return times


class HostLibrary:
    """A host C++ source under csrc/host/ with `extern "C"` entry points,
    compiled by g++ at first use and bound with ctypes. `functions` maps
    each entry point to its argtypes; every one returns an int."""

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = CSRC_DIR / 'host' / source
        self.functions = {k: list(v) for k, v in functions.items()}
        self._lib = None
        self._lock = threading.Lock()

    @property
    def library(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + ' '.join(GXX_FLAGS).encode()
                                ).hexdigest()[:16]
        return BUILD_DIR / f'{self.source.stem}-{digest}.so'

    def _build(self):
        gxx = shutil.which('g++')
        if gxx is None:
            raise RuntimeError(f'g++ not found: {self.source.name} is built '
                               f'with g++ at first use')
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f'.{os.getpid()}.tmp')
        done = subprocess.run([gxx, *GXX_FLAGS, '-o', str(tmp),
                               str(self.source)], capture_output=True,
                              text=True)
        if done.returncode != 0:
            raise RuntimeError(f'g++ failed for {self.source.name}:\n'
                               f'{done.stdout}{done.stderr}')
        os.replace(tmp, self.library)

    def load(self):
        """Build (if missing) and bind every entry point; thread-safe."""
        with self._lock:
            if self._lib is None:
                if not self.library.exists():
                    self._build()
                lib = ctypes.CDLL(str(self.library))
                for symbol, argtypes in self.functions.items():
                    fn = getattr(lib, symbol)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def function(self, symbol: str):
        """The bound entry point `symbol`."""
        if symbol not in self.functions:
            raise KeyError(f'{symbol} is not an entry point of '
                           f'{self.source.name}')
        return getattr(self.load(), symbol)
