"""A traced window and what the per-layer readers see of it.

`record(work, ...)` runs `work()` under torch.profiler (host and device
activities), exports the trace into the run's temporary directory, reads
it back and deletes it. Each device operation (kernel, copy, memset) is
tied, by its correlation id, to the host call that launched it, and that
call to every host range open around it on its thread: the benchmark's
own `record_function` ranges (`pb.*`), torch's operators, autograd's
backward functions and the optimizer's step. `View` holds the result:
the device operations with their ranges, the device's busy time (the
union of their intervals), the window's host length, the harness's host
spans, and the counts the readers divide by.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation')


class DeviceOp:
    __slots__ = ('name', 'cat', 'ts', 'dur', 'ranges', 'launcher')

    def __init__(self, name, cat, ts, dur):
        self.name, self.cat, self.ts, self.dur = name, cat, ts, dur
        self.ranges: tuple = ()
        self.launcher = ''

    def under(self, prefix: str) -> bool:
        """True when a host range whose name starts with `prefix` was open
        around the launch."""
        return any(r.startswith(prefix) for r in self.ranges)


class View:
    """What a traced window gives the per-layer readers."""

    def __init__(self, ops: List[DeviceOp], window_s: float, units: int,
                 frames_per_unit: int, info: Optional[dict] = None):
        self.ops = ops
        self.window_s = window_s
        self.units = units
        self.frames_per_unit = frames_per_unit
        self.info = info or {}
        self.spans: Dict[str, List[float]] = defaultdict(list)
        merged, end = [], None
        for s, e in sorted((o.ts, o.ts + o.dur) for o in ops):
            if end is None or s > end:
                merged.append([s, e])
                end = e
            else:
                end = max(end, e)
                merged[-1][1] = end
        self.busy = merged
        self.busy_s = sum(e - s for s, e in merged) / 1e6

    def per_unit_ms(self, keep: Callable[[DeviceOp], bool]) -> Optional[float]:
        """Device ms a unit (request, step) of the operations kept, or
        None when no such operation ran."""
        chosen = [o for o in self.ops if keep(o)]
        if not chosen:
            return None
        return sum(o.dur for o in chosen) / 1e3 / self.units

    def kernels(self, name: str) -> List[DeviceOp]:
        """The kernels whose name holds `name`, in launch order."""
        return [o for o in self.ops if o.cat == 'kernel' and name in o.name]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps by the host call that launched the operation ending the
        gap, each [name, seconds]."""
        by_name = defaultdict(float)
        for o in self.ops:
            by_name[o.name[:90]] += o.dur / 1e6
        gaps = defaultdict(float)
        starts = sorted(self.ops, key=lambda o: o.ts)
        keys = [o.ts for o in starts]
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            op = starts[bisect.bisect_left(keys, s1)]
            gaps[op.launcher or '(no host call)'] += (s1 - e0) / 1e6
        order = lambda d: sorted(([k, v] for k, v in d.items()),
                                 key=lambda kv: -kv[1])[:top]
        return {'device_ops': order(by_name), 'idle_gaps': order(gaps)}


def _attach(events: List[dict]) -> List[DeviceOp]:
    """Device operations with the host ranges open around their launch."""
    launches = {}
    host = defaultdict(list)
    ops = []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat', '')
        args = e.get('args') or {}
        if cat in DEVICE_CATS:
            op = DeviceOp(e.get('name', ''), cat, float(e['ts']),
                          float(e.get('dur', 0.0)))
            op.launcher = args.get('correlation')
            ops.append(op)
        elif cat == 'cuda_runtime' and 'correlation' in args:
            launches[args['correlation']] = (e.get('tid'), float(e['ts']))
        elif cat in HOST_CATS:
            host[e.get('tid')].append((float(e['ts']),
                                       float(e['ts']) + float(e.get('dur', 0)),
                                       e.get('name', '')))
    by_thread = defaultdict(list)
    for op in ops:
        tid, ts = launches.get(op.launcher, (None, None))
        op.launcher = ''
        if tid is not None:
            by_thread[tid].append((ts, op))
    # one sweep per thread: host ranges nest, so a stack holds the ranges
    # open at each launch, outermost first
    for tid, found in by_thread.items():
        spans = sorted(host.get(tid, []), key=lambda s: (s[0], -s[1]))
        stack, j = [], 0
        for ts, op in sorted(found, key=lambda f: f[0]):
            while j < len(spans) and spans[j][0] <= ts:
                while stack and stack[-1][1] < spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            op.ranges = tuple(s[2] for s in stack)
            op.launcher = stack[-1][2] if stack else ''
    return ops


def record(work: Callable[[], int], frames_per_unit: int,
           info: Optional[dict] = None) -> View:
    """Run `work()` (it returns the number of units it ran) under the
    profiler, synchronised at both ends, and read the trace."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        units = work()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get('traceEvents', [])
    finally:
        os.remove(path)
    return View(_attach(events), window_s, units, frames_per_unit, info)


@contextlib.contextmanager
def ranges_on(model: torch.nn.Module, names: Dict[str, List]):
    """Open `record_function` ranges around the forward of modules:
    names maps a range name to the modules it covers."""
    from torch.autograd.profiler import record_function
    handles = []
    for name, modules in names.items():
        for m in modules:
            stack = []

            def pre(_m, _a, name=name, stack=stack):
                stack.append(record_function(name).__enter__())

            def post(_m, _a, _o, stack=stack):
                stack.pop().__exit__(None, None, None)

            handles.append(m.register_forward_pre_hook(pre))
            handles.append(m.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
