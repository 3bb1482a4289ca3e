"""The port's tracing: named spans and one counter, live only while
torch's profiler records.

    with span('kpf.model'):
        ...

With the profiler off, `span` returns one shared no-op context: the cost
is a call and a check of the profiler's own state
(torch._C._autograd._profiler_enabled); no record_function is entered,
no clock is read and nothing is written to the registry.

With the profiler on, a span opens `record_function(name)`, so it sits in
the profiler's trace on the clock of the device operations it launches
(each operation's host ranges hold it), and adds its calls and its host
seconds to the process's registry. The registry also counts host waits:
the synchronizing CUDA calls the program makes on its own thread inside
a span, each put down to the innermost span open on that thread, with
the file and line of the port that made it. They are caught by torch's
sync debug mode ('warn'), switched on while a span is open under the
profiler and restored when the last one closes; its warnings are
counted here and shown nowhere. It flags (torch 2.11 on an H100) a
pageable copy either way (`torch.tensor(.., device='cuda')`,
`torch.as_tensor(x, device='cuda')` of a host value, `.to('cuda')` of a
CPU tensor, `.cpu()`), `.item()` and so `int(t)`, `float(t)`,
`bool(t)`, `torch.nonzero` and a stream's `synchronize()`; it does not
flag `torch.cuda.synchronize()` or an event's `synchronize()`, which
are not counted. Waits on autograd's backward thread are out of scope:
torch hands their warnings to the thread that called `backward()` when
it returns, where they would count under the span open there.

The registry holds one traced window: it is cleared when a span sees the
profiler on after a span has seen it off, so warm-up and set-up stay
out. `totals()` returns a snapshot of it.

`trace(log_dir)` is the operator's exporter: it profiles a block and
writes a Chrome trace (chrome://tracing or Perfetto) whose timeline
holds the `kpf.*` spans beside torch's operators and, on the card, the
kernels and copies they launched.
"""

from __future__ import annotations

import contextlib
import copy
import os
import sys
import threading
import time
import warnings
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_profiler_enabled = torch._C._autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
# the text torch's sync debug mode warns with
SYNC_WARNING = 'called a synchronizing CUDA operation'
# and the text it warns with when it is switched on
PROTOTYPE_WARNING = 'Synchronization debug mode is a prototype feature'
_PORT = os.sep + 'keypointfusion_torch' + os.sep


class _Registry:
    """Per span name: calls, host seconds, host waits, and the waits by
    the file and line of the port that made them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.seen_off = True
        self.open = 0          # spans open under the profiler, all threads
        self.restore = None    # what switching on the sync debug mode saved
        self.clear()

    def clear(self):
        self.entries = defaultdict(lambda: {'calls': 0, 'host_s': 0.0,
                                            'waits': 0, 'sites': {}})

    def stack(self) -> list:
        stack = getattr(self.local, 'stack', None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def enter(self, name: str) -> None:
        with self.lock:
            if self.seen_off:
                self.seen_off = False
                self.clear()
            if self.open == 0 and torch.cuda.is_initialized():
                self.catch_waits()
            self.open += 1
        self.stack().append(name)

    def exit(self, name: str, host_s: float) -> None:
        self.stack().pop()
        with self.lock:
            entry = self.entries[name]
            entry['calls'] += 1
            entry['host_s'] += host_s
            self.open -= 1
            if self.open == 0 and self.restore is not None:
                self.release_waits()

    def catch_waits(self) -> None:
        catcher = warnings.catch_warnings()
        catcher.__enter__()
        warnings.filterwarnings('always', message=SYNC_WARNING)
        warnings.filterwarnings('ignore', message=PROTOTYPE_WARNING)
        shown = warnings.showwarning
        mode = torch.cuda.get_sync_debug_mode()

        def on_warning(message, category, filename, lineno, file=None,
                       line=None):
            if not str(message).startswith(SYNC_WARNING):
                shown(message, category, filename, lineno, file, line)
                return
            stack = self.stack()
            if stack:
                self.wait(stack[-1], _site(filename, lineno))

        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode('warn')
        self.restore = (catcher, mode)

    def release_waits(self) -> None:
        catcher, mode = self.restore
        self.restore = None
        torch.cuda.set_sync_debug_mode(mode)
        catcher.__exit__(None, None, None)

    def wait(self, name: str, site: str) -> None:
        with self.lock:
            entry = self.entries[name]
            entry['waits'] += 1
            entry['sites'][site] = entry['sites'].get(site, 0) + 1


def _site(filename: str, lineno: int) -> str:
    """'keypointfusion_torch/...py:line' of the innermost frame in the
    port that led to the warning (the op may have been called from
    torch's own Python); the warning's own location where none did."""
    frame = sys._getframe(2)    # the caller of the warning's handler
    while frame is not None:
        path = frame.f_code.co_filename
        if _PORT in path:
            return f'{path[path.rindex(_PORT) + 1:]}:{frame.f_lineno}'
        frame = frame.f_back
    return f'{filename}:{lineno}'


_REGISTRY = _Registry()


class _Span:
    __slots__ = ('name', 'range', 't0')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _REGISTRY.enter(self.name)
        self.range = record_function(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        _REGISTRY.exit(self.name, host_s)
        return False


def span(name: str):
    """A context manager: a named range of the profiler's trace and an
    entry of the registry while torch's profiler records; the shared
    no-op context otherwise."""
    if not _profiler_enabled():
        _REGISTRY.seen_off = True
        return _NOOP
    return _Span(name)


def totals() -> dict:
    """A snapshot of the registry: {span name: {'calls', 'host_s',
    'waits', 'sites': {'file:line': waits}}} over the latest traced
    window."""
    with _REGISTRY.lock:
        return copy.deepcopy(dict(_REGISTRY.entries))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU activity, and CUDA
    activity where a card is present) and write log_dir/trace.json when
    it ends: the spans the block opened nest in it as they were opened,
    around torch's operators and the device work they launched. Yields
    the profiler: key_averages() sums the time by operator, span and
    kernel."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
