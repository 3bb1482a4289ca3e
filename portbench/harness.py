"""The benchmark's runner: finds a cell's files by the names in
BENCHMARK.json, runs its set-up, its measured (or traced) window and the
comparison with the plain reference, and prints the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by name:
  portbench/configs/<config>.json   the configuration as it is run; an
                                    optional `reference` names its own
                                    plain reference in
                                    portbench/reference/ (shared.reference)
  portbench/traffic/<traffic>.json  the mix: `kind` names its run class,
                                    portbench/kinds/<kind>.py, the rest
                                    its parameters
  portbench/limits/<workload>.json  each compared number's limit
  portbench/metrics/<metric>.py     `read(view)` of one per-layer metric
Paths are taken from a checkout's root (`root`), the repository's by
default.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package and the libraries it runs on: none may be loaded in a
# run (whole top-level names: keypointfusion_torch shares a prefix)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'keypointfusion_tpu')


class Refused(Exception):
    """A run that must end without a result line."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its files."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        by_name = {w['name']: w for w in bench['workloads']}
        if name not in by_name:
            raise Refused(f'no workload {name!r} in BENCHMARK.json')
        self.entry = by_name[name]
        self.name = name
        self.root = root
        self.chips = int(self.entry['chips'])
        conf = {c['name']: c for c in bench['configs']}[self.entry['config']]
        bench_dir = os.path.join(root, 'portbench')
        self.config = load_json(os.path.join(root, conf['file']))
        self.traffic = load_json(os.path.join(
            bench_dir, 'traffic', self.entry['traffic'] + '.json'))
        limits = os.path.join(bench_dir, 'limits', name + '.json')
        self.limits = load_json(limits)['limits'] \
            if os.path.exists(limits) else {}
        self.end_to_end = [m for m in bench['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in bench['per_layer']
                          if name in m.get('workloads', [name])]


def load_file(kind: str, name: str, root: str = ROOT):
    """The module of portbench/<kind>/<name>.py in the checkout at `root`,
    loaded by path."""
    path = os.path.join(root, 'portbench', kind, name + '.py')
    spec = importlib.util.spec_from_file_location(
        f'portbench_{kind}_' + name.replace('.', '_').replace('-', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, root: str = ROOT):
    """The `read(view)` function of per-layer metric `name`."""
    return load_file('metrics', name, root).read


def run_class(kind: str, root: str = ROOT):
    """The run class of a traffic kind (portbench/kinds/<kind>.py)."""
    return load_file('kinds', kind, root).Run


def forbidden_loaded(names=None) -> List[str]:
    """The forbidden top-level names among `names` (the loaded modules'
    by default)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def judge(numbers: Dict[str, float], limits: Dict[str, float], failed: int):
    """(correct, [(name, value, limit)]): each number the cell's limits
    name is present, finite and at or under its limit, and nothing
    failed. Readings without a limit are not compared."""
    rows = [(name, numbers.get(name), limit)
            for name, limit in sorted(limits.items())]
    ok = failed == 0 and bool(rows) and all(
        v is not None and v == v and v <= limit for _, v, limit in rows)
    return ok, rows


def device_info(chips: int, trace_view=None) -> dict:
    import torch
    info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated(0))}
    if trace_view is not None:
        info['busy_s'] = trace_view.busy_s
        info['window_s'] = trace_view.window_s
    return info


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = 'cuda', small: Optional[dict] = None,
             t_start: Optional[float] = None, root: str = ROOT):
    """Set-up, window and comparison of one cell; returns the result
    dict and the lines of compared numbers. `small` shrinks the sizes
    (tests on the CPU); the cells run with None."""
    import torch
    t_start = time.time() if t_start is None else t_start
    cell = Cell(bench, workload, root)
    flags = cell.config.get('tf32', False)
    torch.backends.cuda.matmul.allow_tf32 = flags
    torch.backends.cudnn.allow_tf32 = flags
    run = run_class(cell.traffic['kind'], root)(cell, seed, device,
                                                small or {})
    run.set_up()
    setup_s = time.time() - t_start
    metrics = {}
    view = None
    if trace:
        view = run.traced()
        for m in cell.per_layer:
            value = reader(m['name'], root)(view)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        measured = run.window(seconds)
        measured['setup_s'] = setup_s
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': measured[m['name']],
                                  'unit': m['unit']}
    dev = device_info(cell.chips, view) if device == 'cuda' else {
        'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}
    run.free()
    numbers, failed = run.check()
    loaded = forbidden_loaded()
    if loaded:
        raise Refused('modules of the JAX package or of JAX are loaded: '
                      + ', '.join(loaded))
    correct, rows = judge(numbers, cell.limits, failed)
    result = {'correct': correct, 'attempted': run.attempted,
              'failed': failed, 'metrics': metrics, 'device': dev}
    if view is not None:
        result['breakdown'] = view.breakdown()
    result['compared'] = {name: {'value': value, 'limit': limit}
                          for name, value, limit in rows}
    return result, rows


def main(args, t_start: float) -> int:
    import torch
    bench = load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    cell = Cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        raise Refused(f'{args.workload} needs {cell.chips} CUDA device(s); '
                      f'found {torch.cuda.device_count()}')
    result, rows = run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=t_start)
    for name, value, limit in rows:
        print(f'compared {name} {value} limit {limit}', file=sys.stderr)
    print(json.dumps(result))
    return 0
