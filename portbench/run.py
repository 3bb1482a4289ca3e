#!/usr/bin/env python3
"""Runs one cell of the port's benchmark (BENCHMARK.json) on this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 a breakdown, and
last the numbers compared with the reference, each beside its limit; the
same numbers end standard error. Exits non-zero, printing no result, when
the card or the program is missing, or when JAX or the JAX package was
loaded.
"""

import time

T_START = time.time()   # set-up counts from here, before torch loads

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == '__main__':
    args = parse()
    from portbench import harness
    try:
        sys.exit(harness.main(args, T_START))
    except harness.Refused as e:
        print(f'refused: {e}', file=sys.stderr)
        sys.exit(3)
