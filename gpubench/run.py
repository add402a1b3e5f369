"""Runs one cell of the benchmark once and prints its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells. The last line
of standard output is the result (one JSON object); the numbers the check
compared, each beside its limit, are the last lines of standard error and
the result's last key. ``--control`` runs the program's narrow-storage
path in place of its float32 path, the check's control, and ``--fault
<name>`` plants one of the job driver's faults (``FAULTS`` of
``traffic/<driver>.py``) under the timed path: both have to come out not
correct, and the benchmark's own runs never pass them.

Exits with 0 after printing the result; without a result, with 2 when no
card or too few cards are there, 3 when JAX or the JAX package is loaded,
4 when the run cannot give a result (the message says why).
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_age():
    """Seconds since this process started (Linux), else 0."""
    try:
        with open('/proc/self/stat') as f:
            start = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf('SC_CLK_TCK'), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age()
_T0 = time.perf_counter()


def clock():
    """Seconds since this process started."""
    return _AGE0 + time.perf_counter() - _T0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--fault')
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parent.parent
    # every build and kernel cache inside the checkout, at a fixed path
    cache = root / 'gpubench' / '_cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    sys.path.insert(0, str(root))
    from gpubench import guard
    from gpubench.manifest import Manifest

    chips = Manifest(root).cell(args.workload)['chips']
    bad = guard.loaded()
    if bad:
        print(f"gpubench: loaded at start: {bad}", file=sys.stderr)
        return 3
    import torch
    stamps = {'torch imported': clock()}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from gpubench.harness import NoResult, run_cell
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), clock, control=args.control,
                          fault=args.fault,
                          device='cuda:0', chips=chips, root=root,
                          stamps=stamps)
    except NoResult as e:
        print(f"gpubench: no result: {e}", file=sys.stderr)
        return 4
    bad = guard.loaded()
    if bad:
        print(f"gpubench: loaded once the window had closed: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
