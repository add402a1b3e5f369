"""Small runs of the harness on the CPU, for the tests."""

import json
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 2 ** 33 + 7        # larger than 32 signed bits hold


def tiny(problem):
    """The small copy of the cell's configuration (``configs/``)."""
    return json.loads((HERE / 'configs' / f'{problem}-tiny.json')
                      .read_text())


def limits(problem):
    """The cell's own check limits, with more shots compared."""
    from gpubench.manifest import Manifest
    man = Manifest()
    lim = Manifest.limits(man.cell(f'{problem}.shots')['config'])
    return dict(lim, shots_compared=3)


def run(problem, seed=SEED, seconds=0.5, trace=False, control=False,
        fault=None):
    """One run of ``<problem>.shots`` on the CPU at the small size."""
    from gpubench.harness import run_cell
    t0 = time.perf_counter()
    return run_cell(f'{problem}.shots', seed, seconds, trace,
                    lambda: time.perf_counter() - t0, control=control,
                    device='cpu', fault=fault,
                    overrides={'config': tiny(problem),
                               'limits': limits(problem)})
