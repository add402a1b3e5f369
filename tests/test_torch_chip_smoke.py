"""The bookkeeping of chip_smoke.py that runs without the card: every probe
kernel's launch counter is found, read and set to 0, and the byte counts
of its bounds."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as C  # noqa: E402
from devito_tpu_torch.experiments import stencil_probe7 as P7  # noqa: E402
from devito_tpu_torch.experiments import stencil_probe9 as P9  # noqa: E402

torch.set_num_threads(1)


def test_every_probe_kernel_has_a_counter():
    main_path = {'stencil_update', 'selftest_window_sum'}
    assert set(C.PROBE_COUNTERS) == {k[0] for k in C.KERNELS} - main_path
    assert len(C.KERNELS) == 15


@pytest.mark.parametrize('name', sorted(C.PROBE_COUNTERS))
def test_probe_launches_reads_and_zeroes(name, monkeypatch):
    mod, attr, depth = C.PROBE_COUNTERS[name]
    C.probe_launches(zero=True)      # imports every probe module
    m = sys.modules[f'devito_tpu_torch.experiments.{mod}']
    monkeypatch.setattr(m, attr, 7 if depth is None else {depth: 7, 8: 1})
    counts = C.probe_launches()
    assert counts.pop(name) == 7 and not any(counts.values())
    assert not any(C.probe_launches(zero=True).values())


def test_cpu_probes_leave_the_counts_at_zero():
    C.probe_launches(zero=True)
    P9.main(16, 8, 1, 'cpu')
    P7.main('E', '4', '2', '3', device='cpu', n=16, za=160)
    assert not any(C.probe_launches().values())


def test_star_points():
    # the interior and 4-deep slabs on each face of a 2^3 cube
    assert C.star_points(2) == 8 + 6 * 4 * 4
    assert C.star_points(2, faces=4) == 8 + 4 * 4 * 4
