"""The check's control: the program's own narrow path (wavefields stored in
bfloat16, the precision below the configurations' float32) comes out not
correct under the cells' own limits. On the CPU at a small size, and on
the card at a size a test run holds."""

import json
import time

import pytest

from gpubench.tests.helpers import SEED, limits, run, tiny


@pytest.mark.parametrize('problem', ['acoustic', 'tti'])
def test_control_is_not_correct(problem):
    res = run(problem, control=True, seconds=0.1)
    assert res['correct'] is False
    assert any(c['value'] > c['limit'] for c in res['checks'].values())


@pytest.mark.cuda
@pytest.mark.parametrize('problem', ['acoustic', 'tti'])
@pytest.mark.parametrize('control', [False, True])
def test_control_on_the_card(card, problem, control):
    """At 96^3 on the card the program's float32 path is correct and its
    narrow path is not."""
    from gpubench.harness import run_cell
    cfg = dict(tiny(problem), shape=[96, 96, 96], nbl=10, tn=150.0,
               receivers=dict(tiny(problem)['receivers'], counts=[96, 1]))
    t0 = time.perf_counter()
    res = run_cell(f'{problem}.shots', SEED, 1.0, False,
                   lambda: time.perf_counter() - t0, control=control,
                   device=str(card),
                   overrides={'config': cfg, 'limits': limits(problem)})
    assert res['correct'] is (not control), json.dumps(res['checks'])
