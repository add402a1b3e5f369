"""The shape of a run's result: the last line's keys, each metric with its
unit, the compared numbers under ``checks`` as the last key; the exits
without a result (no card; no program beside the benchmark)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from gpubench.manifest import ROOT, Manifest
from gpubench.tests.helpers import run


@pytest.mark.parametrize('trace', [False, True])
def test_result_line(trace):
    res = run('acoustic', trace=trace)
    assert list(res)[-1] == 'checks'
    for key in ('correct', 'attempted', 'failed', 'metrics', 'device'):
        assert key in res
    assert res['correct'] is True and res['failed'] == 0
    assert res['attempted'] >= 1
    kind = 'per_layer' if trace else 'end_to_end'
    wanted = {m['name']: m['unit'] for m in
              Manifest().metrics(kind, 'acoustic.shots')}
    for name, m in res['metrics'].items():
        assert m['unit'] == wanted[name]
        assert isinstance(m['value'], float)
    # the CPU has no device events: no device metric is made up
    assert 'k1_ms_per_step' not in res['metrics']
    assert 'dense_roofline' not in res['metrics']
    if trace:
        assert {'busy_s', 'window_s'} <= set(res['device'])
        assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}
        assert len(res['breakdown']['idle_gaps']) <= 10
    else:
        assert {'gpts_per_s', 'shot_s.p90', 'setup_s'} <= \
            set(res['metrics'])
    for c in res['checks'].values():
        assert set(c) == {'value', 'limit'}
    json.loads(json.dumps(res))


def test_no_card_no_result():
    """Without a card run.py exits with 2 and prints nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    p = subprocess.run([sys.executable, 'gpubench/run.py', '--workload',
                        'acoustic.shots', '--seed', '1', '--seconds', '1',
                        '--trace', '0'], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ''


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and gpubench/, a run fails
    for want of the program, and prints no result."""
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'gpubench', tmp_path / 'gpubench',
                    ignore=shutil.ignore_patterns('__pycache__', '_cache'))
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from gpubench.harness import run_cell;"
            "print(run_cell('acoustic.shots', 1, 0.1, False, time.perf_counter,"
            " device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    p = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ''
    assert 'devito_tpu_torch' in p.stderr
