"""The benchmark's elastic survey (``elastic.shots``) on the CPU at a small
size: the program through ``gpubench/solvers/elastic.py`` against the
plain reference (``gpubench/reference/elastic.py``), the frozen time step
and the mask profile against the program's own, and the check's control
and planted faults coming out not correct under the cell's own limits.

The small configuration (``gpubench/tests/configs/elastic-tiny.json``)
puts the source two grid points above the water-solid interface, so the
shear terms (mu, its harmonic means) are held, not only the water's; the
check's probe shot, below the interface, holds them at every size."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from gpubench import generator
from gpubench.manifest import Manifest
from gpubench.reference import common, elastic as ref
from gpubench.tests.helpers import SEED, tiny

dt.configuration['device'] = 'cpu'

ROOT = Path(__file__).resolve().parents[1]
SHEAR = ('tau_xy', 'tau_xz', 'tau_yz')


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _inputs(dtype):
    cfg = dict(tiny('elastic'), dtype=dtype)
    fields = generator.model_fields(cfg, SEED)
    step = generator.time_step(cfg)
    nt, times = common.time_axis(cfg['t0'], cfg['tn'], step)
    recpos = generator.receivers(cfg)
    spec = Manifest.traffic('shots')['sources']
    pos = generator.sources(spec, cfg, SEED, 4)[2]
    return cfg, fields, step, nt, times, recpos, pos


def _program(cfg, fields, step, recpos):
    from gpubench.solvers.elastic import Program
    prog = Program(cfg, fields, step, 0.010, recpos)
    prog.build()
    return prog


@pytest.mark.parametrize('dtype,tol', [('float64', 1e-11),
                                       ('float32', 2e-4)])
def test_program_matches_reference(dtype, tol):
    torch.set_num_threads(1)
    cfg, fields, step, nt, times, recpos, pos = _inputs(dtype)
    prog = _program(cfg, fields, step, recpos)
    rec, _, steps = prog.shot(pos)
    final = prog.final()
    assert prog.nt == nt and steps == nt - 1
    model = {k: torch.as_tensor(v) for k, v in fields.items()}
    model.update(spacing=cfg['spacing'], nbl=cfg['nbl'],
                 space_order=cfg['space_order'])
    shot = {'src': pos, 'rec': recpos,
            'wavelet': common.ricker(times, 0.010)}
    rrec, rfin = ref.forward(model, shot, step, nt,
                             dtype=getattr(torch, dtype))
    rrec = rrec.numpy()
    assert rec.shape == rrec.shape == (2, nt, len(recpos))
    for k in range(2):                  # rec1 (tau_zz), rec2 (div v)
        want = np.abs(rrec[k]).max()
        assert want > 1e-4              # the wave reached the receivers
        assert np.abs(rec[k] - rrec[k]).max() <= tol * want
    probe = [f'probe.{k}' for k in ref.COMPONENTS]
    assert set(rfin) == set(final) == {*ref.COMPONENTS, *probe}
    for k, want in rfin.items():        # each on its own scale
        want = want.numpy()
        assert np.abs(final[k] - want).max() <= tol * np.abs(want).max()
    # the shear stresses, zero in the water, carry a share of the wave
    for prefix in ('', 'probe.'):
        normal = np.abs(rfin[prefix + 'tau_zz'].numpy()).max()
        for k in SHEAR:
            assert np.abs(rfin[prefix + k].numpy()).max() > 1e-2 * normal


@pytest.mark.parametrize('config', ['tiny', 'elastic-so4-512'])
def test_probe_lies_below_the_water(config):
    """The probe's source lies in the solid, at the centre of the small
    grid, and of the cell's own depth axis (on a narrow copy of its grid:
    the probe reads the centre column alone)."""
    cfg = tiny('elastic')
    if config != 'tiny':
        cfg = dict(Manifest().config(config), shape=[9, 7, 512])
    vp = generator.model_fields(cfg, SEED)['vp']
    (x, y, z), = ref.probe(vp, cfg['spacing'])
    h = cfg['spacing']
    k = int(round(z / h[2]))
    assert z == k * h[2]
    col = vp[vp.shape[0] // 2, vp.shape[1] // 2]
    first = k - ref.PROBE_BELOW         # the first solid point
    assert col[first] >= ref.WATER_VP > col[:first].max()
    vs, _ = ref.parameters(vp.copy())
    assert vs[vp.shape[0] // 2, vp.shape[1] // 2, k] > 0
    assert x == pytest.approx((vp.shape[0] - 1) * h[0] / 2)
    assert y == pytest.approx((vp.shape[1] - 1) * h[1] / 2)


def test_records_weigh_rec2():
    """rec2 is weighed so that the stacked record's largest value is about
    each record's own, in numpy and in torch alike."""
    rec1, rec2 = np.full((3, 2), 0.18), np.full((3, 2), 0.0077)
    got = ref.records(rec1, rec2)
    assert got.shape == (2, 3, 2)
    assert got[1].max() == pytest.approx(ref.REC2_WEIGHT * 0.0077)
    assert 0.9 < got[1].max() / got[0].max() < 1.1
    tgot = ref.records(torch.as_tensor(rec1), torch.as_tensor(rec2))
    assert np.array_equal(tgot.numpy(), got)


def test_parameters_follow_the_preset():
    vp = np.array([1.5, 1.5, 2.4, 3.5], dtype=np.float32)
    vs, b = ref.parameters(vp.copy())
    assert vs.dtype == b.dtype == np.float32
    assert np.allclose(vs, [0., 0., 1.2, 1.75], rtol=1e-7, atol=0)
    assert b[0] == b[1] == 1.0
    assert b[3] == pytest.approx(1 / (0.31 * 3500 ** 0.25), rel=1e-6)
    # the same numbers from a tensor, so both sides of the check agree
    tvs, tb = ref.parameters(torch.as_tensor(vp))
    assert np.allclose(tvs.numpy(), vs) and np.allclose(tb.numpy(), b)


def test_time_step_and_mask_match_program():
    """The frozen step lies below the elastic solver's own CFL bound at
    the preset's largest velocity, the program runs at the frozen step,
    and the reference's mask is the program's damping field."""
    cfg, fields, step, _, _, recpos, _ = _inputs('float32')
    fields['vp'][..., -1] = cfg['layout']['vp_bottom']
    prog = _program(cfg, fields, step, recpos)
    assert float(prog.solver.dt) == pytest.approx(step, rel=1e-7)
    from devito_tpu_torch.models.seismic import SeismicModel
    vs, b = ref.parameters(fields['vp'].copy())
    own = SeismicModel(origin=tuple(cfg['origin']),
                       spacing=tuple(cfg['spacing']),
                       shape=tuple(cfg['shape']),
                       space_order=cfg['space_order'], vp=fields['vp'],
                       vs=vs, b=b, nbl=cfg['nbl'], bcs='mask')
    assert step < float(own.critical_dt)
    shape = tuple(n + 2 * cfg['nbl'] for n in cfg['shape'])
    mask = 1.0 - common.damping_profile(shape, cfg['nbl'], cfg['spacing'])
    assert np.allclose(np.asarray(prog.model.damp.data), mask, rtol=1e-6,
                       atol=1e-7)


FAULTS = sorted(Manifest.driver(Manifest.traffic('shots')).FAULTS)

#: the harness's runs, in a process of their own: its guard refuses a run
#: in a process that has loaded JAX, as this test session has
HARNESS_RUNS = """
import json, sys, torch
sys.path.insert(0, '.')
torch.set_num_threads(1)
from gpubench.tests.helpers import run
cases = {'sound': {}, 'control': {'control': True}}
cases.update({f: {'fault': f} for f in %r})
out = {}
for name, kw in cases.items():
    res = run('elastic', seconds=0.1, **kw)
    out[name] = {'correct': res['correct'], 'checks': res['checks']}
print(json.dumps(out))
"""


@pytest.fixture(scope='module')
def harness_runs():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    p = subprocess.run([sys.executable, '-c', HARNESS_RUNS % FAULTS],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_sound_run_is_correct(harness_runs):
    res = harness_runs['sound']
    assert res['correct'] is True, res['checks']
    assert set(res['checks']) == {'rec_err', 'wave_err'}


@pytest.mark.parametrize('case', FAULTS + ['control'])
def test_control_and_faults_are_not_correct(harness_runs, case):
    res = harness_runs[case]
    assert res['correct'] is False
    assert any(c['value'] is None or c['value'] > c['limit']
               for c in res['checks'].values())


def test_reference_imports_nothing_of_the_program():
    path = Path(ref.__file__)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split('.')[0] in ('numpy', 'torch', 'math'), n
