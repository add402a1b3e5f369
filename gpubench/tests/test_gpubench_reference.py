"""The plain references against the program under test, on the CPU at a
small size: the same inputs through both sides, the records and the last
wavefields equal to round-off in float64 and close in float32. Also the
frozen yardsticks the references share: the weights, the time step and the
damping profile."""

import numpy as np
import pytest
import torch

from gpubench import generator
from gpubench.reference import acoustic, common, tti
from gpubench.tests.helpers import SEED, tiny


def port_shot(cfg, fields, dt, pos, recpos, f0):
    """One shot through the program's public API: (record, {field: last
    level}, the solver)."""
    import devito_tpu_torch as dtt
    dtt.configuration['device'] = 'cpu'
    from gpubench.solvers import acoustic as pa, tti as pt
    prog = (pa if cfg['problem'] == 'acoustic' else pt).Program(
        cfg, fields, dt, f0, recpos)
    prog.build()
    rec = prog.shot(pos)[0]
    return rec, prog.final(), prog


@pytest.mark.parametrize('problem,dtype,tol', [
    ('acoustic', 'float64', 1e-11), ('acoustic', 'float32', 2e-4),
    ('tti', 'float64', 1e-11), ('tti', 'float32', 2e-4)])
def test_reference_matches_program(problem, dtype, tol):
    torch.set_num_threads(1)
    cfg = dict(tiny(problem), dtype=dtype)
    fields = generator.model_fields(cfg, SEED)
    dt = generator.time_step(cfg)
    nt, times = common.time_axis(cfg['t0'], cfg['tn'], dt)
    recpos = generator.receivers(cfg)
    spec = {'axes': ['uniform', 'centre'], 'depth_spacings': 1}
    pos = generator.sources(spec, cfg, SEED, 4)[2]
    rec, final, prog = port_shot(cfg, fields, dt, pos, recpos, 0.010)
    assert prog.nt == nt
    model = {k: torch.as_tensor(v) for k, v in fields.items()}
    model.update(spacing=cfg['spacing'], nbl=cfg['nbl'],
                 space_order=cfg['space_order'])
    shot = {'src': pos, 'rec': recpos,
            'wavelet': common.ricker(times, 0.010)}
    ref = acoustic if problem == 'acoustic' else tti
    rrec, rfin = ref.forward(model, shot, dt, nt,
                             dtype=getattr(torch, dtype))
    rrec = rrec.numpy()
    assert np.abs(rrec).max() > 1e-3          # the wave reached them
    assert np.abs(rec - rrec).max() <= tol * np.abs(rrec).max()
    assert set(rfin) == set(final)
    for k, want in rfin.items():
        want = want.numpy()
        assert np.abs(final[k] - want).max() <= tol * np.abs(want).max()


def test_fd_weights():
    assert np.allclose(common.fd_weights(2, [-1., 0., 1.]), [1, -2, 1])
    assert np.allclose(common.fd_weights(1, [-.5, .5]), [-1, 1])
    offs, w = common.half_point_first_derivative(6, +1)
    assert offs == [-2, -1, 0, 1, 2, 3]
    assert np.allclose(w, -w[::-1]) and abs(w.sum()) < 1e-12
    offs, w = common.second_derivative(8)
    assert offs == list(range(-4, 5))
    assert np.isclose(w[4], -205 / 72)


@pytest.mark.parametrize('problem', ['acoustic', 'tti'])
def test_time_step_and_damping_match_program(problem):
    """The frozen CFL formula gives the step the program's own model
    gives, and the reference's damping profile is the program's."""
    import devito_tpu_torch as dtt
    dtt.configuration['device'] = 'cpu'
    from devito_tpu_torch.models.seismic import SeismicModel
    cfg = tiny(problem)
    fields = generator.model_fields(cfg, SEED)
    # the preset's largest velocity, as the step assumes
    fields['vp'][..., -1] = cfg['layout']['vp_bottom']
    if 'epsilon' in fields:
        fields['epsilon'][..., -1] = 0.1 * (cfg['layout']['vp_bottom'] -
                                            cfg['layout']['vp_top'])
    params = {k: v for k, v in fields.items() if k != 'vp'}
    model = SeismicModel(origin=tuple(cfg['origin']),
                         spacing=tuple(cfg['spacing']),
                         shape=tuple(cfg['shape']),
                         space_order=cfg['space_order'], vp=fields['vp'],
                         nbl=cfg['nbl'], dtype=np.float32, bcs='damp',
                         **params)
    assert generator.time_step(cfg) == pytest.approx(
        float(model.critical_dt), rel=1e-6)
    shape = tuple(n + 2 * cfg['nbl'] for n in cfg['shape'])
    damp = common.damping_profile(shape, cfg['nbl'], cfg['spacing'])
    assert np.allclose(np.asarray(model.damp.data), damp, rtol=1e-6,
                       atol=1e-7)


def test_reference_imports_nothing_of_the_program():
    from pathlib import Path
    import ast
    here = Path(common.__file__).parent
    for path in here.glob('*.py'):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split('.')[0] in ('numpy', 'torch', 'math'), \
                    (path.name, n)
