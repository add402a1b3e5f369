"""The port's performance summary (devito_tpu_torch/operator/operator.py
``_estimate_flops``, ``_add_sections``) against devito_tpu: one section
per item of the step, with the reference's labels and exact ops and
points, and section times that sum to the global time."""

import numpy as np
import pytest
import torch

import devito_tpu as dj
import devito_tpu_torch as dt

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _two_equations(pkg):
    """tests/test_operator.py test_per_section_summary."""
    g = pkg.Grid(shape=(16, 16), extent=(15., 15.))
    u = pkg.TimeFunction(name='u', grid=g, space_order=2)
    v = pkg.TimeFunction(name='v', grid=g, space_order=2)
    u.data[0, 8, 8] = 1.
    op = pkg.Operator([
        pkg.Eq(u.forward, pkg.solve(pkg.Eq(u.dt, 0.5 * u.laplace),
                                    u.forward)),
        pkg.Eq(v.forward, v + u.forward)])
    return op, op.apply(time_M=4, dt=0.01)


def _with_sparse(pkg):
    """An update, an injection and an interpolation: three sections, the
    sparse ones labelled ``kind:name``."""
    g = pkg.Grid(shape=(12, 12), extent=(11., 11.))
    u = pkg.TimeFunction(name='u', grid=g, space_order=2)
    src = pkg.SparseTimeFunction(name='src', grid=g, npoint=1, nt=6,
                                 coordinates=np.array([[5.5, 5.5]]))
    rec = pkg.SparseTimeFunction(name='rec', grid=g, npoint=3, nt=6,
                                 coordinates=np.array([[2., 3.], [4.5, 6.],
                                                       [9., 9.]]))
    src.data[:] = 1.0
    op = pkg.Operator([pkg.Eq(u.forward, u + 0.1 * u.laplace)]
                      + src.inject(field=u.forward, expr=src)
                      + rec.interpolate(expr=u))
    return op, op.apply(time_M=4, dt=0.1)


@pytest.mark.parametrize('build', [_two_equations, _with_sparse])
def test_sections_match_reference(build):
    """Labels, ops, points, bytes and iteration shapes equal the
    reference's section by section: exactly in the operators' counts a
    step, and in the summaries' entries (points as GPts/s x time)."""
    opj, want = build(dj)
    opt_, got = build(dt)
    assert [sec[1:] for sec in opj._sections] == opt_._sections
    assert list(got) == list(want) and len(got) >= 2
    assert got.labels == want.labels
    for name in want:
        assert got[name].ops == want[name].ops, name
        assert got[name].oi == want[name].oi, name
        assert got[name].itershapes == want[name].itershapes, name
        assert np.isclose(got[name].gpointss * got[name].time,
                          want[name].gpointss * want[name].time,
                          rtol=1e-12), name
    total = sum(e.time for e in got.values())
    assert np.isclose(total, got.globals['fdlike'].time, rtol=1e-6)


def test_two_equation_labels():
    """The reference test's own checks, through the port."""
    _, summary = _two_equations(dt)
    assert summary.labels == {'section0': 'u', 'section1': 'v'}
    assert summary['section0'].ops > 0 and summary['section1'].ops > 0
