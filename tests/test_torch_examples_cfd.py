"""devito_tpu_torch.examples.cfd against devito_tpu's examples/cfd.py: each
CFD example through both packages at tests/test_cfd.py's and
tests/test_misc_examples.py's sizes, with the facts those tests assert
held on the port's fields.

Stated tolerance: every example here runs in fp32; every field within
1e-4 x max|devito_tpu's| (the worst found is 4.7e-6, diffusion's 200
steps: the two packages sum the taps in another order).
"""

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu_torch.examples import cfd as tc
from examples import cfd as jc

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

TOL32 = 1e-4


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def fields(out):
    return [np.asarray(f.data) for f in (out if isinstance(out, tuple)
                                         else (out,))]


def held(got, want, tol=TOL32):
    """The port's fields against devito_tpu's, within tol x max|want|."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


#: (example, its arguments): the reference tests' sizes.
CASES = [('linear_convection', dict(nx=41, ny=41, nt=40)),
         ('diffusion', dict(nx=41, ny=41, nt=200)),
         ('burgers', dict(nx=41, ny=41, nt=100)),
         ('poisson', dict(nx=30, ny=30, niter=500)),
         ('nonlinear_convection', dict(nt=40)),
         ('laplace', dict(niter=400)),
         ('cavity_flow', dict(nx=21, ny=21, nt=200)),
         ('shallow_water', dict(nx=51, ny=51, nt=100)),
         ('darcy_flow', dict(n=32, niter=800))]


@pytest.mark.parametrize('name, kw', CASES, ids=[c[0] for c in CASES])
def test_example_matches_devito_tpu(name, kw):
    want = fields(getattr(jc, name)(**kw))
    got = fields(getattr(tc, name)(**kw))
    held(got, want)


def test_signatures_and_defaults_are_devito_tpu_s():
    import inspect
    names = [n for n, f in vars(jc).items() if inspect.isfunction(f) and
             f.__module__ == jc.__name__]
    assert len(names) == 9
    for n in names:
        assert inspect.signature(getattr(tc, n)) == \
            inspect.signature(getattr(jc, n))


def test_convection_and_diffusion_facts():
    """tests/test_cfd.py's assertions, on the port."""
    d = np.asarray(tc.linear_convection(nx=41, ny=41, nt=40).data)
    assert 1.9 < d.max() <= 2.01
    i, j = np.unravel_index(d[0].argmax(), d[0].shape)
    assert i > 18 and j > 18
    d = np.asarray(tc.diffusion(nx=41, ny=41, nt=200).data[0])
    assert 1.0 < d.max() < 2.0
    p, _ = tc.poisson(nx=30, ny=30, niter=500)
    d = np.asarray(p.data)
    assert np.abs(d[0] - d[1]).max() < 2e-4
    assert d[0].max() > 0 and d[0].min() < 0


def test_boundary_rows_facts():
    """tests/test_misc_examples.py's assertions on the examples with
    boundary rows, on the port."""
    d = np.asarray(tc.nonlinear_convection(nt=40)[0].data)[0]
    assert np.allclose(d[0, :], 1.) and np.allclose(d[:, 0], 1.)
    assert d.max() > 1.5
    d = np.asarray(tc.laplace(niter=400).data)
    assert np.allclose(d[0, 1:], 0., atol=1e-6)
    assert np.allclose(d[-1, 1:-1], np.linspace(0, 1, d.shape[1])[1:-1],
                       atol=1e-6)
    du = np.asarray(tc.cavity_flow(nx=21, ny=21, nt=200)[0].data)[0]
    assert np.allclose(du[:, -1], 1.) and du.min() < -1e-3
    assert np.abs(du[:, :-1]).max() < 1.
    d = np.asarray(tc.darcy_flow(n=32, niter=800)[0].data)[0]
    assert np.allclose(d[0, :], 0.) and d.max() > 1e-4


def test_updates_run_on_k1_point_design():
    """Every interior update of a CFD example is a 2-D equation, planned
    for K1's point design; laplace's boundary rows that read another row
    by an absolute index, or bc_right along y alone, run in the
    translator, and its 400 applies reuse the plans of its one build."""
    from devito_tpu_torch.kernels import stencil as K
    before = dict(K.designs)
    declines = K.declines
    tc.burgers(nx=21, ny=21, nt=3)
    assert K.designs['point'] - before['point'] == 2
    assert K.designs['stream'] == before['stream']
    assert K.declines == declines
    before = dict(K.designs)
    tc.laplace(nx=11, ny=11, niter=5)
    # the stencil and p[0, y] = 0; three rows declined, once
    assert K.designs['point'] - before['point'] == 2
    assert K.declines - declines == 3
