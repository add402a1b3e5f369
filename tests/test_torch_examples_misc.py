"""devito_tpu_torch.examples userapi, compiler_tour, linalg, finance and
multichip against devito_tpu's examples: each function through both
packages at the reference tests' sizes (tests/test_userapi.py,
tests/test_misc_examples.py, tests/test_multichip_examples.py), with the
facts those tests assert held on the port's results; ``Operator.ccode``,
which stands in for devito_tpu's ``jaxpr``/``hlo``.

Stated tolerances: fp32 results within 1e-4 x max|devito_tpu's| (the
worst found is 4.2e-8, Black-Scholes), fp64 within rtol 1e-10 x max (the
worst found is 4.5e-16, the sharded diffusion); the linear-algebra
products against numpy as the reference tests hold them.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu_torch.examples import (userapi as tu, compiler_tour as tct,  # noqa: E402
                                       linalg as tl, finance as tfi,
                                       multichip as tm)
from devito_tpu_torch.exceptions import InvalidArgument  # noqa: E402
from examples import (userapi as ju, compiler_tour as jct, linalg as jl,  # noqa: E402
                      finance as jfi, multichip as jm)

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

TOL32, TOL64 = 1e-4, 1e-10


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def arrays(out):
    """The arrays of an example's result, in order: each function's data,
    each ndarray; other values are left out."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in arrays(o)]
    if isinstance(out, np.ndarray):
        return [out]
    if hasattr(out, 'data') and hasattr(out, 'grid'):
        return [np.asarray(out.data)]
    return []


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = TOL64 if want.dtype == np.float64 else TOL32
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def same_signatures(mod_t, mod_j):
    names = [n for n, f in vars(mod_j).items() if inspect.isfunction(f) and
             f.__module__ == mod_j.__name__]
    assert names
    for n in names:
        assert inspect.signature(getattr(mod_t, n)) == \
            inspect.signature(getattr(mod_j, n)), n
    assert getattr(mod_t, '__all__', None) == getattr(mod_j, '__all__', None)


# -- userapi -----------------------------------------------------------------

USERAPI = ['dsl_overview', 'apply_and_arguments', 'subdomains_demo',
           'boundary_conditions_demo', 'conditional_dimension_demo',
           'sparse_operations_demo', 'staggered_interpolation_demo']


@pytest.mark.parametrize('name', USERAPI)
def test_userapi_matches_devito_tpu(name):
    want = getattr(ju, name)()
    got = getattr(tu, name)()
    a, b = arrays(got), arrays(want)
    assert len(a) == len(b) and a
    for g, w in zip(a, b):
        close(g, w)
    if name == 'staggered_interpolation_demo':
        assert str(got[0]) == str(want[0]) and 'h_x' in str(got[0])


def test_userapi_facts():
    """tests/test_userapi.py's assertions, on the port."""
    u, w, summary = tu.apply_and_arguments()
    assert np.asarray(u.data).max() == 5. and np.asarray(w.data).max() == 10.
    assert summary.globals['fdlike'].time > 0
    f, g = tu.subdomains_demo()
    fd, gd = np.asarray(f.data), np.asarray(g.data)
    assert fd[8, 8] == 1. and fd[0, 0] == 0.
    assert gd[:8].min() == 2. and gd[8:].max() == 0.
    d = np.asarray(tu.conditional_dimension_demo().data)
    for k in range(4):
        assert np.allclose(d[k], 5 * k)
    vals, g = tu.sparse_operations_demo()
    assert np.allclose(vals, [11., 20., 0.5], atol=1e-6)
    assert np.isclose(float(np.asarray(g.data).sum()), 3., atol=1e-6)


def test_fd_evaluation_strings_are_devito_tpu_s():
    got, want = tu.fd_evaluation_demo(), ju.fd_evaluation_demo()
    assert got == want
    assert got['dx_so8'].count('f(') == 8
    assert got['dx_order2'].count('f(') == 2


def test_signatures_are_devito_tpu_s():
    for mod_t, mod_j in ((tu, ju), (tct, jct), (tl, jl), (tfi, jfi),
                         (tm, jm)):
        same_signatures(mod_t, mod_j)


# -- compiler_tour and Operator.ccode ------------------------------------------

def test_lowering_tour_matches_devito_tpu():
    ev_t, items_t = tct.lowering_tour()
    ev_j, items_j = jct.lowering_tour()
    assert ev_t == ev_j and 'h_x' in ev_t and 'h_y' in ev_t
    assert [repr(i) for i in items_t] == [repr(i) for i in items_j]
    it = items_t[0]
    assert it.kind == 'dense' and it.target.name == 'u' and \
        it.time_kind == 'stepping'


def test_introspection_tour_shows_the_cuda_unit():
    text, code = tct.introspection_tour()
    assert 'time loop' in text and 'LoweredEq(u' in text
    assert 'K1, point design (2-D region)' in code
    assert '#include "stencil.cuh"' in code
    assert 'extern "C" int dtpu_stencil_launch' in code
    assert 'DTPU_LD(g0' in code


def test_ccode_names_every_unit_and_every_decline(monkeypatch):
    """On the acoustic gradient (a K1 unit, an injection, a declined
    increment) and a forward with separable receivers: every plan's
    generated unit, point expression included, every decline's reason and
    every sparse item's path; built with no nvcc (a build raises here)."""
    from devito_tpu_torch.kernels import _nvcc
    from devito_tpu_torch.kernels.stencil import decline_reason
    from devito_tpu_torch.models.seismic import acoustic_setup

    def no_build(*a, **k):
        raise AssertionError("ccode built a kernel")
    monkeypatch.setattr(_nvcc, 'build', no_build)
    s = acoustic_setup(shape=(20, 22), spacing=(10., 10.), tn=40., nbl=4,
                       space_order=4)
    op = s.op_grad(save=True)
    code = op.ccode
    plans = op.kernel_plans
    assert any(p is None for _, p in plans)
    for eq, p in plans:
        assert repr(eq) in code
        if p is None:
            assert f"K1 declines it ({decline_reason(eq)})" in code
        else:
            assert p.source.rstrip() in code
            assert f"K1, {p.design} design ({p.design_reason})" in code
    assert 'sparse inject: scatter-add' in code
    # 1024 receivers on a tensor product: the separable contraction
    from devito_tpu_torch.models.seismic import AcquisitionGeometry
    xs, ys = np.meshgrid(np.linspace(10., 170., 32), np.linspace(10., 190.,
                                                                 32))
    rec = np.stack([xs.ravel(), ys.ravel()], 1)
    geo = AcquisitionGeometry(s.model, rec, np.array([[90., 20.]]), 0., 40.,
                              f0=0.01, src_type='Ricker')
    from devito_tpu_torch.models.seismic import AcousticWaveSolver
    s2 = AcousticWaveSolver(s.model, geo, space_order=4)
    code = s2.op_fwd(None).ccode
    assert 'sparse interp: separable' in code
    with dt.switchconfig(separable=False):
        assert 'sparse interp: gather' in s2.op_fwd(None).ccode


# -- linalg ------------------------------------------------------------------

def _mats(pkg, n=6):
    """tests/test_misc_examples.py's fp64 matrices, made in ``pkg``."""
    i, j, k, l = pkg.dimensions('i j k l')
    rng = np.random.default_rng(0)

    def mk(name, dims):
        f = pkg.Function(name=name, shape=(n,) * len(dims), dimensions=dims,
                         dtype=np.float64)
        f.data[:] = rng.standard_normal(f.data.shape)
        return f
    return mk, (i, j, k, l)


LINALG = {
    'mat_vec': (('A', 'ij'), ('x', 'j'), ('b', 'i')),
    'transpose_mat_vec': (('A', 'ij'), ('x', 'j'), ('b', 'i')),
    'mat_mat': (('A', 'ij'), ('B', 'jk'), ('C', 'ik')),
    'mat_mat_sum': (('A', 'ij'), ('B', 'jk'), ('C', 'jk'), ('D', 'ik')),
    'chain_contractions': (('A', 'ij'), ('B', 'jk'), ('C', 'jk'),
                           ('D', 'ik'), ('E', 'kl'), ('F', 'il'))}


@pytest.mark.parametrize('name', list(LINALG))
def test_linalg_matches_devito_tpu_and_numpy(name):
    outs = {}
    for pkg, mod in ((devito_tpu, jl), (dt, tl)):
        mk, dims = _mats(pkg)
        by = dict(zip('ijkl', dims))
        fs = [mk(n, tuple(by[c] for c in ds)) for n, ds in LINALG[name]]
        for f in fs[-1:] + (fs[3:4] if name == 'chain_contractions' else []):
            f.data[:] = 0.
        getattr(mod, name)(*fs)
        outs[pkg.__name__] = [np.asarray(f.data) for f in fs]
    got, want = outs['devito_tpu_torch'], outs['devito_tpu']
    for g, w in zip(got, want):
        close(g, w)
    a = got[0]
    ref = {'mat_vec': lambda: a @ got[1],
           'transpose_mat_vec': lambda: a.T @ got[1],
           'mat_mat': lambda: a @ got[1],
           'mat_mat_sum': lambda: a @ got[1] + a @ got[2],
           'chain_contractions': lambda: (a @ got[1] + a @ got[2]) @ got[4]}
    assert np.allclose(got[-1], ref[name](), rtol=1e-6)


def test_linalg_demo_matches_devito_tpu():
    """demo(): fp32 products; every Inc runs in the torch translator (K1
    declines an increment)."""
    from devito_tpu_torch.kernels import stencil as K
    d0 = K.declines
    got, want = tl.demo(), jl.demo()
    assert K.declines - d0 == 3
    for g, w in zip(arrays(got), arrays(want)):
        close(g, w)


# -- finance -----------------------------------------------------------------

def test_black_scholes_matches_devito_tpu_and_the_closed_form():
    v, s_axis, nt = tfi.black_scholes(tmax=0.5, dt0=0.002)
    vj, sj, ntj = jfi.black_scholes(tmax=0.5, dt0=0.002)
    assert nt == ntj and np.array_equal(s_axis, sj)
    close(v.data, vj.data)
    sl = slice(20, -20)
    truth = tfi.call_value_bs(s_axis[sl], 100.0, 0.5, 0.12, 0.1)
    approx = np.asarray(v.data)[nt - 1][sl]
    assert np.sqrt(np.mean((truth - approx) ** 2)) < 0.1


def test_black_scholes_runs_in_the_translator():
    """Black-Scholes' update is 1-D and reads the coordinate s: K1
    declines it, and ccode gives the reason."""
    from devito_tpu_torch.kernels.stencil import decline_reason
    s = dt.SpaceDimension(name='s', spacing=dt.Constant(name='h_s',
                                                        value=1.))
    grid = dt.Grid(shape=(11,), origin=(60.,), extent=(10,), dimensions=(s,))
    v = dt.TimeFunction(name='v', grid=grid, space_order=2, time_order=1,
                        save=5)
    t, s = v.dimensions
    op = dt.Operator(dt.Eq(v.forward, dt.solve(
        -v.dt + 0.1 * (60. + s) * v.dsc - 0.1 * v, v.forward)),
        subs=grid.spacing_map)
    (eq, plan), = op.kernel_plans
    assert plan is None and decline_reason(eq) == '1-D region'
    assert 'K1 declines it (1-D region)' in op.ccode


# -- multichip ---------------------------------------------------------------

@pytest.fixture
def eight_shards():
    with dt.switchconfig(**{'mesh-devices': 8}):
        yield


def test_sharded_diffusion_matches_serial_and_devito_tpu(eight_shards):
    u_s, grid = tm.sharded_diffusion(topology=('*', '*'))
    u_1, _ = tm.sharded_diffusion(topology=None)
    assert grid.distributor is not None
    assert np.array_equal(np.asarray(u_s.data), np.asarray(u_1.data))
    close(u_s.data, jm.sharded_diffusion(topology=('*', '*'))[0].data)


def test_topologies_match_devito_tpu(eight_shards):
    got, want = tm.topologies_demo(), jm.topologies_demo()
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert got[('*', 1)][1] == 1


def test_halo_modes_agree_to_the_bit(eight_shards):
    """The port's two modes, 'auto' and 'explicit', give the same field to
    the bit, and devito_tpu's 'explicit' within rtol 1e-10; 'gspmd' is
    refused."""
    res = tm.halo_modes_demo()
    assert sorted(res) == ['auto', 'explicit']
    assert np.array_equal(res['auto'], res['explicit'])
    want = jm.halo_modes_demo()
    close(res['explicit'], want['explicit'])
    with pytest.raises(InvalidArgument, match='SPMD'):
        with dt.switchconfig(halo='gspmd'):
            pass


def test_examples_import_only_the_port():
    """The port's examples build their problems through devito_tpu_torch
    alone: each module imports devito_tpu_torch and no other package of
    the repository."""
    import ast
    from pathlib import Path
    root = Path(tct.__file__).parent
    for path in sorted(root.glob('*.py')):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                assert m.split('.')[0] in ('numpy', 'sympy', 'math',
                                           'devito_tpu_torch'), (path, m)
