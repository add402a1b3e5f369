"""Spatial apply bounds through devito_tpu_torch: ``x_m``/``x_M``, the
bare-dimension shorthand ``x=3`` (an explicit ``x_M`` wins over it) and
the typed error on a non-integer bound.

The cases of tests/test_args.py:67-132 and of tests/test_arguments_port.py
(``test_override_function_size``, ``test_override_function_subrange``,
``test_override_timefunction_subrange``), each run through both packages,
built separately, with the written data equal to the bit. Besides: a
bounded 3-D acoustic update and a bounded 2-D TTI forward (CIRE's
halo-extended temporaries keep their extension around the clamp) against
devito_tpu in fp64 (1e-12 x max), and K1's plans of a bounded runner: the
same units (build keys) as the whole domain's, with the clamped extents
as launch arguments, built once a set of bounds.
"""

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

PKGS = [dj, dt]


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def both(fn):
    """``fn(pkg)`` for devito_tpu, then the port; the two results."""
    return [fn(pkg) for pkg in PKGS]


def test_spatial_bounds_override():
    """x_m/x_M restrict the iteration region; the same operator runs the
    whole domain afterwards (a runner a set of bounds)."""
    def run(pkg):
        g = pkg.Grid(shape=(10, 10))
        f = pkg.Function(name='fsb', grid=g)
        pkg.Operator(pkg.Eq(f, 1)).apply(x_m=2, x_M=5, y_m=1, y_M=8)
        d = np.array(f.data)
        u = pkg.TimeFunction(name='usb', grid=g)
        op = pkg.Operator(pkg.Eq(u.forward, u + 1))
        op.apply(time_M=2, dt=1., x_m=3, x_M=6)
        rows = np.array(u.data)[0].copy()
        op.apply(time_M=2, dt=1.)
        return d, rows, np.array(u.data)
    (dj_, rj, fj), (d, rows, full) = both(run)
    assert d.sum() == 32.0 and d[2:6, 1:9].min() == 1.0 and d[0].sum() == 0
    assert rows.sum(axis=1)[3] == 20. and rows.sum(axis=1)[0] == 0.
    assert full[0].sum() > 200.
    for a, b in ((d, dj_), (rows, rj), (full, fj)):
        assert np.array_equal(a, b)


def test_bare_dim_with_explicit_bound():
    def run(pkg):
        g = pkg.Grid(shape=(10, 10))
        f = pkg.Function(name='fbd', grid=g)
        pkg.Operator(pkg.Eq(f, 1)).apply(x=3, x_M=5)
        return np.array(f.data)
    dj_, d = both(run)
    assert d[:6].sum() == 60.0 and d[6:].sum() == 0.0
    assert np.array_equal(d, dj_)


@pytest.mark.parametrize('bad', ['dim', 'text'])
def test_bare_dim_non_integer_raises(bad):
    for pkg in PKGS:
        g = pkg.Grid(shape=(10, 10))
        f = pkg.Function(name='fni', grid=g)
        op = pkg.Operator(pkg.Eq(f, 1))
        val = g.dimensions[0] if bad == 'dim' else 'three'
        with pytest.raises(pkg.InvalidArgument, match="integer scalar"):
            op.apply(x=val)


def test_override_function_size():
    def run(pkg):
        grid = pkg.Grid(shape=(5, 6, 7))
        g = pkg.Function(name='g', grid=grid)
        pkg.Operator(pkg.Eq(g, 1.))(x=3, y=4, z=5)
        return np.array(g.data)
    dj_, d = both(run)
    assert (d[4:] == 0.).all() and (d[:, 5:] == 0.).all()
    assert (d[:, :, 6:] == 0.).all() and (d[:4, :5, :6] == 1.).all()
    assert np.array_equal(d, dj_)


def test_override_function_subrange():
    def run(pkg):
        grid = pkg.Grid(shape=(5, 6, 7))
        g = pkg.Function(name='g', grid=grid)
        pkg.Operator(pkg.Eq(g, 1.))(x_m=1, x_M=3, y_m=2, y_M=4, z_m=3,
                                    z_M=5)
        return np.array(g.data)
    dj_, d = both(run)
    mask = np.ones((5, 6, 7), dtype=bool)
    mask[1:4, 2:5, 3:6] = False
    assert (d[mask] == 0.).all() and (d[1:4, 2:5, 3:6] == 1.).all()
    assert np.array_equal(d, dj_)


def test_override_timefunction_subrange():
    def run(pkg):
        grid = pkg.Grid(shape=(5, 6, 7))
        f = pkg.TimeFunction(name='f', grid=grid, time_order=0, save=5)
        pkg.Operator(pkg.Eq(f, 1.), opt='noop')(
            x_m=1, x_M=3, y_m=2, y_M=4, z_m=3, z_M=5, time_m=1, time_M=4)
        return np.array(f.data)
    dj_, d = both(run)
    mask = np.ones(d.shape, dtype=bool)
    mask[1:5, 1:4, 2:5, 3:6] = False
    assert (d[mask] == 0.).all() and (d[1:5, 1:4, 2:5, 3:6] == 1.).all()
    assert np.array_equal(d, dj_)


def _acoustic(pkg, n=(14, 15, 16), so=8):
    grid = pkg.Grid(shape=n, extent=tuple(10. * (s - 1) for s in n),
                    dtype=np.float64)
    u = pkg.TimeFunction(name='u', grid=grid, time_order=2, space_order=so)
    vp = pkg.Function(name='vp', grid=grid, space_order=so)
    rng = np.random.default_rng(11)
    vp.data[:] = 1.5 + rng.random(n)
    u.data[:2] = rng.standard_normal((2,) + n)
    pde = (1 / (vp * vp)) * u.dt2 - u.laplace
    op = pkg.Operator(pkg.Eq(u.forward, pkg.solve(pde, u.forward)),
                      subs=grid.spacing_map)
    return op, u


def close(got, want, tol=1e-12):
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_bounded_acoustic_against_devito_tpu():
    """An interior box of a 3-D SO=8 update, given as x_m/x_M, y_m/y_M,
    z_m/z_M: the box against devito_tpu's, the points outside untouched."""
    bounds = dict(x_m=3, x_M=9, y_m=2, y_M=11, z_m=4, z_M=12)
    out = []
    for pkg in PKGS:
        op, u = _acoustic(pkg)
        before = np.array(u.data)
        op.apply(time_m=1, time_M=3, dt=1.5, **bounds)
        out.append((before, np.array(u.data)))
    (_, j), (b1, t) = out
    close(t, j)
    box = (slice(3, 10), slice(2, 12), slice(4, 13))
    outside = np.ones(t.shape[1:], bool)
    outside[box] = False
    # steps 1..3 write every row of the buffer, each inside the box only
    assert np.array_equal(t[:, outside], b1[:, outside])
    assert all(not np.array_equal(t[r][box], b1[r][box]) for r in range(3))


def test_bounded_plans_reuse_the_units():
    """A bounded runner's K1 plans have the whole domain's build keys and
    the box's extents; a second apply with the same bounds reuses the
    runner."""
    op, u = _acoustic(dt)
    op.apply(time_m=1, time_M=1, dt=1.5, x_m=3, x_M=9, z=12)
    (key, runner), = op._bounded_cache.items()
    (eq, plan), = runner.plans
    (_, whole), = op.kernel_plans
    assert plan.key == whole.key and plan.design == whole.design
    assert plan.extents == (7, 15, 13) and whole.extents == (14, 15, 16)
    op.apply(time_m=1, time_M=1, dt=1.5, x_m=3, x_M=9, z=12)
    assert list(op._bounded_cache.values()) == [runner]


def test_bounded_tti_keeps_the_halo_extension():
    """A 2-D TTI forward (CIRE temporaries computed into the halo) on an
    x-box: the temporaries' regions stay extended around the clamp, and
    the wavefields equal devito_tpu's (1e-12 x max)."""
    from devito_tpu.models import seismic as sj
    from devito_tpu_torch.models import seismic as st
    out = []
    for seis in (sj, st):
        s = seis.tti_setup(shape=(30, 35), spacing=(15., 15.), tn=60.,
                           space_order=4, nbl=6, dtype=np.float64)
        op = s.op_fwd(None)
        rec, u, v, _ = s.forward(x_m=8, x_M=30)
        out.append((np.array(u.data), np.array(v.data), op))
    (uj, vj, _), (ut, vt, op) = out
    close(ut, uj)
    close(vt, vj)
    (_, runner), = op._bounded_cache.items()
    ext = [eq.region[0] for eq, _ in runner.plans if eq.region[0][0] < 8]
    assert ext and all(a < 8 for a, _ in ext)
