"""K1's streaming design (devito_tpu_torch/kernels/stencil.py with
csrc/stencil_stream.cuh): the plan's choice of design, its staged and
centre groups, ``stream_tile``, the launch geometry's coverage, the
generated source and the build key, on the CPU; the CUDA kernel itself
against the plain version and the point design in the ``cuda``-marked
tests, on the card, with its spills and CTAs per SM.

On the CPU ``stencil_update`` runs the plain version whatever the design;
tests/test_torch_stencil.py holds that against the TPU kernel."""

import shutil

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu_torch.ir.lowering import lower_expressions as lower_t
from devito_tpu_torch.kernels import _nvcc, stencil as K

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _dense(sched):
    return [i for i in sched.all_items if getattr(i, 'kind', '') == 'dense']


def _acoustic(pkg, shape, so, dtype=np.float32):
    g = pkg.Grid(shape=shape, extent=tuple(10. * (s - 1) for s in shape),
                 dtype=dtype)
    u = pkg.TimeFunction(name='u', grid=g, time_order=2, space_order=so)
    vp = pkg.Function(name='vp', grid=g, space_order=so)
    damp = pkg.Function(name='damp', grid=g, space_order=so)
    pde = (1 / (vp * vp)) * u.dt2 - u.laplace + damp * u.dt
    return g, pkg.Eq(u.forward, pkg.solve(pde, u.forward))


def _plan_of(eq, grid):
    # lowered as under opt='noop': CIRE would take a nested derivative
    # (u.dx.dy) apart into a temporary and an update along one axis each
    (it,) = _dense(lower_t([eq], subs=grid.spacing_map, cire=False))
    return K.plan_for(it)


def _two_staged_plan(shape, so, dtype=np.float32):
    """The plan of an acoustic-like update that also reads a second
    field, w, at the star's points: two staged groups (u[t], w), two
    centre groups."""
    g = dt.Grid(shape=shape, extent=tuple(10. * (s - 1) for s in shape),
                dtype=dtype)
    u = dt.TimeFunction(name='u', grid=g, time_order=2, space_order=so)
    w = dt.Function(name='w', grid=g, space_order=so)
    vp = dt.Function(name='vp', grid=g, space_order=so)
    pde = (1 / (vp * vp)) * u.dt2 - u.laplace - 0.5 * w.laplace
    return _plan_of(dt.Eq(u.forward, dt.solve(pde, u.forward)), g)


def _many_staged_plan(shape, so, nfields, dtype=np.float32):
    """The plan of an update that reads u[t] and ``nfields`` more fields,
    each as a whole star of its Laplacian: 1 + nfields staged groups, all
    of radius so/2."""
    g = dt.Grid(shape=shape, extent=tuple(10. * (s - 1) for s in shape),
                dtype=dtype)
    u = dt.TimeFunction(name='u', grid=g, space_order=so)
    ws = [dt.Function(name=f'w{i}', grid=g, space_order=so)
          for i in range(nfields)]
    return _plan_of(dt.Eq(u.forward, u + 0.1 * (u.laplace + sum(
        w.laplace for w in ws))), g)


def _plan(shape, so, dtype=np.float32, **kw):
    g, e = _acoustic(dt, shape, so, dtype)
    (it,) = _dense(lower_t([e], subs=g.spacing_map))
    return K.plan_for(it, **kw)


# -- the choice of design -----------------------------------------------------

@pytest.mark.parametrize('so', [2, 4, 8])
def test_acoustic_3d_streams(so):
    before = dict(K.designs)
    plan = _plan((16, 24, 32), so)
    assert plan.design == 'stream'
    assert plan.design_reason.startswith('3-D star of u, radii')
    assert K.designs['stream'] == before['stream'] + 1
    assert K.designs['point'] == before['point']


def test_2d_diffusion_stays_on_the_point_design():
    g = dt.Grid(shape=(12, 10), extent=(11., 9.))
    u = dt.TimeFunction(name='u', grid=g, space_order=4)
    plan = _plan_of(dt.Eq(u.forward, dt.solve(u.dt - 0.5 * u.laplace,
                                              u.forward)), g)
    assert (plan.design, plan.design_reason) == ('point', '2-D region')


def test_cross_derivative_stays_on_the_point_design():
    g = dt.Grid(shape=(10, 11, 12), extent=(9., 10., 11.))
    u = dt.TimeFunction(name='u', grid=g, space_order=4)
    plan = _plan_of(dt.Eq(u.forward, u + 0.1 * u.dx.dy), g)
    assert plan.design == 'point'
    assert plan.design_reason.startswith('u is read at (')
    assert plan.design_reason.endswith('off the axes')


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_over_budget_window_stays_on_the_point_design(dtype):
    # six staged groups, each a whole star of radius 6: at one point a
    # thread 6 x 13 values of queue, and rings past a CTA's shared memory
    # on every tile
    plan = _many_staged_plan((8, 9, 10), 12, 5, dtype)
    assert plan.design == 'point' and plan.tile is None
    assert plan.design_reason == \
        ('6 staged groups, radii (6, 6, 6): no tile fits two CTAs per SM '
         'and 72 queue registers')
    # two staged groups at radius 4 (2 x 4 x 9 floats of queue at the
    # first tile) fit a later tile
    two = _two_staged_plan((8, 9, 10), 8, dtype)
    size = np.dtype(dtype).itemsize
    assert two.design == 'stream' and two.tile['py'] < \
        K.STREAM_TILES[size][0][2]


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('so', [12, 16, 32])
def test_wide_star_stays_on_the_point_design(so, dtype):
    plan = _plan((8, 9, 10), so, dtype)
    r = so // 2
    if r <= K.MAX_RADIUS:
        # SO=12: radius 6, within the card tests' reach, on a tile of
        # fewer points a thread than the first
        size = np.dtype(dtype).itemsize
        assert plan.design == 'stream' and plan.radii == (r, r, r)
        assert plan.tile['py'] < K.STREAM_TILES[size][0][2]
        return
    assert plan.design == 'point' and plan.tile is None
    assert plan.design_reason == \
        (f'1 staged groups, radii ({r}, {r}, {r}): the streaming design '
         f'takes up to 6, of radius up to 6')


def test_three_staged_groups_stay_on_the_point_design():
    g = dt.Grid(shape=(8, 9, 10), extent=(7., 8., 9.))
    u = dt.TimeFunction(name='u', grid=g, space_order=2)
    v, w = (dt.Function(name=n, grid=g, space_order=2) for n in 'vw')
    plan = _plan_of(dt.Eq(u.forward, u + 0.1 * (u.laplace + v.laplace
                                                 + w.laplace)), g)
    assert plan.design == 'point'
    assert plan.design_reason == (
        '3 staged groups, radii (1, 1, 1): the streaming design takes more '
        'than 2 only at a radius of 3 or more')
    # the same three groups as radius-3 stars stream, each at its own shape
    wide = _many_staged_plan((8, 9, 10), 6, 2)
    assert wide.design == 'stream' and wide.group_radii == [(3, 3, 3)] * 3


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('so', [2, 4])
def test_two_staged_groups_stream(so, dtype):
    plan = _two_staged_plan((8, 9, 10), so, dtype)
    assert plan.design == 'stream'
    names = [plan.groups[k]['fn'].name for k in plan.staged]
    assert sorted(names) == ['u', 'w'] and plan.radii == (so // 2,) * 3
    assert f'constexpr int NS = 2;  // staged groups: {", ".join(names)}' \
        in plan.source
    assert 'q[1][' in plan.source and 'sp[1][' in plan.source


@pytest.mark.parametrize('trig', [False, True])
def test_lines_of_taps_stay_on_the_point_design(trig):
    """Groups each read along one axis (elastic's stress updates) take the
    point design unless the expression is bound by its arithmetic (TTI's
    unhoisted trig taps): then they stream on a tile of one point a
    thread."""
    from devito_tpu_torch.finite_differences.derivative import Derivative
    from devito_tpu_torch.finite_differences.elementary import sin
    g = dt.Grid(shape=(10, 11, 12), extent=(9., 10., 11.))
    x, y, _ = g.dimensions
    u = dt.TimeFunction(name='u', grid=g, space_order=4)
    v, w = (dt.Function(name=n, grid=g, space_order=4) for n in 'vw')
    f = sin if trig else (lambda e: e)
    plan = _plan_of(dt.Eq(u.forward, u + 0.1 * Derivative(
        f(v), (x, 1), fd_order=4) + 0.2 * Derivative(f(w), (y, 1),
                                                     fd_order=4)), g)
    names = sorted(plan.groups[k]['fn'].name for k in plan.staged)
    assert names == ['v', 'w']
    if not trig:
        assert plan.design == 'point'
        assert plan.design_reason == (
            "each staged group is read along one axis (v, w): the point "
            "design's caches hold a line of taps")
        return
    assert plan.design == 'stream' and plan.tile['py'] == 1
    assert sorted(plan.group_radii) == [(0, 2, 0), (2, 0, 0)]


def test_centre_only_equation_stays_on_the_point_design():
    g = dt.Grid(shape=(6, 7, 8), extent=(5., 6., 7.))
    u = dt.TimeFunction(name='u', grid=g, space_order=2)
    plan = _plan_of(dt.Eq(u.forward, 2 * u), g)
    assert (plan.design, plan.design_reason) == \
        ('point', 'no group is read off its centre')


def test_point_design_on_request():
    plan = _plan((8, 9, 10), 8, _design='point')
    assert (plan.design, plan.design_reason) == ('point', 'asked for')
    assert '#include "stencil.cuh"' in plan.source


@pytest.mark.parametrize('so', [2, 4, 8])
def test_staged_and_centre_groups(so):
    plan = _plan((16, 24, 32), so)
    name = [(g['fn'].name, str(g['toff'])) for g in plan.groups]
    assert [name[k] for k in plan.staged] == [('u', '0')]
    assert sorted(name[k] for k in plan.centre) == \
        [('damp', 'None'), ('u', '-1'), ('vp', 'None')]
    assert plan.radii == (so // 2,) * 3


def test_forward_model_streams():
    from devito_tpu_torch.models.seismic import (
        demo_model, AcquisitionGeometry, AcousticWaveSolver)
    model = demo_model('layers-isotropic', shape=(12, 12, 12),
                       spacing=(10., 10., 10.), nbl=4, space_order=8)
    geom = AcquisitionGeometry(model, np.array([[50., 50., 20.]]),
                               np.array([[50., 50., 20.]]), 0., 20.,
                               f0=0.010, src_type='Ricker')
    op = AcousticWaveSolver(model, geom, space_order=8).op_fwd(None)
    (eq, plan), = op.kernel_plans
    assert plan.design == 'stream' and plan.radii == (4, 4, 4)
    assert {plan.groups[k]['fn'].name for k in plan.centre} == \
        {'vp', 'damp', 'u'}


# -- stream_tile --------------------------------------------------------------

@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('so', [2, 4, 8])
def test_stream_tile(so, dtype):
    size = np.dtype(dtype).itemsize
    r = so // 2
    t = K.stream_tile(dtype, (r, r, r), 1, 3)
    by, bz = t['box']
    assert by == t['ty'] + 2 * r and bz >= t['tz'] + 2 * r
    assert t['box_row_bytes'] == bz * size and bz * size % 16 == 0
    assert t['pitch'] == bz
    slot = -(-by * bz * size // 128) * 128
    nslot = r + t['stages']
    # three centre tiles a stage, each (TY, TZ + 16 bytes)
    ctile = -(-t['ty'] * (t['tz'] + 16 // size) * size // 128) * 128
    assert t['smem_bytes'] == 128 + -(-8 * nslot // 128) * 128 + \
        nslot * slot + t['stages'] * 3 * ctile
    assert t['smem_bytes'] <= K.BLOCK_SMEM
    assert t['ctas_per_sm'] >= 2
    assert t['ctas_per_sm'] * (t['smem_bytes'] + K.CTA_RESERVED) <= K.SM_SMEM
    assert t['threads'] == t['tz'] * t['ty'] // t['py']
    assert t['threads'] % 32 == 0 and t['ty'] % t['py'] == 0
    assert t['queue_regs'] == t['py'] * (2 * r + 1) * size // 4 <= \
        K.QUEUE_REGS


def test_stream_tile_rounds_the_box_row_to_16_bytes():
    # SO=2 fp32: 64 + 2 floats, and up to 3 more for a start on a 16-byte
    # boundary: 69 floats = 276 B, rounded to 72 floats
    t = K.stream_tile(np.float32, (1, 1, 1))
    assert t['box'] == (18, 72) and t['box_row_bytes'] == 288
    t = K.stream_tile(np.float64, (1, 1, 1))
    assert t['box'] == (10, 68) and t['box_row_bytes'] == 544


def test_stream_tile_centre_tiles_take_shared_memory():
    tile = (16, 64, 4, 2, 64)
    a = K.stream_tile(np.float32, (4, 4, 4), 1, 0, tile)
    b = K.stream_tile(np.float32, (4, 4, 4), 1, 3, tile)
    # 2 stages x 3 groups x a (16, 64 + 4) box
    assert b['smem_bytes'] - a['smem_bytes'] == 2 * 3 * 16 * 68 * 4


def test_stream_tile_declines_what_does_not_fit():
    assert K.stream_tile(np.float32, (16, 16, 16)) is None
    # rx = 18 in fp64: even one point's queue, 37 doubles, passes
    # QUEUE_REGS
    assert K.stream_tile(np.float64, (18, 4, 4)) is None
    assert K.stream_tile(np.float32, (4, 4, 4), 1, 0,
                         (16, 64, 4, 40, 64)) is None


# -- each staged group at its own tap shape -----------------------------------

#: TTI's widest CIRE temporary at SO=12 (cire3): u[t] at radius 6, CIRE's
#: cire1 at radius 3, and the four hoisted trig fields, each along its own
#: axes at radius 3 (r0 along z, r1 along x, r2 along x and y, r3 along y).
CIRE3_RADII = [(6, 6, 6), (3, 3, 3), (0, 0, 3), (3, 0, 0), (3, 3, 0),
               (0, 3, 0)]


def _header_layout(size, groups, ncentre, tile):
    """The shared memory and queue registers of csrc/stencil_stream.cuh's
    StreamTile for ``groups`` (per group (rx, ry, rz)), written out group
    by group as the header lays them out: the barriers (one a stage slot of
    the widest group's ring), each group's ring of rx + STAGES planes of
    (TY + 2ry) x (TZ + 2rz + 16 B - 1, rounded to 16 B), each rounded to
    128 B, then the centre tiles."""
    ty, tz, py, stages, _ = tile
    al = 16 // size
    rx = max(g[0] for g in groups)
    ring = 0
    for gx, gy, gz in groups:
        bz = -(-(tz + 2 * gz + al - 1) // al) * al
        ring += (gx + stages) * -(-(ty + 2 * gy) * bz * size // 128) * 128
    bars = -(-8 * (rx + stages) // 128) * 128
    ctile = -(-ty * (tz + al) * size // 128) * 128
    qregs = py * sum(2 * g[0] + 1 for g in groups) * size // 4
    return 128 + bars + ring + stages * ncentre * ctile, qregs


@pytest.mark.parametrize('groups,ncentre', [
    (CIRE3_RADII, 0), (CIRE3_RADII[1:], 0),
    ([(2, 0, 0), (0, 2, 0), (0, 0, 2)], 1), ([(0, 0, 2), (0, 2, 0)], 0),
    ([(4, 4, 4), (4, 0, 0), (0, 4, 0), (0, 0, 4)], 4)])
def test_stream_tile_lays_out_each_group_at_its_own_shape(groups, ncentre):
    t = K.stream_tile(np.float32, groups, ncentre=ncentre)
    assert t is not None
    tile = (t['ty'], t['tz'], t['py'], t['stages'], t['tx'])
    assert tile in K.STREAM_TILES[4]
    assert (t['smem_bytes'], t['queue_regs']) == \
        _header_layout(4, groups, ncentre, tile)
    al = 4
    for (gx, gy, gz), (by, bz), pz, n, q, lag in zip(
            groups, t['boxes'], t['pitches'], t['slots'], t['queues'],
            t['lags']):
        assert by == t['ty'] + 2 * gy and pz == bz
        assert bz == -(-(t['tz'] + 2 * gz + al - 1) // al) * al
        assert (n, q) == (gx + t['stages'], 2 * gx + 1)
        assert lag == 2 * (max(g[0] for g in groups) - gx)
    # the union's box is the widest group's, whatever the others'
    union = tuple(max(g[d] for g in groups) for d in range(3))
    assert t['box'] == (t['ty'] + 2 * union[1],
                        -(-(t['tz'] + 2 * union[2] + al - 1) // al) * al)
    # every earlier tile of the list does not fit
    for earlier in K.STREAM_TILES[4][:K.STREAM_TILES[4].index(tile)]:
        assert K.stream_tile(np.float32, groups, ncentre=ncentre,
                             tile=earlier) is None


def test_stream_tile_of_equal_groups_is_the_union_layout():
    """Groups all of one shape lay out as the union's: a list of equal
    radii and (radii, nstaged) give one answer."""
    for r, n, c in [((4, 4, 4), 1, 3), ((2, 2, 2), 2, 2), ((1, 1, 1), 2, 0)]:
        assert K.stream_tile(np.float32, [r] * n, ncentre=c) == \
            K.stream_tile(np.float32, r, n, c)


def test_cire3_layout_fits_only_at_its_own_shapes():
    """At the union's shape (six groups of radius 6) no tile fits; staged
    each at its own shape, TTI's widest temporary fits two CTAs an SM."""
    assert K.stream_tile(np.float32, (6, 6, 6), 6) is None
    t = K.stream_tile(np.float32, CIRE3_RADII)
    assert t is not None and t['ctas_per_sm'] >= 2
    assert t['queue_regs'] <= K.QUEUE_REGS
    assert t['slots'] == [r[0] + t['stages'] for r in CIRE3_RADII]


def _tti_plans(shape=(24, 22, 26), so=12, dtype=np.float32):
    """(kind, lowered eq, plan) of every dense item of the centred TTI
    forward at ``so`` with hoist-trig-taps True, as 'auto' picks at the
    canonical size."""
    from devito_tpu_torch.models.seismic import tti_setup
    s = tti_setup(shape=shape, spacing=(20.,) * 3, tn=10., space_order=so,
                  nbl=4, dtype=dtype,
                  opt=('advanced', {'hoist-trig-taps': True}))
    op = s.op_fwd(None)
    plans = {id(eq): p for eq, p in op.kernel_plans}
    out = {}
    for sec in ('prologue', 'body'):
        for it in getattr(op.schedule, sec):
            if hasattr(it, 'region'):
                out[it.target.name] = (it, plans[id(it)])
    return out


def test_generated_source_prints_each_groups_pitch():
    (eq, plan) = _tti_plans()['cire3']
    src = plan.source
    assert plan.design == 'stream' and len(plan.staged) == 6
    assert 'using Radii = dtpu::Radii<' + ', '.join(
        str(v) for r in plan.group_radii for v in r) + '>;' in src
    for s, pz in enumerate(plan.tile['pitches']):
        assert f'constexpr int PZ{s} = Tile::pz({s});' in src
    assert f"static_assert(Tile::SMEM == {plan.tile['smem_bytes']}," in src
    body = src.split('return', 1)[1].split(';', 1)[0]
    names = [plan.groups[k]['fn'].name for k in plan.staged]
    radii = dict(zip(names, plan.group_radii))
    for s, name in enumerate(names):
        rx, ry, rz = radii[name]
        # y taps at the group's own pitch; x taps centred on its own reach
        assert (f'* PZ{s}]' in body) == (ry > 0), name
        assert all(f'q[{s}][{i}]' not in body for i in range(2 * rx + 1,
                                                            13)), name
        assert f'q[{s}][{rx}]' in body or f'sp[{s}][' in body, name
    assert ' * PZ]' not in body
    assert K.point_flops(plan) == K.point_flops(
        K.plan_for(eq, _design='point')) == 139


def test_acoustic_plan_is_todays():
    """A single staged group's own shape is the union's: the acoustic
    SO=8 plan keeps its tile, its groups, its radii and its layout."""
    plan = _plan((16, 24, 32), 8)
    t = plan.tile
    assert (len(plan.staged), len(plan.centre)) == (1, 3)
    assert plan.radii == (4, 4, 4) and plan.group_radii == [(4, 4, 4)]
    assert (t['ty'], t['tz'], t['py'], t['stages'], t['tx']) == \
        (16, 64, 4, 3, 32)
    # the layout of the design before per-group shapes: a (24, 76) box,
    # 7 slots, three centre tiles a stage
    assert t['box'] == (24, 76) and t['slots'] == [7]
    assert t['smem_bytes'] == 128 + 128 + 7 * 7296 + 3 * 3 * 4352
    assert (t['queue_regs'], t['ctas_per_sm'], t['lags']) == (36, 2, [0])
    assert 'dtpu::StreamTile<T, NS, NC, 4, 4, 4, 16, 64, 4, 3, Radii>' in \
        plan.source


# -- launch geometry ----------------------------------------------------------

def _writes(n, t):
    """Per axis (x, y, z), how many times the kernel's launch geometry
    writes each index of a region of extents ``n`` -- the grid, block and
    loops of csrc/stencil_stream.cuh ``stream_launch`` and
    ``stream_kernel``, masks included -- and the total count of writes."""
    nx, ny, nz = n
    tx, ty, tz, py = t['tx'], t['ty'], t['tz'], t['py']
    grid = (-(-nz // tz), -(-ny // ty), -(-nx // tx))
    cx = np.zeros(nx, int)
    for bz in range(grid[2]):
        x0 = bz * tx
        cx[x0:x0 + min(tx, nx - x0)] += 1
    cy = np.zeros(ny, int)
    for by in range(grid[1]):
        for thy in range(ty // py):
            for k in range(py):
                y = by * ty + thy * py + k
                if y < ny:
                    cy[y] += 1
    cz = np.zeros(nz, int)
    for bx in range(grid[0]):
        for lz in range(tz):
            z = bx * tz + lz
            if z < nz:
                cz[z] += 1
    return cx, cy, cz, int(cx.sum()) * int(cy.sum()) * int(cz.sum())


@pytest.mark.parametrize('shape', [(16, 24, 32), (61, 77, 93),
                                   (532, 532, 532), (100, 40, 50)])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_launch_geometry_covers_each_point_once(shape, dtype):
    t = K.stream_tile(dtype, (4, 4, 4), 1, 3)
    cx, cy, cz, total = _writes(shape, t)
    assert (cx == 1).all() and (cy == 1).all() and (cz == 1).all()
    assert total == int(np.prod(shape))
    if np.prod(shape) < 10 ** 6:
        # the whole count, point by point
        count = np.einsum('i,j,k->ijk', cx, cy, cz)
        assert count.shape == shape and (count == 1).all()


# -- generated source and build key -------------------------------------------

def test_generated_stream_source():
    plan = _plan((8, 9, 10), 8)
    src = plan.source
    assert '#include "stencil_stream.cuh"' in src
    # the point expression's struct, and so the kernel and its launch
    # template, have internal linkage: two equations' libraries loaded in
    # one process keep their own kernels and their own local statics; it
    # is named after the equation's target, so a device trace says which
    # equation ran
    assert 'namespace {\nstruct Point_u {' in src
    assert 'constexpr int NS = 1;  // staged groups: u' in src
    assert 'constexpr int NC = 3;  // centre groups: ' in src
    assert 'using Radii = dtpu::Radii<4, 4, 4>;' in src
    assert 'dtpu::StreamTile<T, NS, NC, 4, 4, 4, 16, 64, 4, 3, Radii>' in src
    body = src.split('return', 1)[1].split(';', 1)[0]
    # x taps: the register queue; y and z taps: the plane in shared memory
    for i in range(9):
        assert f'q[0][{i}]' in body
    for d in (-4, -3, -2, -1, 1, 2, 3, 4):
        assert f'sp[0][{d} * PZ0]' in body and f'sp[0][{d}]' in body
    # centre groups: values the kernel loaded from global memory for the
    # point (here from their tiles, which TMA brought with the plane)
    assert {'cv[0]', 'cv[1]', 'cv[2]'} <= set(
        __import__('re').findall(r'cv\[\d\]', body))
    assert 'DTPU_LD' not in body and 'g[' not in body
    assert K.point_flops(plan) == K.point_flops(
        K.plan_for(plan.eq, _design='point')) == 76


def test_generated_stream_source_fp64():
    plan = _plan((8, 9, 10), 4, np.float64)
    assert 'using T = double;' in plan.source
    assert 'dtpu::StreamTile<T, NS, NC, 2, 2, 2, 8, 64, 2, 2, Radii>' in \
        plan.source


def test_build_key_hashes_every_included_header(tmp_path, monkeypatch):
    plan = _plan((8, 9, 10), 8)
    point = K.plan_for(plan.eq, _design='point')
    assert _nvcc.headers(plan.source) == ['stencil_stream.cuh', 'tma.cuh']
    assert _nvcc.headers(point.source) == ['stencil.cuh']
    assert plan.key == _nvcc.unit_key(plan.source) != point.key
    csrc = tmp_path / 'csrc'
    shutil.copytree(_nvcc._CSRC, csrc)
    monkeypatch.setattr(_nvcc, '_CSRC', csrc)
    assert _nvcc.unit_key(plan.source) == plan.key
    for header in ('tma.cuh', 'stencil_stream.cuh'):
        f = csrc / header
        old = f.read_text()
        f.write_text(old + '\n// edited\n')
        assert _nvcc.unit_key(plan.source) != plan.key, header
        f.write_text(old)
    (csrc / 'stencil.cuh').write_text('// edited\n')
    assert _nvcc.unit_key(plan.source) == plan.key


def test_build_compiles_a_key_once_across_threads(monkeypatch):
    """Sweep tiles that differ only in the x-chunk share one source and
    key, and chip_smoke.py builds them from a thread pool: one compile."""
    import sys
    import threading
    import time
    calls = []

    def slow_compile(key, stem, source):
        calls.append(key)
        time.sleep(0.05)
        return object()

    monkeypatch.setattr(_nvcc, '_compile', slow_compile)
    monkeypatch.setattr(_nvcc, '_libs', {})
    monkeypatch.setattr(_nvcc, '_locks', {})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = []
        threads = [threading.Thread(target=lambda k=k: got.append(
            _nvcc.build('k%d' % (k % 2), 'stencil', '')))
            for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(calls) == ['k0', 'k1'] and len(got) == 32
    assert len({id(g) for g in got}) == 2


def test_fixed_units_hash_nested_headers():
    # the streaming design's unit includes stencil_stream.cuh, which
    # includes tma.cuh: the build key hashes both
    g, e = _acoustic(dt, (10, 11, 12), 4)
    plan = _plan_of(e, g)
    assert _nvcc.headers(plan.source) == ['stencil_stream.cuh', 'tma.cuh']
    tma = (_nvcc._CSRC / 'tma.cuh').read_text()
    assert _nvcc.unit_key(plan.source) == _nvcc.source_key(
        (_nvcc._CSRC / 'stencil_stream.cuh').read_text(), tma, plan.source)
    # K10's and K13/K14's units include the ring they share, which
    # includes cp_async.cuh and tma.cuh
    for unit in ('probe7_copy', 'probe7_stream'):
        src = (_nvcc._CSRC / f'{unit}.cu').read_text()
        assert _nvcc.headers(src) == ['probe7_ring.cuh', 'cp_async.cuh',
                                      'tma.cuh']


# -- the operator ------------------------------------------------------------

def test_operator_records_the_design():
    g, e = _acoustic(dt, (10, 11, 12), 4)
    op = dt.Operator(e, subs=g.spacing_map)
    (_, plan), = op.kernel_plans
    assert plan.design == 'stream'


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")


def _rows(plan, gen):
    tdt = torch.from_numpy(np.empty(0, plan.dtype)).dtype
    ins = []
    for g in plan.groups:
        shape = g['fn']._allocated_space()
        r = torch.randn(shape, generator=gen, device='cuda', dtype=tdt)
        if g['fn'].name == 'vp':
            r = 1.5 + r.abs()
        elif g['fn'].name == 'damp':
            r = 0.01 * r.abs()
        ins.append(r)
    out = torch.randn(plan.eq.target._allocated_space(), generator=gen,
                      device='cuda', dtype=tdt)
    return out, ins


def _built_clean(plan):
    """``plan``'s streaming kernel builds without spills (when ptxas ran
    in this process) and the CUDA runtime fits two or more of its CTAs on
    an SM, registers included."""
    K.build(plan)
    log = K.build_log.get(plan.key)
    if log is not None:
        assert ' 0 bytes spill stores' in log and \
            ' 0 bytes spill loads' in log, log
    assert K.stream_occupancy(plan) >= 2


def _three_ways(plan, seed=0):
    """One update of ``plan`` through its kernel, the point design's
    kernel and the plain version, on the same seeded inputs; each writes
    the whole row it was given (a copy of one random row)."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    out, ins = _rows(plan, gen)
    point = K.plan_for(plan.eq, _design='point')
    got, pnt, ref = out.clone(), out.clone(), out.clone()
    params = {n: 0.7 for n in plan.param_names}
    K.stencil_update(plan, (got, ins), params)
    K.stencil_update(point, (pnt, ins), params)
    K.stencil_update_reference(plan, (ref, ins), params)
    torch.cuda.synchronize()
    return got, pnt, ref


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('so', [2, 4, 8])
@pytest.mark.parametrize('shape', [(128, 128, 128), (61, 77, 93),
                                   (100, 40, 50)])
def test_stream_kernel_on_card(shape, so, dtype):
    _card()
    with dt.switchconfig(device='cuda'):
        plan = _plan(shape, so, dtype)
    assert plan.design == 'stream'
    if shape == (100, 40, 50):
        assert shape[0] % plan.tile['tx']      # a short last x-chunk
    before = dict(K.launches_by_design)
    got, pnt, ref = _three_ways(plan)
    assert K.launches_by_design == {'stream': before['stream'] + 1,
                                    'point': before['point'] + 1}
    tol = TOL[dtype] * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol
    assert (got - pnt).abs().max().item() <= tol
    # outside the region the row is untouched
    inside = torch.zeros_like(got, dtype=torch.bool)
    inside[tuple(slice(o, o + n) for o, n in
                 zip(plan.origins[0], plan.extents))] = True
    assert torch.equal(got[~inside], ref[~inside])
    _built_clean(plan)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('so', [2, 4])
@pytest.mark.parametrize('shape', [(61, 77, 93), (100, 40, 50)])
def test_two_staged_groups_on_card(shape, so, dtype):
    _card()
    with dt.switchconfig(device='cuda'):
        plan = _two_staged_plan(shape, so, dtype)
    assert plan.design == 'stream' and len(plan.staged) == 2
    got, pnt, ref = _three_ways(plan, seed=2)
    tol = TOL[dtype] * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol
    assert (got - pnt).abs().max().item() <= tol
    _built_clean(plan)


@pytest.mark.cuda
@pytest.mark.parametrize('tile', [(16, 64, 2, 2, 32), (16, 64, 4, 2, 48),
                                  (8, 32, 2, 2, 16)])
def test_stream_kernel_tiles_on_card(tile):
    _card()
    with dt.switchconfig(device='cuda'):
        plan = _plan((61, 77, 93), 8, _tile=tile)
    assert plan.design == 'stream'
    got, pnt, ref = _three_ways(plan, seed=1)
    tol = TOL[np.float32] * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol
    assert (got - pnt).abs().max().item() <= tol
    _built_clean(plan)


@pytest.mark.cuda
def test_operator_launches_the_stream_kernel_on_card():
    _card()
    with dt.switchconfig(device='cuda'):
        g, e = _acoustic(dt, (40, 50, 60), 8)
        op = dt.Operator(e, subs=g.spacing_map)
        before = dict(K.launches_by_design)
        op.apply(time_M=5, dt=0.1)
    assert K.launches_by_design == {'stream': before['stream'] + 5,
                                    'point': before['point']}


@pytest.mark.cuda
def test_libraries_of_one_tile_keep_their_own_kernels_on_card():
    """Two equations whose kernels instantiate the same template (same
    dtype, radii and tile; their libraries differ only in the expression
    and the comment): each launch runs its own kernel, and each library
    sets its own kernel's shared-memory limit (above 48 KB here)."""
    _card()
    plans = []
    with dt.switchconfig(device='cuda'):
        for shape in [(40, 50, 60), (33, 45, 70)]:
            g = dt.Grid(shape=shape,
                        extent=tuple(10. * (s - 1) for s in shape))
            u = dt.TimeFunction(name='u', grid=g, time_order=2,
                                space_order=8)
            vp = dt.Function(name='vp', grid=g, space_order=8)
            damp = dt.Function(name='damp', grid=g, space_order=8)
            scale = 1 if shape[0] == 40 else 3
            pde = (1 / (vp * vp)) * u.dt2 - scale * u.laplace + damp * u.dt
            plans.append(_plan_of(dt.Eq(u.forward, dt.solve(pde, u.forward)),
                                  g))
    assert plans[0].tile == plans[1].tile and plans[0].key != plans[1].key
    assert plans[0].tile['smem_bytes'] > 48 * 1024
    for k, plan in enumerate(plans):
        got, pnt, ref = _three_ways(plan, seed=k)
        tol = TOL[np.float32] * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= tol


def _tiles_for(plan, count=2):
    """The first ``count`` tiles of STREAM_TILES, then of smaller x-chunks,
    that ``plan``'s equation fits."""
    size = plan.dtype.itemsize
    cands = list(K.STREAM_TILES[size]) + [t[:4] + (16,)
                                          for t in K.STREAM_TILES[size]]
    fits = [t for t in cands if K.stream_tile(
        plan.dtype, plan.group_radii, ncentre=len(plan.centre),
        tile=t) is not None]
    return fits[:count]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('unit', ['cire2', 'cire3'])
@pytest.mark.parametrize('shape', [(61, 37, 45), (40, 70, 29)])
def test_cire_stars_on_card(shape, unit, dtype):
    """TTI's CIRE temporaries of several staged groups at their own
    shapes (SO=12, hoist-trig-taps True), on ragged extents, through the
    streaming kernel on two or more tiles, against the plain version and
    the point design on the same seeded rows; no spills, two or more CTAs
    an SM."""
    _card()
    with dt.switchconfig(device='cuda'):
        eq, plan = _tti_plans(shape, dtype=dtype)[unit]
        tiles = _tiles_for(K.plan_for(eq, _tile=(8, 32, 1, 2, 16))
                           if plan.design != 'stream' else plan)
        assert len(tiles) >= 2
        plans = [K.plan_for(eq, _tile=t) for t in tiles]
    for k, p in enumerate(plans):
        assert p.design == 'stream' and len(p.group_radii) >= 5
        got, pnt, ref = _three_ways(p, seed=k)
        tol = TOL[dtype] * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= tol
        assert (got - pnt).abs().max().item() <= tol
        _built_clean(p)


@pytest.mark.cuda
def test_tti_forward_streams_and_matches_the_plain_version_on_card():
    """The centred TTI forward at 96^3 SO=12 fp32 with hoist-trig-taps
    True: cire2 and cire3 launch the streaming design each step, and the
    shot record matches the plain version's on the CPU to 1e-4 of its
    largest value (the tolerance of the TTI forward on the card since
    it was ported)."""
    _card()
    from devito_tpu_torch.models.seismic import tti_setup

    def shot(device):
        with dt.switchconfig(device=device):
            s = tti_setup(shape=(96, 96, 96), spacing=(20.,) * 3, tn=60.,
                          space_order=12, nbl=10, dtype=np.float32,
                          opt=('advanced', {'hoist-trig-taps': True}))
            before = dict(K.launches_by_design)
            rec = np.array(s.forward()[0].data)
            plans = {eq.target.name: p
                     for eq, p in s.op_fwd(None).kernel_plans}
            steps = s.geometry.nt - 2
        return rec, plans, before, steps

    rec, plans, before, steps = shot('cuda')
    assert {n for n, p in plans.items() if p.design == 'stream'} == \
        {'cire2', 'cire3'}
    assert K.launches_by_design['stream'] - before['stream'] == \
        2 * plans['cire3'].launches
    assert plans['cire3'].launches == plans['cire2'].launches >= steps
    want = shot('cpu')[0]
    assert np.abs(want).max() > 0
    assert np.abs(rec - want).max() <= 1e-4 * np.abs(want).max()
