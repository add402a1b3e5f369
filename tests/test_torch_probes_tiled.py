"""K3 (devito_tpu_torch/experiments/stencil_probe.py), K4 (stencil_probe2),
K5 (stencil_probe3), K6 (stencil_probe4) and K7 (stencil_probe5) against
the TPU kernels they port, which run here in Pallas interpret mode; and
the rows, frames and tiles with which K4, K5, K6 and K7 launch K1's
streaming engine, and K4's x-halo rows and the split of its and K5's step
into frame, edge rows and interior through plain functions.

The JAX scripts read their sizes from the environment when they are
imported, so each test sets them with ``monkeypatch.setenv`` and imports
the script anew. Every ``pallas_call`` is built with ``interpret=True``
(``stencil_probe.py`` passes none), in JAX's 32-bit mode, which the
probes were written for. Inputs come from numpy's generator and go to
both packages; whole arrays are compared, after 1 and 3 steps of each
loop. On the CPU the port's wrappers run their kernels' plain PyTorch
versions; the CUDA kernels are held against those versions by the
``cuda``-marked tests, on the card. Tolerances are 1e-5 * max|reference|:
fp32 sums taken in another order."""

import importlib
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devito_tpu_torch.exceptions import DevitoTpuError
from devito_tpu_torch.experiments import stencil_probe as P1
from devito_tpu_torch.experiments import stencil_probe2 as P2
from devito_tpu_torch.experiments import stencil_probe3 as P3
from devito_tpu_torch.experiments import stencil_probe4 as P4
from devito_tpu_torch.experiments import stencil_probe5 as P5

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
H = 4


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pallas_call`` made while the test runs is built with
    ``interpret=True``, in JAX's default 32-bit mode (importing
    devito_tpu turns on 64-bit mode)."""
    import jax
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def wrap(*args, **kwargs):
        kwargs['interpret'] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, 'pallas_call', wrap)
    with jax.enable_x64(False):
        yield


@pytest.fixture
def jax_probe(monkeypatch):
    """``load(name, **sizes)`` imports ``experiments.{name}`` anew with
    MODE=cpu and the sizes in its environment."""
    loaded = []

    def load(name, **sizes):
        monkeypatch.setenv('MODE', 'cpu')
        monkeypatch.setenv('JAX_PLATFORMS', 'cpu')
        for k, v in sizes.items():
            monkeypatch.setenv(k, str(v))
        mod = f'experiments.{name}'
        sys.modules.pop(mod, None)
        loaded.append(mod)
        return importlib.import_module(mod)

    yield load
    for mod in loaded:
        sys.modules.pop(mod, None)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device('cuda', 0)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err, tol = np.abs(got - ref).max(), TOL * np.abs(ref).max()
    assert err <= tol, (err, tol)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_loop(step, up, uc, nsteps):
    """(up, uc) -> (uc, step(up, uc)) ``nsteps`` times, in JAX."""
    for _ in range(nsteps):
        up, uc = uc, step(up, uc)
    return up, uc


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# -- K3 ------------------------------------------------------------------------

def _k3_inputs(N, seed):
    rng = np.random.default_rng(seed)
    NP = N + 2 * H
    return (_normal(rng, (NP,) * 3), _normal(rng, (NP,) * 3),
            (0.1 + 0.1 * rng.random((N,) * 3)).astype(np.float32),
            (0.05 * rng.random((N,) * 3)).astype(np.float32))


@pytest.mark.parametrize('N,TX,TY', [(16, 8, 8), (24, 8, 12), (32, 16, 8)])
def test_halo_tiles_step_matches_pallas_kernel(N, TX, TY, jax_probe,
                                               interpret):
    jp = jax_probe('stencil_probe', N=N, TX=TX, TY=TY)
    step = jp.make_pallas_step()
    up, uc, m, damp = _k3_inputs(N, N + TX)
    ref = np.asarray(step(*_j(up, uc, m, damp)))
    before = P1.launches
    got = P1.halo_tiles_step(*_t(up, uc, m, damp), TX, TY)
    _close(got.numpy(), ref)
    for nsteps in (1, 3):
        mj, dj = _j(m, damp)
        want = _jax_loop(lambda a, b: a.at[H:-H, H:-H, H:-H].set(
            step(a, b, mj, dj)), *_j(up, uc), nsteps)
        got = P1.run_pallas(*_t(up, uc, m, damp), nsteps, TX, TY)
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    assert P1.launches == before


def test_halo_tiles_run_xla_matches_jax(jax_probe, interpret):
    jp = jax_probe('stencil_probe', N=16, TX=8, TY=8)
    up, uc, m, damp = _k3_inputs(16, 3)
    want = jp.run_xla(*_j(up, uc, m, damp), 3)
    got = P1.run_xla(*_t(up, uc, m, damp), 3)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_halo_tiles_step_writes_into_a_view():
    up, uc, m, damp = _t(*_k3_inputs(8, 1))
    want = P1.halo_tiles_step_reference(up, uc, m, damp)
    kept = up.clone()
    view = up[H:-H, H:-H, H:-H]
    assert P1.halo_tiles_step(up, uc, m, damp, 8, 8, out=view) is view
    assert torch.equal(up[H:-H, H:-H, H:-H], want)
    up[H:-H, H:-H, H:-H] = kept[H:-H, H:-H, H:-H]
    assert torch.equal(up, kept)               # only the interior written


def _alloc_case(case):
    up = torch.zeros((16,) * 3)
    return {'new tensor': up,
            'interior view': up[H:-H, H:-H, H:-H],
            'x-slab view': up[2:6],
            'transposed view': up[H:-H, H:-H, H:-H].transpose(0, 1),
            'z-strided view': up[:, :, ::2],
            'column view': up[:, 3:5, 1:2]}[case]


@pytest.mark.parametrize('case,want', [
    ('new tensor', ((16, 16, 16), (0, 0, 0))),
    ('interior view', ((16, 16, 16), (4, 4, 4))),
    ('x-slab view', ((16, 16, 16), (2, 0, 0))),
    ('column view', ((16, 16, 16), (0, 3, 1))),
    ('transposed view', None),
    ('z-strided view', None)])
def test_stream_allocation_of_a_target(case, want):
    """K3's target helper: the allocation a view lies in, from its strides
    and storage offset; views whose strides are not a contiguous
    allocation's raise."""
    from devito_tpu_torch.experiments._stream import allocation
    t = _alloc_case(case)
    if want is None:
        with pytest.raises(ValueError, match='not a box of a contiguous'):
            allocation(t)
        return
    base, dims, org = allocation(t)
    assert base == t.untyped_storage().data_ptr() and (dims, org) == want
    # the view's first element, through the allocation's extents
    flat = t.untyped_storage().nbytes() // 4
    assert ((org[0] * dims[1] + org[1]) * dims[2] + org[2]) * 4 \
        == t.data_ptr() - base and dims[0] * dims[1] * dims[2] == flat


@pytest.mark.parametrize('in_place', [False, True])
def test_halo_tiles_rows(in_place):
    """K3's rows for the streaming engine: out at its first element (up's
    interior: (4, 4, 4) of up's allocation), uc staged and up at (4, 4, 4),
    m and damp at 0."""
    up, uc, m, damp = _t(*_k3_inputs(12, 5))
    out = up[H:-H, H:-H, H:-H] if in_place else torch.empty_like(m)
    ptrs, dims, org = P1._rows(up, uc, m, damp, out)
    assert list(ptrs) == [out.untyped_storage().data_ptr()] + [
        t.data_ptr() for t in (uc, up, m, damp)]
    assert list(dims) == [20 if in_place else 12] * 3 + [20] * 6 + [12] * 6
    assert list(org) == [4 if in_place else 0] * 3 + [4] * 6 + [0] * 6


@pytest.mark.parametrize('case', ['N % 4', 'unaligned', 'staged box',
                                  'centre box'])
def test_stream_rows_refuse_what_tma_cannot_read(case):
    """The engine's rows: N % 4 != 0 gives z rows of part of a 16-byte unit;
    a tensor 4 bytes into its storage is not 16-byte aligned; a staged
    group's first box (origin - 4) and a centre group's box must start on
    a 16-byte boundary in z (K3's start at z = 0, K9's at z = 4)."""
    from devito_tpu_torch.experiments import _stream as S
    up, uc, m, damp = _t(*_k3_inputs(12, 5))
    if case == 'N % 4':
        up, uc, m, damp = _t(*_k3_inputs(10, 5))
        call = lambda: P1._rows(up, uc, m, damp, torch.empty_like(m))  # noqa
    elif case == 'unaligned':
        uc = torch.zeros(20 ** 3 + 1)[1:].view(20, 20, 20)
        call = lambda: P1._rows(up, uc, m, damp, torch.empty_like(m))  # noqa
    elif case == 'staged box':
        call = lambda: S.rows('k', (m, (0, 0, 0)), [(uc, (4, 4, 5))], [])  # noqa
    else:
        call = lambda: S.rows('k', (m, (0, 0, 0)), [(uc, (4, 4, 4))],  # noqa
                              [(up, (4, 4, 6))])
    with pytest.raises(ValueError, match='16-byte'):
        call()
    # the origins the two probes use pass
    up, uc, m, _ = _t(*_k3_inputs(12, 5))
    S.rows('k', (m, (0, 0, 0)), [(uc, (4, 4, 4))], [(up, (4, 4, 4))])
    S.rows('k', (m, (0, 0, 0)), [(uc, (4, 4, 8))], [(up, (4, 4, 8))])


def test_halo_tiles_tile_fits_two_ctas_per_sm():
    """K3's unit is compiled for _stream.TILE (K1's fp32 tile), which
    stream_tile fits at two or more CTAs an SM for one staged and three
    centre groups of radius 4."""
    from devito_tpu_torch.experiments import _stream as S
    src = (Path(__file__).resolve().parent.parent
           / 'devito_tpu_torch/csrc/probe_halo_stream.cu').read_text()
    tile = tuple(map(int, re.search(
        r'StreamTile<float, 1, 3, R, R, R, (\d+), (\d+), (\d+), (\d+)>',
        src).groups()))
    from devito_tpu_torch.kernels.stencil import stream_tile
    fit = stream_tile(np.float32, S.RADII, 1, 3, S.TILE + (S.X_CHUNK,))
    assert tile == S.TILE and fit['ctas_per_sm'] >= 2
    assert fit['smem_bytes'] == 90496 and fit['box'] == (24, 76)


# -- K4 ------------------------------------------------------------------------

def _nb_inputs(N, seed):
    """(up, uc, mfull) over the (NP, NP, ZP) layout: normal everywhere,
    halo and pad included, so that every tap the x-halo rule picks shows."""
    NP = N + 2 * H
    shape = (NP, NP, -(-NP // 128) * 128)
    rng = np.random.default_rng(seed)
    return (_normal(rng, shape), _normal(rng, shape),
            (0.1 + 0.1 * rng.random(shape)).astype(np.float32))


@pytest.mark.parametrize('N,T', [(16, 4), (16, 6), (16, 8), (16, 12),
                                 (16, 24), (24, 8), (24, 16)])
def test_neighbour_blocks_step_matches_pallas_kernel(N, T, jax_probe,
                                                     interpret):
    """K4 over the whole array, its x-halo rows included, for several T."""
    jp = jax_probe('stencil_probe2', N=N, T=T)
    step = jp.make_pallas_step()
    up, uc, mf = _nb_inputs(N, N * T)
    ref = np.asarray(step(*_j(up, uc, mf)))
    before = P2.launches
    got = P2.neighbour_blocks_step(*_t(up, uc, mf), T)
    _close(got.numpy(), ref)
    rows = np.r_[0:H, H + N:N + 2 * H]
    assert np.abs(ref[rows]).max() > 0          # x-halo rows computed
    for nsteps in (1, 3):
        mj = jnp.asarray(mf)
        want = _jax_loop(lambda a, b: step(a, b, mj), *_j(up, uc), nsteps)
        u0, u1, mt = _t(up, uc, mf)
        got = P2.run_C(u0, u1, mt, nsteps, T)
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    assert P2.launches == before


def test_neighbour_block_rows_follow_the_clamped_rule():
    NP, T = 24, 8
    rows = [r.tolist() for r in P2.x_sources(NP, T, 'cpu')]
    k = {d: rows[d + H] for d in range(-H, H + 1)}
    assert k[-1][0] == 7 and k[-4][3] == 7 and k[-4][4] == 0  # tile 0 wraps
    assert k[1][23] == 16 and k[4][20] == 16 and k[3][20] == 23  # last tile
    assert k[-4][8] == 4 and k[4][15] == 19                   # middle: r + k


def test_neighbour_blocks_variants_match_jax(jax_probe, interpret):
    N = 16
    jp = jax_probe('stencil_probe2', N=N, T=8)
    up, uc, mf = _nb_inputs(N, 5)
    m, damp = np.full((N,) * 3, 0.2, np.float32), np.zeros((N,) * 3,
                                                           np.float32)
    mask = np.zeros_like(mf)
    mask[H:H + N, H:H + N, H:H + N] = 1.0
    want = jp.run_A(*_j(up, uc, m, damp), 3)
    got = P2.run_A(*_t(up, uc, m, damp), 3)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    want = jp.run_B(*_j(up, uc, mf, mask), 3)
    got = P2.run_B(*_t(up, uc, mf, mask), 3)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


# -- K5 ------------------------------------------------------------------------

@pytest.mark.parametrize('N,T', [(16, 4), (16, 8), (16, 12), (24, 8),
                                 (24, 16)])
def test_neighbour_blocks_zeroed_step_matches_pallas_kernel(N, T, jax_probe,
                                                            interpret):
    jp = jax_probe('stencil_probe3', N=N, T=T)
    run_E = jp.make_pallas_step()
    up, uc, mf = _nb_inputs(N, N * T + 1)
    before = P3.launches
    for nsteps in (1, 3):
        want = run_E(*_j(up, uc, mf), nsteps)
        got = P3.run_E(*_t(up, uc, mf), nsteps, T)
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    out = P3.neighbour_blocks_zeroed_step(*_t(up, uc, mf), T).numpy()
    assert not out[:H].any() and not out[H + N:].any()
    assert P3.launches == before


def test_neighbour_blocks_zeroed_variants_match_jax(jax_probe, interpret):
    N = 16
    jp = jax_probe('stencil_probe3', N=N, T=8)
    up, uc, _ = _nb_inputs(N, 7)
    m = np.full((N,) * 3, 0.2, np.float32)
    want = jp.run_A(*_j(up, uc, m), 3)
    got = P3.run_A(*_t(up, uc, m), 3)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    want = jp.make_conv_step()(*_j(up, uc, m), 3)
    got = P3.run_D(*_t(up, uc, m), 3)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


# -- K4 and K5 on K1's streaming engine -----------------------------------------

def _nb_case(N, seed, into):
    """K4's and K5's inputs at N, and their out: a new NaN-filled tensor
    (``into`` 'new') or up itself ('up')."""
    up, uc, mf = _t(*_nb_inputs(N, seed))
    out = up if into == 'up' else torch.full_like(up, float('nan'))
    return up, uc, mf, out


@pytest.mark.parametrize('into', ['new', 'up'])
@pytest.mark.parametrize('zeroed', [False, True])
def test_neighbour_blocks_rows(zeroed, into):
    """K4's and K5's rows for the streaming engine: out, uc staged, up and
    mfull, each a whole (NP, NP, ZP) allocation at (4, 4, 4); out may be up
    itself."""
    up, uc, mf, out = _nb_case(12, 5, into)
    ptrs, dims, org = P2.nb_rows('k', up, uc, mf, out)
    assert list(ptrs) == [out.data_ptr(), uc.data_ptr(), up.data_ptr(),
                          mf.data_ptr()]
    assert (ptrs[0] == ptrs[2]) == (into == 'up')
    assert list(dims) == [20, 20, 128] * 4 and list(org) == [4, 4, 4] * 4


@pytest.mark.parametrize('into', ['new', 'up'])
@pytest.mark.parametrize('zeroed', [False, True])
@pytest.mark.parametrize('N', [12, 16, 20])
def test_neighbour_blocks_frame_matches_the_plain_zeros(N, zeroed, into):
    """K4's and K5's 12 frame parameters, as the kernel gets them: the whole
    array less the interior columns (K4) or the interior (K5). Into a new
    tensor, the frame and the region the plain version writes (with K4's
    x-halo rows) cover exactly its zeros and its update; into up, the
    frame's points are never read, so up with NaN there gives the step
    into a new tensor."""
    up, uc, mf, out = _nb_case(N, N, into)
    NP, T = N + 2 * H, 4
    params = P2.nb_frame(out, zeroed)
    lo = 0 if not zeroed else H
    assert list(params) == [0, 0, 0, NP, NP, 128,
                            lo, H, H, NP - 2 * lo, N, N]
    frame = _frame_mask(out.shape, params)
    region = _box_mask(out.shape, (lo, H, H), (NP - 2 * lo, N, N))
    assert not (frame & region).any() and (frame | region).all()
    ref = P2.nb_reference(up, uc, mf, T, zeroed)
    if into == 'new':
        P2.nb_reference(up, uc, mf, T, zeroed, out)
        assert torch.equal(out == 0, frame) and torch.equal(out, ref)
        return
    up[frame] = float('nan')
    assert torch.equal(P2.nb_reference(up, uc, mf, T, zeroed, out=up), ref)


@pytest.mark.parametrize('N,T', [(20, 4), (28, 9), (40, 8), (16, 24)])
def test_edge_rows_reference_matches_nb_reference(N, T):
    """The edge-row kernel's plain version gives K4's x-halo rows 0-3 and
    NP-4..NP-1 over the interior columns, and writes nothing else; T = NP
    (one tile, both wraps in it) included."""
    up, uc, mf, out = _nb_case(N, N + T, 'new')
    want = P2.neighbour_blocks_step_reference(up, uc, mf, T)
    assert P2.edge_rows_reference(up, uc, mf, T, out) is out
    c = slice(H, H + N)
    for rows in (slice(0, H), slice(N + H, None)):
        _close(out[rows, c, c].numpy(), want[rows, c, c].numpy())
        out[rows, c, c] = float('nan')
    assert out.isnan().all()


@pytest.mark.parametrize('into', ['new', 'up'])
@pytest.mark.parametrize('zeroed', [False, True])
@pytest.mark.parametrize('N,T', [(20, 4), (28, 9), (40, 8)])
def test_neighbour_blocks_split_matches_nb_reference(N, T, zeroed, into):
    """The card's split through plain functions: the frame's zeros, K4's
    edge rows and the engine's update of the interior, in the card's
    order, into a NaN-filled tensor or into up, give K4's and K5's plain
    step over the whole array."""
    up, uc, mf, out = _nb_case(N, 2 * N + T, into)
    want = P2.nb_reference(up, uc, mf, T, zeroed)
    from devito_tpu_torch.experiments._tiled import frame_reference
    frame_reference(out, P2.nb_frame(out, zeroed))
    if not zeroed:
        P2.edge_rows_reference(up, uc, mf, T, out)
    P2.interior_reference(up, uc, mf, out)
    assert not out.isnan().any()
    _close(out.numpy(), want.numpy())


# -- K6 ------------------------------------------------------------------------

def _tiles_inputs(N, seed):
    NP = N + 2 * H
    ZA = -(-NP // 128) * 128
    rng = np.random.default_rng(seed)
    return (_normal(rng, (NP, NP, ZA)), _normal(rng, (NP, NP, ZA)),
            (0.1 + 0.1 * rng.random((N, N, ZA))).astype(np.float32))


@pytest.mark.parametrize('N,TX,TY', [(16, 8, 8), (32, 16, 32), (48, 16, 16)])
def test_tiles_step_matches_pallas_kernel(N, TX, TY, jax_probe, interpret):
    """K6 over the whole field: the x/y halo keeps up's values, the z halo
    and pad of the interior columns are zeroed."""
    jp = jax_probe('stencil_probe4', N=N, TX=TX, TY=TY)
    step, run_E = jp.make_v3_step(), jp.make_run_E()
    u0, u1, m_i = _tiles_inputs(N, N + TX + TY)
    ref = np.asarray(step(*_j(u1, u0[H:H + N, H:H + N], m_i)))
    before = P4.launches
    got = P4.tiles_step(*_t(u1, u0[H:H + N, H:H + N], m_i), TX, TY)
    _close(got.numpy(), ref)
    for nsteps in (1, 3):
        want = run_E(*_j(u0, u1, m_i), nsteps)
        got = P4.run_E(*_t(u0, u1, m_i), nsteps, TX, TY)
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    assert P4.launches == before


def test_tiles_step_in_place_keeps_the_halo():
    u0, u1, m_i = _t(*_tiles_inputs(8, 2))
    kept = u0.clone()
    up_i = u0[H:-H, H:-H, :]
    assert P4.tiles_step(u1, up_i, m_i, 8, 8, out=up_i) is up_i
    u0[H:-H, H:-H, :] = kept[H:-H, H:-H, :]
    assert torch.equal(u0, kept)


def test_tiles_run_A_matches_jax(jax_probe, interpret):
    N = 16
    jp = jax_probe('stencil_probe4', N=N, TX=8, TY=8)
    u0, u1, _ = _tiles_inputs(N, 4)
    m = np.full((N,) * 3, 0.2, np.float32)
    want = jp.run_A(*_j(u0, u1, m), 3)
    got = P4.run_A(*_t(u0, u1, m), 3)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


# -- K7 ------------------------------------------------------------------------

def _xtiles_inputs(N, seed, halo=True):
    """(u0, u1, m_pad) over the (XP, NP, ZA) layout: normal everywhere, or
    (``halo`` False) only on the interior, as the JAX script's own."""
    NP = N + 2 * H
    shape = (N + 4 * H, NP, -(-NP // 128) * 128)
    rng = np.random.default_rng(seed)
    arrs = [_normal(rng, shape), _normal(rng, shape),
            (0.1 + 0.1 * rng.random(shape)).astype(np.float32)]
    if not halo:
        inner = (slice(2 * H, 2 * H + N), slice(H, H + N), slice(H, H + N))
        for a in arrs:
            keep = a[inner].copy()
            a[:] = 0.0
            a[inner] = keep
    return arrs


@pytest.mark.parametrize('N,TX', [(16, 4), (16, 8), (48, 8)])
def test_xtiles_step_matches_pallas_kernel(N, TX, jax_probe, interpret):
    jp = jax_probe('stencil_probe5', N=N, TX=TX)
    step, run_E = jp.make_v4_step(), jp.make_run_E()
    u0, u1, mp = _xtiles_inputs(N, N + TX)
    ref = np.asarray(step(*_j(u1, u0, mp)))
    before = P5.launches
    got = P5.xtiles_step(*_t(u1, u0, mp), TX)
    _close(got.numpy(), ref)
    for nsteps in (1, 3):
        want = run_E(*_j(u0, u1, mp), nsteps)
        got = P5.run_E(*_t(u0, u1, mp), nsteps, TX)
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    assert P5.launches == before


def test_xtiles_reference_fault_at_tx_32(jax_probe, interpret):
    """At N=48, TX=32 the JAX kernel differs from its own variant A on the
    interior rows of its first and last x-tiles; the port matches A."""
    N, TX, X0 = 48, 32, 2 * H
    jp = jax_probe('stencil_probe5', N=N, TX=TX)
    u0, u1, mp = _xtiles_inputs(N, 11, halo=False)
    m = mp[X0:X0 + N, H:H + N, H:H + N].copy()
    a = np.asarray(jp.run_A(*_j(u0, u1, m), 1)[1])
    e = np.asarray(jp.make_run_E()(*_j(u0, u1, mp), 1)[1])
    bad = np.abs(e - a).max(axis=(1, 2)) > TOL * np.abs(a).max()
    assert bad[X0:X0 + N].all()                 # every interior row wrong
    assert not bad[:X0].any() and not bad[X0 + N:].any()
    for nsteps in (1, 3):
        want = P5.run_A(*_t(u0, u1, m), nsteps)
        got = P5.run_E(*_t(u0, u1, mp), nsteps, TX)
        for g, w in zip(got, want):
            _close(g.numpy(), w.numpy())
    _close(P5.run_E(*_t(u0, u1, mp), 1, TX)[1].numpy(), a)


def test_xtiles_run_A_matches_jax(jax_probe, interpret):
    N = 16
    jp = jax_probe('stencil_probe5', N=N, TX=8)
    u0, u1, mp = _xtiles_inputs(N, 6)
    m = mp[2 * H:2 * H + N, H:H + N, H:H + N].copy()
    want = jp.run_A(*_j(u0, u1, m), 3)
    got = P5.run_A(*_t(u0, u1, m), 3)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


# -- K6 and K7 on K1's streaming engine -----------------------------------------

@pytest.mark.parametrize('in_place', [False, True])
def test_tiles_rows(in_place):
    """K6's rows for the streaming engine: out at (0, 0, 4) of its view (up's
    interior columns: (4, 4, 4) of up's allocation), uc staged at (4, 4, 4),
    up_i resolved to up's allocation at (4, 4, 0) + (0, 0, 4), m_i at
    (0, 0, 4)."""
    u0, u1, m_i = _t(*_tiles_inputs(12, 5))
    up_i = u0[H:-H, H:-H]
    out = up_i if in_place else torch.empty_like(m_i)
    ptrs, dims, org = P4._rows(u1, up_i, m_i, out)
    assert list(ptrs) == [out.untyped_storage().data_ptr(), u1.data_ptr(),
                          u0.data_ptr(), m_i.data_ptr()]
    assert list(dims) == [20 if in_place else 12] * 2 + [128] \
        + [20, 20, 128] * 2 + [12, 12, 128]
    assert list(org) == ([4, 4, 4] if in_place else [0, 0, 4]) \
        + [4, 4, 4] * 2 + [0, 0, 4]


def test_xtiles_rows():
    """K7's rows: out, uc staged, up and m_pad, each at (8, 4, 4)."""
    u0, u1, mp = _t(*_xtiles_inputs(12, 5))
    out = torch.empty_like(u0)
    ptrs, dims, org = P5._rows(u1, u0, mp, out)
    assert list(ptrs) == [t.data_ptr() for t in (out, u1, u0, mp)]
    assert list(dims) == [28, 20, 128] * 4 and list(org) == [8, 4, 4] * 4


def test_stream_whole_resolves_a_view():
    """A read row that is a view becomes the contiguous tensor over its
    allocation, and the view's first element in it."""
    from devito_tpu_torch.experiments import _stream as S
    u = torch.arange(16 * 16 * 8, dtype=torch.float32).view(16, 16, 8)
    t, first = S.whole(u[4:-4, 4:-4, :])
    assert t.is_contiguous() and t.data_ptr() == u.data_ptr()
    assert tuple(t.shape) == (16, 16, 8) and first == (4, 4, 0)
    assert t[first] == u[4, 4, 0]
    assert S.whole(u)[1] == (0, 0, 0)


def _box_mask(shape, org, ext):
    m = torch.zeros(shape, dtype=torch.bool)
    m[tuple(slice(o, o + e) for o, e in zip(org, ext))] = True
    return m


def _frame_mask(shape, params):
    """The points of the (x, y, z) allocation ``shape`` that the frame
    kernel zeroes: the outer box of ``params`` less the inner box."""
    p = [int(v) for v in params]
    return _box_mask(shape, p[0:3], p[3:6]) & ~_box_mask(shape, p[6:9],
                                                         p[9:12])


def _written(alloc, rows, n):
    """(zeros, update) masks of the NaN-filled ``alloc`` after a step: where
    it holds 0, and the region (``rows``' target origin, extent n)."""
    org = list(rows[2])[:3]
    return alloc == 0, _box_mask(alloc.shape, org, n)


@pytest.mark.parametrize('N', [12, 13, 16, 18])
@pytest.mark.parametrize('view', [False, True])
def test_tiles_frame_matches_the_plain_zeros(N, view):
    """K6's frame and region, as the kernel gets them, cover exactly what its
    plain version writes: its zeros and its update, into a new (N, N, ZA)
    tensor or the interior columns of an (N+8, N+8, ZA) allocation, at
    N % 4 = 0 and not."""
    u0, u1, m_i = _t(*_tiles_inputs(N, N))
    ZA = m_i.shape[2]
    alloc = torch.full((N + 2 * H, N + 2 * H, ZA) if view else (N, N, ZA),
                       float('nan'))
    out = alloc[H:-H, H:-H] if view else alloc
    params = P4._frame(out)
    P4.tiles_step_reference(u1, u0[H:-H, H:-H], m_i, out)
    zeros, region = _written(alloc, P4._rows(u1, u0[H:-H, H:-H], m_i, out),
                             (N, N, N))
    frame = _frame_mask(alloc.shape, params)
    assert torch.equal(zeros, frame) and not (frame & region).any()
    assert torch.equal(~alloc.isnan(), frame | region)


@pytest.mark.parametrize('N', [12, 13, 16, 18])
def test_xtiles_frame_matches_the_plain_zeros(N):
    """K7's frame and region cover exactly what its plain version writes:
    zeros everywhere but the interior, and the interior's update."""
    u0, u1, mp = _t(*_xtiles_inputs(N, N))
    out = torch.full(u0.shape, float('nan'))
    params = P5._frame(out)
    P5.xtiles_step_reference(u1, u0, mp, out)
    zeros, region = _written(out, P5._rows(u1, u0, mp, out), (N, N, N))
    frame = _frame_mask(out.shape, params)
    assert torch.equal(zeros, frame) and not (frame & region).any()
    assert torch.equal(frame | region, torch.ones_like(frame))


def test_tiles_stream_tiles_fit_two_ctas_per_sm():
    """K6's and K7's unit is compiled for _tiled.STREAM_TILES, in order, each
    of which stream_tile fits at two or more CTAs an SM for one staged and
    two centre groups of radius 4; chip_smoke.py picks the ptxas report of
    STREAM_TILE's kernel."""
    from devito_tpu_torch.experiments import _stream as S
    from devito_tpu_torch.experiments import _tiled as T
    from devito_tpu_torch.kernels.stencil import stream_tile
    sys.path.insert(0, str(REPO))
    import chip_smoke as C
    src = (REPO / 'devito_tpu_torch/csrc/probe_tiles_stream.cu').read_text()
    tiles = [tuple(map(int, g)) for g in re.findall(
        r'StreamTile<float, 1, 2, R, R, R, (\d+), (\d+), (\d+), (\d+)>',
        src)]
    assert tuple(tiles) == T.STREAM_TILES and T.STREAM_TILE in tiles
    fits = [stream_tile(np.float32, (4, 4, 4), 1, 2, t + (S.X_CHUNK,))
            for t in tiles]
    assert all(f['ctas_per_sm'] >= 2 for f in fits)
    assert [f['smem_bytes'] for f in fits] == [77440, 61440, 43648, 93440]
    assert [f['ctas_per_sm'] for f in fits] == [2, 3, 5, 2]
    picks = {e for n, s, _, e in C.KERNELS if s.endswith(
        'probe_tiles_stream.cu')}
    assert picks == {C.tile_entry(T.STREAM_TILE)}


@pytest.mark.parametrize('tile', [(8, 64, 2, 2), (16, 64, 4, 5)])
def test_stream_step_refuses_unknown_tiles(tile):
    from devito_tpu_torch.experiments import _tiled as T
    with pytest.raises(ValueError, match='expected one of'):
        T.stream_step('k', None, (1, 1, 1), (), 24, tile, None)


# -- argument checks -----------------------------------------------------------

def _k3_args(N=8):
    return _t(*_k3_inputs(N, 0))


def _nb_args(N=8):
    return _t(*_nb_inputs(N, 0))


def _tiles_args(N=8):
    u0, u1, m_i = _t(*_tiles_inputs(N, 0))
    return [u1, u0[H:-H, H:-H], m_i]


def _xtiles_args(N=8):
    return _t(*_xtiles_inputs(N, 0))


CHECKS = {
    'K3 shape': (lambda a: P1.halo_tiles_step(a[0][:, :4].contiguous(),
                                              *a[1:]), _k3_args,
                 ValueError, 'expected'),
    'K3 dtype': (lambda a: P1.halo_tiles_step(a[0].double(), *a[1:]),
                 _k3_args, TypeError, 'fp32'),
    'K3 tile': (lambda a: P1.halo_tiles_step(*a, TX=0), _k3_args,
                ValueError, 'positive'),
    'K3 out is uc': (lambda a: P1.halo_tiles_step(*a, out=a[1][H:-H, H:-H,
                                                               H:-H]),
                     _k3_args, ValueError, 'shares storage'),
    'K3 device': (lambda a: P1.halo_tiles_step(*[t.to('meta') for t in a]),
                  _k3_args, ValueError, 'no halo-tiles step kernel'),
    'K4 T divides NP': (lambda a: P2.neighbour_blocks_step(*a, T=5),
                        _nb_args, ValueError, 'T=5'),
    'K4 T >= 4': (lambda a: P2.neighbour_blocks_step(*a, T=2), _nb_args,
                  ValueError, 'T >= 4'),
    'K4 shape': (lambda a: P2.neighbour_blocks_step(a[0], a[1][:, :8],
                                                    a[2]), _nb_args,
                 TypeError, 'contiguous'),
    'K4 out is uc': (lambda a: P2.neighbour_blocks_step(*a, out=a[1]),
                     _nb_args, ValueError, 'shares storage'),
    'K5 T divides NP': (lambda a: P3.neighbour_blocks_zeroed_step(*a, T=6),
                        _nb_args, ValueError, 'T=6'),
    'K5 dtype': (lambda a: P3.neighbour_blocks_zeroed_step(
        a[0], a[1].half(), a[2]), _nb_args, TypeError, 'fp32'),
    'K5 device': (lambda a: P3.neighbour_blocks_zeroed_step(
        *[t.to('meta') for t in a]), _nb_args, ValueError,
        'no zeroed neighbour-block step kernel'),
    'K6 shape': (lambda a: P4.tiles_step(a[0], a[1][:4], a[2]), _tiles_args,
                 ValueError, 'expected'),
    'K6 tile': (lambda a: P4.tiles_step(*a, TY=0), _tiles_args, ValueError,
                'positive'),
    'K6 z stride': (lambda a: P4.tiles_step(a[0], a[1].transpose(1, 2),
                                            a[2]), _tiles_args, TypeError,
                    'contiguous along z'),
    'K6 devices': (lambda a: P4.tiles_step(a[0], a[1].to('meta'), a[2]),
                   _tiles_args, ValueError, 'different devices'),
    'K7 TX divides XP': (lambda a: P5.xtiles_step(*a, TX=5), _xtiles_args,
                         ValueError, 'does not divide'),
    'K7 shape': (lambda a: P5.xtiles_step(a[0][:16].contiguous(), *a[1:]),
                 _xtiles_args, ValueError, 'expected'),
    'K7 out is uc': (lambda a: P5.xtiles_step(*a, TX=8, out=a[0]),
                     _xtiles_args,
                     ValueError, 'shares storage'),
}


@pytest.mark.parametrize('case', sorted(CHECKS))
def test_wrappers_check_arguments(case):
    call, args, exc, match = CHECKS[case]
    with pytest.raises(exc, match=match):
        call(args())


# -- the entry points on the CPU -------------------------------------------------

MAINS = {
    'stencil_probe': (lambda: P1.main(16, 2, 8, 8, device='cpu'), P1,
                      ['A torch-slices', 'C kernel TX=8 TY=8',
                       'max |A - C| after 3 steps']),
    'stencil_probe2': (lambda: P2.main(40, 2, 8, device='cpu'), P2,
                       ['A torch-DUS', 'B torch-mask', 'C kernel-nb T=8',
                        'C vs A central err']),
    'stencil_probe3': (lambda: P3.main(16, 2, 4, device='cpu'), P3,
                       ['A torch-DUS', 'D torch-conv', 'D vs A err',
                        'E kernel-nb T=4', 'E vs A err']),
    'stencil_probe4': (lambda: P4.main(24, 2, 8, 16, device='cpu'), P4,
                       ['A torch-DUS', 'E v3 TX=8 TY=16', 'E vs A err']),
    'stencil_probe5': (lambda: P5.main(16, 2, 8, device='cpu'), P5,
                       ['A torch-DUS', 'E v4 TX=8', 'E vs A err']),
}


@pytest.mark.parametrize('module', sorted(MAINS))
def test_probe_main_on_cpu(module, capsys):
    run, mod, lines = MAINS[module]
    before = mod.launches
    res = run()
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, line
    assert re.search(r'max \|kernel - plain\| over the whole array after 1 '
                     r'and 3 steps: 0\.0, 0\.0', out)
    assert re.search(r': \S+ ms, \S+ GPts/s', out)
    assert res['err'] == 0.0 and mod.launches == before


@pytest.mark.parametrize('module,args', [
    ('stencil_probe', ['16', '1', '8', '8']),
    ('stencil_probe2', ['16', '1', '8']),
    ('stencil_probe3', ['16', '1', '8']),
    ('stencil_probe4', ['16', '1', '8', '16']),
    ('stencil_probe5', ['16', '1', '8'])])
def test_entry_points_run_as_scripts(module, args):
    res = subprocess.run(
        [sys.executable, '-m', f'devito_tpu_torch.experiments.{module}',
         *args, '--device', 'cpu'], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={'PATH': '/usr/bin:/bin',
                                     'OMP_NUM_THREADS': '1'})
    assert res.returncode == 0, res.stderr
    assert 'GPts/s' in res.stdout and 'kernel - plain' in res.stdout


@pytest.mark.parametrize('module', sorted(MAINS))
def test_entry_points_need_cuda_when_asked(module, monkeypatch):
    mod = MAINS[module][1]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(DevitoTpuError, match='is_available'):
        mod.main(16, 1)


# -- on the card -----------------------------------------------------------------

def _on(card, arrays):
    return [torch.from_numpy(a).to(card) for a in arrays]


def _card_close(got, ref):
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= TOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize('N,TX,TY', [(36, 32, 32), (40, 16, 12), (64, 32, 32)])
def test_halo_tiles_kernel_on_card(card, N, TX, TY):
    up, uc, m, damp = _on(card, _k3_inputs(N, N))
    before = P1.launches
    _card_close(P1.halo_tiles_step(up, uc, m, damp, TX, TY),
                P1.halo_tiles_step_reference(up, uc, m, damp))
    got = P1.run_pallas(up.clone(), uc.clone(), m, damp, 3, TX, TY)
    want = P1.run_pallas(up.clone(), uc.clone(), m, damp, 3, plain=True)
    for g, w in zip(got, want):
        _card_close(g, w)
    assert P1.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize('N', [36, 100])
def test_halo_tiles_in_place_on_card(card, N):
    """K3 into up's interior is bit-equal to K3 into a new tensor (the tile
    of up a CTA reads arrives before it writes, and the centre box's 16
    bytes of the next tile are never used), where N is not a multiple of
    the tile; each x-chunk of _stream.X_CHUNKS is bit-equal too."""
    from devito_tpu_torch.experiments import _stream as S
    up, uc, m, damp = _on(card, _k3_inputs(N, N + 1))
    new = P1.halo_tiles_step(up, uc, m, damp)
    _card_close(new, P1.halo_tiles_step_reference(up, uc, m, damp))
    inplace = up.clone()
    c = slice(H, -H)
    P1.halo_tiles_step(inplace, uc, m, damp, out=inplace[c, c, c])
    torch.cuda.synchronize()
    assert torch.equal(inplace[c, c, c], new)
    inplace[c, c, c] = up[c, c, c]
    assert torch.equal(inplace, up)          # up's halo untouched
    for xc in S.X_CHUNKS:
        assert torch.equal(P1.halo_tiles_kernel(
            up, uc, m, damp, torch.empty_like(m), xc), new)


@pytest.mark.cuda
def test_halo_tiles_kernel_builds_clean_on_card(card):
    """K3's kernel builds without spills (when ptxas ran in this process)
    and the CUDA runtime fits two or more of its CTAs on an SM."""
    from devito_tpu_torch.experiments import _stream as S
    from devito_tpu_torch.kernels import _nvcc
    _nvcc.fixed('probe_halo_stream')
    log = _nvcc.build_log.get(_nvcc.fixed_key('probe_halo_stream'))
    if log is not None:
        assert 'bytes spill' in log and not re.search(
            r'[1-9]\d* bytes spill', log), log
    assert S.occupancy('probe_halo_stream') >= 2


@pytest.mark.cuda
@pytest.mark.parametrize('zeroed', [False, True])
@pytest.mark.parametrize('N,T', [(20, 4), (28, 9), (40, 8)])
def test_neighbour_blocks_kernels_on_card(card, N, T, zeroed):
    mod = P3 if zeroed else P2
    step = P3.neighbour_blocks_zeroed_step if zeroed \
        else P2.neighbour_blocks_step
    ref = P3.neighbour_blocks_zeroed_step_reference if zeroed \
        else P2.neighbour_blocks_step_reference
    run = P3.run_E if zeroed else P2.run_C
    up, uc, mf = _on(card, _nb_inputs(N, N * T))
    before = mod.launches
    _card_close(step(up, uc, mf, T), ref(up, uc, mf, T))
    got = run(up.clone(), uc.clone(), mf, 3, T)
    want = run(up.clone(), uc.clone(), mf, 3, T, plain=True)
    for g, w in zip(got, want):
        _card_close(g, w)
    assert mod.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize('zeroed', [False, True])
@pytest.mark.parametrize('N,T', [(37, 5), (40, 8), (100, 9)])
def test_neighbour_blocks_in_place_on_card(card, N, T, zeroed):
    """K4 and K5 into up itself are bit-equal to K4 and K5 into a new
    tensor (the frame zeroes only points the engine never uses; the edge
    rows read up only at the point they write), where N % 4 != 0 or N is
    not a multiple of the tile; each x-chunk and tile is bit-equal too."""
    up, uc, mf = _on(card, _nb_inputs(N, N + T))
    if zeroed:
        step, ref = P3.neighbour_blocks_zeroed_step, \
            P3.neighbour_blocks_zeroed_step_reference
        kernel = lambda out, xc, tile: \
            P3.neighbour_blocks_zeroed_kernel(up, uc, mf, out, xc, tile)  # noqa
    else:
        step, ref = P2.neighbour_blocks_step, \
            P2.neighbour_blocks_step_reference
        kernel = lambda out, xc, tile: P2.neighbour_blocks_kernel(  # noqa
            up, uc, mf, T, out, xc, tile)
    new = step(up, uc, mf, T)
    _card_close(new, ref(up, uc, mf, T))
    inplace = up.clone()
    step(inplace, uc, mf, T, out=inplace)
    torch.cuda.synchronize()
    assert torch.equal(inplace, new)
    for xc, tile in _candidates():
        out = torch.full_like(up, float('nan'))
        assert torch.equal(kernel(out, xc, tile), new), (xc, tile)


@pytest.mark.cuda
@pytest.mark.parametrize('N,T', [(20, 4), (28, 9), (40, 8), (16, 24)])
def test_edge_rows_kernel_on_card(card, N, T):
    """The edge-row kernel alone writes K4's x-halo rows over the interior
    columns of a NaN-filled output, and nothing else, within the tolerance
    of its plain version (T = NP included)."""
    up, uc, mf = _on(card, _nb_inputs(N, N * T + 2))
    out = torch.full_like(up, float('nan'))
    want = P2.edge_rows_reference(up, uc, mf, T, out.clone())
    P2.edge_rows('k', up, uc, mf, T, out)
    torch.cuda.synchronize()
    assert torch.equal(out.isnan(), want.isnan())
    _card_close(out.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize('N,TX,TY', [(40, 16, 32), (36, 8, 8), (48, 16, 16),
                                     (37, 16, 32), (45, 8, 8)])
def test_tiles_kernel_on_card(card, N, TX, TY):
    u0, u1, m_i = _on(card, _tiles_inputs(N, N))
    up_i = u0[H:-H, H:-H]
    before = P4.launches
    _card_close(P4.tiles_step(u1, up_i, m_i, TX, TY),
                P4.tiles_step_reference(u1, up_i, m_i))
    got = P4.run_E(u0.clone(), u1.clone(), m_i, 3, TX, TY)
    want = P4.run_E(u0.clone(), u1.clone(), m_i, 3, plain=True)
    for g, w in zip(got, want):
        _card_close(g, w)
    assert P4.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize('N,TX', [(16, 32), (40, 8), (48, 16), (37, 53),
                                  (45, 61), (50, 11)])
def test_xtiles_kernel_on_card(card, N, TX):
    u0, u1, mp = _on(card, _xtiles_inputs(N, N))
    before = P5.launches
    _card_close(P5.xtiles_step(u1, u0, mp, TX),
                P5.xtiles_step_reference(u1, u0, mp))
    got = P5.run_E(u0.clone(), u1.clone(), mp, 3, TX)
    want = P5.run_E(u0.clone(), u1.clone(), mp, 3, plain=True)
    for g, w in zip(got, want):
        _card_close(g, w)
    assert P5.launches == before + 4


def _candidates():
    """Every (x-chunk, tile) of _stream.X_CHUNKS at STREAM_TILE and of
    STREAM_TILES at _stream.X_CHUNK."""
    from devito_tpu_torch.experiments import _stream as S
    from devito_tpu_torch.experiments import _tiled as T
    return [(xc, T.STREAM_TILE) for xc in S.X_CHUNKS] + [
        (S.X_CHUNK, t) for t in T.STREAM_TILES]


@pytest.mark.cuda
@pytest.mark.parametrize('N', [37, 100])
def test_tiles_in_place_on_card(card, N):
    """K6 into up's interior columns is bit-equal to K6 into a new tensor
    (the tile of up a CTA reads arrives before it writes; the centre box's
    16 bytes past a tile are never used), up's x/y halo untouched, where
    N % 4 != 0 or N is not a multiple of the tile; each x-chunk and tile
    is bit-equal too."""
    u0, u1, m_i = _on(card, _tiles_inputs(N, N + 1))
    c = slice(H, -H)
    new = P4.tiles_step(u1, u0[c, c], m_i)
    _card_close(new, P4.tiles_step_reference(u1, u0[c, c], m_i))
    inplace = u0.clone()
    P4.tiles_step(u1, inplace[c, c], m_i, out=inplace[c, c])
    torch.cuda.synchronize()
    assert torch.equal(inplace[c, c], new)
    inplace[c, c] = u0[c, c]
    assert torch.equal(inplace, u0)          # up's x/y halo untouched
    for xc, tile in _candidates():
        w = u0.clone()
        P4.tiles_kernel(u1, w[c, c], m_i, w[c, c], xc, tile)
        assert torch.equal(w[c, c], new), (xc, tile)


@pytest.mark.cuda
@pytest.mark.parametrize('N', [37, 64])
def test_xtiles_candidates_on_card(card, N):
    """K7 at every x-chunk and tile is bit-equal to K7 at the pick."""
    u0, u1, mp = _on(card, _xtiles_inputs(N, N + 2))
    pick = P5.xtiles_step(u1, u0, mp, N + 16)
    _card_close(pick, P5.xtiles_step_reference(u1, u0, mp))
    for xc, tile in _candidates():
        assert torch.equal(P5.xtiles_kernel(
            u1, u0, mp, torch.empty_like(u0), xc, tile), pick), (xc, tile)


@pytest.mark.cuda
@pytest.mark.parametrize('N', [37, 45, 48])
@pytest.mark.parametrize('kernel', ['K4', 'K5', 'K6', 'K7'])
def test_stream_frame_on_card(card, kernel, N):
    """The engine alone (with K4's edge rows) writes its update on exactly
    the region of a NaN-filled output, and the frame kernel before it 0 on
    exactly the frame, where the frame's rows end off a 16-byte boundary
    (N % 4 != 0)."""
    from devito_tpu_torch.experiments._stream import X_CHUNK
    if kernel in ('K4', 'K5'):
        zeroed, T = kernel == 'K5', N + 8
        up, uc, mf = _on(card, _nb_inputs(N, N))
        alloc = out = torch.full_like(up, float('nan'))
        if zeroed:
            run = lambda zeros: P3.neighbour_blocks_zeroed_kernel(  # noqa
                up, uc, mf, out, X_CHUNK, P3.STREAM_TILE, zeros)
        else:
            run = lambda zeros: P2.neighbour_blocks_kernel(  # noqa
                up, uc, mf, T, out, X_CHUNK, P2.STREAM_TILE, zeros)
        params = P2.nb_frame(out, zeroed)
        lo = H if zeroed else 0
        region = _box_mask(alloc.shape, (lo, H, H),
                           (N + 2 * (H - lo), N, N)).to(card)
        frame = _frame_mask(alloc.shape, params).to(card)
        want = P2.nb_reference(up, uc, mf, T, zeroed)
        run(False)
        torch.cuda.synchronize()
        assert torch.equal(~alloc.isnan(), region)
        alloc.fill_(float('nan'))
        run(True)
        torch.cuda.synchronize()
        assert torch.equal(alloc == 0, frame)
        assert not alloc.isnan().any()
        _card_close(out, want)
        return
    if kernel == 'K6':
        u0, u1, m_i = _on(card, _tiles_inputs(N, N))
        alloc = torch.full(u0.shape, float('nan'), device=card)
        out = alloc[H:-H, H:-H]
        run = lambda zeros: P4.tiles_kernel(  # noqa: E731
            u1, u0[H:-H, H:-H], m_i, out, X_CHUNK, P4.STREAM_TILE, zeros)
        params, rows = P4._frame(out), P4._rows(u1, u0[H:-H, H:-H], m_i, out)
        want = P4.tiles_step_reference(u1, u0[H:-H, H:-H], m_i)
    else:
        u0, u1, mp = _on(card, _xtiles_inputs(N, N))
        alloc = out = torch.full(u0.shape, float('nan'), device=card)
        run = lambda zeros: P5.xtiles_kernel(  # noqa: E731
            u1, u0, mp, out, X_CHUNK, P5.STREAM_TILE, zeros)
        params, rows = P5._frame(out), P5._rows(u1, u0, mp, out)
        want = P5.xtiles_step_reference(u1, u0, mp)
    frame = _frame_mask(alloc.shape, params).to(card)
    region = _box_mask(alloc.shape, list(rows[2])[:3], (N, N, N)).to(card)
    run(False)
    torch.cuda.synchronize()
    assert torch.equal(~alloc.isnan(), region)
    alloc.fill_(float('nan'))
    run(True)
    torch.cuda.synchronize()
    assert torch.equal(alloc == 0, frame)
    assert torch.equal(alloc.isnan(), ~(frame | region))
    _card_close(out, want)


@pytest.mark.cuda
def test_tiles_stream_builds_clean_on_card(card):
    """K4's to K7's unit, with its frame and edge-row kernels, builds
    without spills (when ptxas ran in this process) and the CUDA runtime
    fits two or more CTAs of each tile's kernel on an SM."""
    from devito_tpu_torch.experiments import _stream as S
    from devito_tpu_torch.experiments import _tiled as T
    from devito_tpu_torch.kernels import _nvcc
    _nvcc.fixed('probe_tiles_stream')
    log = _nvcc.build_log.get(_nvcc.fixed_key('probe_tiles_stream'))
    if log is not None:
        assert 'bytes spill' in log and not re.search(
            r'[1-9]\d* bytes spill', log), log
        assert 'edge_rows_kernel' in log and 'frame_kernel' in log
    for i, _ in enumerate(T.STREAM_TILES):
        assert S.occupancy('probe_tiles_stream', 2 * i) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize('module', sorted(MAINS))
def test_entry_points_on_card(card, module):
    mod = MAINS[module][1]
    before = mod.launches
    res = mod.main(48, 2)           # raises beyond its tolerances
    assert res['err'] >= 0 and mod.launches == before + 2 * 2 + 4
