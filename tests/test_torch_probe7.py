"""K10-K14 (devito_tpu_torch/experiments/stencil_probe7.py) against the
TPU kernels they port, the probes of experiments/stencil_probe7.py, which
run here in Pallas interpret mode: the tests cut the JAX script's sizes to
N, NY, ZA = 16, 32, 160, skip its timing loops, build every ``pallas_call``
with ``interpret=True`` in JAX's 32-bit mode (which the probes were written
for) and call the callables on seeded numpy inputs.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the CUDA kernels are held against those versions by the ``cuda``-marked
tests, on the card. K10's interior rows, K12 and K13/K14 are compared to
the bit; K11 within 1e-5 * max|reference| (fp32 sums in another order)."""

import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devito_tpu_torch.exceptions import DevitoTpuError
from devito_tpu_torch.experiments import stencil_probe7 as P7

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
N, H, NY, ZA, T0 = 16, 8, 32, 160, 4
#: probe_B's fills, and a second set whose fields all differ
FILL_SETS = [P7.FILLS, (0.02, 0.01, 2.0, 0.3)]
#: Faults of a stencil kernel that constant fields cannot show
FAULTS = ('tap offset', 'x taps read y', 'weights 3 and 4 swapped',
          'no Laplacian')


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pallas_call`` made while the test runs is built with
    ``interpret=True``; the list collects the callables, in order. The
    test runs in JAX's default 32-bit mode (importing devito_tpu turns on
    64-bit mode, in which ``lax.rem(program_id, 2)`` does not trace)."""
    import jax
    from jax.experimental import pallas as pl
    orig, calls = pl.pallas_call, []

    def wrap(*args, **kwargs):
        kwargs['interpret'] = True
        call = orig(*args, **kwargs)
        calls.append(call)
        return call

    monkeypatch.setattr(pl, 'pallas_call', wrap)
    with jax.enable_x64(False):
        yield calls


@pytest.fixture
def p7(monkeypatch):
    """experiments/stencil_probe7.py at N, NY, ZA = 16, 32, 160, its timing
    loops skipped: the tests take the ``pallas_call`` callables."""
    mod = importlib.import_module('experiments.stencil_probe7')
    for k, v in dict(N=N, NY=NY, ZA=ZA).items():
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(mod, 'timeit', lambda fn, *a, **k: 1.0)
    return mod


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device('cuda', 0)


def _src(seed):
    return P7.inputs(N, ZA, seed, 'cpu').numpy()


def _close(got, ref):
    return np.abs(got - ref).max() <= TOL * np.abs(ref).max()


# -- K10 -----------------------------------------------------------------------

@pytest.mark.parametrize('nwin,wb,nsplit', [(1, True, 1), (2, True, 2),
                                            (4, True, 1), (2, False, 1)])
def test_copy_windows_matches_pallas_kernel(nwin, wb, nsplit, p7, interpret,
                                            capsys):
    p7.probe_A(t0=T0, nwin=nwin, writeback=wb, nsplit=nsplit)
    assert f'A t0={T0} nwin={nwin}' in capsys.readouterr().out
    call = interpret[-1]
    src = _src(nwin)
    ref, got = jnp.asarray(src), torch.from_numpy(src)
    want = src[H:H + N]
    for i in range(3):           # each call fed the last one's output
        ref = call(ref)
        got = P7.copy_windows(got, T0, nwin, wb, nsplit)
        assert got.shape == ref.shape == (NY, NY, ZA)
        want = want + np.float32(1.0)
        if wb and i in (0, 2):
            assert np.array_equal(got.numpy()[H:H + N],
                                  np.asarray(ref)[H:H + N])
            assert np.array_equal(got.numpy()[H:H + N], want)


def test_copy_windows_leaves_halo_rows_unset(p7, interpret):
    """The JAX kernel writes only rows [H, H+N): interpret mode leaves the
    rest NaN, and the port does not write them either."""
    p7.probe_A(t0=T0, nwin=1)
    ref = np.asarray(interpret[-1](jnp.asarray(_src(0))))
    assert np.isnan(ref[:H]).all() and np.isnan(ref[H + N:]).all()
    assert np.isfinite(ref[H:H + N]).all()


def test_copy_windows_checks_arguments():
    src = P7.inputs(N, ZA, 0, 'cpu')
    with pytest.raises(ValueError, match='does not divide'):
        P7.copy_windows(src, 5)
    with pytest.raises(ValueError, match='nsplit=3 does not divide'):
        P7.copy_windows(src, 4, 2, True, 3)
    with pytest.raises(ValueError, match='at least one window'):
        P7.copy_windows(src, 4, 0)
    with pytest.raises(ValueError, match='expected'):
        P7.copy_windows(src[:, :, :24].contiguous(), 4)
    with pytest.raises(TypeError, match='fp32'):
        P7.copy_windows(src.double(), 4)
    with pytest.raises(ValueError, match='no window-copy kernel'):
        P7.copy_windows(src.to('meta'), 4)


def test_copy_windows_checks_tile_and_depth():
    src = P7.inputs(N, ZA, 0, 'cpu')
    for depth in (0, 9):
        with pytest.raises(ValueError, match=f'depth={depth}'):
            P7.copy_windows(src, 4, 2, True, 1, None, depth)
    for tile in ((3, 64), (1, 32), (8, 512)):
        with pytest.raises(ValueError, match=re.escape(f'tile {tile}')):
            P7.copy_windows(src, 4, 2, True, 1, tile)
    with pytest.raises(ValueError, match='fits in'):   # (8, 256): 1.1 MiB
        P7.copy_windows(src, 16, 4, True, 1, (8, 256), 2)
    with pytest.raises(ValueError, match='do not fit'):
        P7.copy_windows(P7.inputs(64, 80, 0, 'cpu'), 64, 8, True, 1, None, 8)
    # a listed tile and depth are taken (on the CPU the plain version runs
    # whatever they are; the card tests hold the kernel on every tile)
    tile = P7.copy_tiles(2, 2, 4)[-1][0]
    got = P7.copy_windows(src, 4, 2, True, 2, tile, 2)
    assert torch.equal(got[H:H + N], src[H:H + N] + 1.0)


def test_copy_tile_pins():
    """K10's tiles at the JAX script's t0 and nwin: a ring of COPY_DEPTH
    slots of four (16, TY, TZ) fp32 windows and, with write-back, two
    staging windows, 256 bytes of slack and barriers, and the CTAs an SM
    holds by them."""
    assert (P7.COPY_DEPTH, P7.COPY_STAGES) == (3, 2)
    src = (REPO / 'devito_tpu_torch/csrc/probe7_copy.cu').read_text()
    assert f'constexpr int STAGES = {P7.COPY_STAGES};' in src
    assert P7.copy_tile(3, 4, 16) == ((1, 64), 57600, 3)
    assert P7.copy_tile(2, 4, 16) == ((1, 64), 41216, 5)
    assert P7.copy_tile(2, 4, 16, False) == P7.stream_tile(2, 4, 16)
    assert P7.copy_tile(4, 4, 16) == ((1, 64), 73984, 3)
    # one window a chunk: the widest TY 1 tile that two CTAs share an SM by
    assert P7.copy_tile(3, 1, 16) == ((1, 256), 82176, 2)
    assert P7.copy_tile(2, 1, 16, False) == ((1, 256), 33024, 6)
    assert P7.copy_tile(8, 1, 64) == ((1, 64), 164096, 1)  # none by two
    with pytest.raises(ValueError, match='window-copy kernel.*do not fit'):
        P7.copy_tile(8, 8, 64)


@pytest.mark.parametrize('wb', [True, False])
@pytest.mark.parametrize('depth', P7.DEPTHS)
@pytest.mark.parametrize('nwin,t0', [(1, 16), (4, 16), (1, 257), (3, 257)])
def test_copy_tiles_fit_in_preference_order(depth, nwin, t0, wb):
    fits = P7.copy_tiles(depth, nwin, t0, wb)
    room = depth * nwin + 2 * wb  # windows of (t0, TY, TZ) fp32
    for (ty, tz), smem, ctas in fits:
        assert ty in P7.STREAM_TYS and tz in P7.STREAM_TZS
        assert smem == 256 + 4 * room * t0 * ty * tz <= 232448
        assert ctas == min(233472 // (smem + 1024), 2048 // 160)
    assert [f[1] for f in fits] == sorted(f[1] for f in fits)
    assert len(fits) == sum(256 + 4 * room * t0 * ty * tz <= 232448
                            for ty in P7.STREAM_TYS for tz in P7.STREAM_TZS)
    if fits:
        assert fits[0][0] == (1, 64)
        two = [f for f in fits if f[0][0] == 1 and f[2] >= 2]
        assert P7.copy_tile(depth, nwin, t0, wb) == (
            two[-1] if nwin == 1 and two else fits[0])
    else:
        with pytest.raises(ValueError, match='do not fit'):
            P7.copy_tile(depth, nwin, t0, wb)
    if not wb:         # the reads alone: K13/K14's ring
        assert fits == P7.stream_tiles(depth, nwin, t0)


# -- K11 -----------------------------------------------------------------------

def _probe_b_numpy(fills, taps):
    """probe_B's update (stencil_probe7.py:136-156) of constant fields, in
    numpy fp32 scalars."""
    f32 = np.float32
    u, u1, vp, dp = map(f32, fills)
    lap = f32(3.0 * P7.W[0]) * u
    if taps != 'none':
        for k in range(1, 5):
            terms = u + u
            if taps == 'full':
                terms = terms + u + u + u + u
            lap = lap + f32(P7.W[k]) * terms
    lap = lap * f32(0.01)
    a = (f32(1.0) / (vp * vp)) * f32(100.0)
    b = dp * f32(5.0)
    return (f32(2.0) * a * u - (a - b) * u1 + lap) / (a + b)


@pytest.mark.parametrize('fills', FILL_SETS)
def test_resident_reference_matches_ref_step(fills, monkeypatch):
    """'full' on constant (N+16)^3 fields against the JAX probe 6's
    ``ref_step``, which uses the same DT = 0.1 and h = 10."""
    p6 = importlib.import_module('experiments.stencil_probe6')
    for k, v in dict(N=N, NY=NY, ZA=NY).items():
        monkeypatch.setattr(p6, k, v)
    fields = [np.full((NY, NY, NY), f, np.float32) for f in fills]
    ref = np.asarray(p6.ref_step(*map(jnp.asarray, fields)))
    want = np.zeros((8, 128), np.float32)
    want[:, :N] = ref[0, :8, :N]
    got = P7.resident_step(T0, 2, 'full', fills, N, 'cpu').numpy()
    assert _close(got, want)
    assert not got[:, N:].any()


@pytest.mark.parametrize('fills', FILL_SETS)
@pytest.mark.parametrize('taps', P7.TAPS)
def test_resident_ablations_match_numpy(taps, fills):
    got = P7.resident_step(T0, 3, taps, fills, N, 'cpu').numpy()
    want = np.zeros((8, 128), np.float32)
    want[:, :N] = _probe_b_numpy(fills, taps)
    assert _close(got, want)


def test_resident_ablations_differ():
    """On constant fields a tap-offset fault shows only through the
    ablations, so their values must tell them apart."""
    vals = [P7.resident_step(T0, 1, t, P7.FILLS, N, 'cpu')[0, 0].item()
            for t in P7.TAPS]
    assert all(abs(a - b) > TOL * abs(b) for a, b in
               zip(vals, vals[1:] + vals[:1]))


def _probe_b_varied(fills, vary, t0, n, taps, fault=None):
    """probe_B's update of the first x-row at y < min(8, n), z < min(128,
    n), in numpy fp32, u varying with position as ``P7.u_window`` says;
    ``fault`` breaks it as a faulty kernel would."""
    f32 = np.float32
    fu, u1, vp, dp = map(f32, fills)
    x, y, z = np.ogrid[:t0 + 8, :n + 8, :n + 8]
    ut = fu * (f32(1.0) + f32(vary) * ((7 * x + 13 * y + 29 * z) % 17)
               .astype(f32))
    ny, nz = min(8, n), min(128, n)

    def at(dx, dy, dz):
        return ut[4 + dx, 4 + dy:4 + dy + ny, 4 + dz:4 + dz + nz]

    w = [f32(v) for v in P7.W]
    if fault == 'weights 3 and 4 swapped':
        w[3], w[4] = w[4], w[3]
    u = at(0, 0, 0)
    lap = f32(3.0 * P7.W[0]) * u
    if taps != 'none':
        for k in range(1, 5):
            terms = at(0, 0, k) + at(0, 0, -k)
            if taps == 'full':
                xk = k + 1 if fault == 'tap offset' and k == 1 else k
                xs = (at(0, k, 0), at(0, -k, 0)) \
                    if fault == 'x taps read y' else \
                    (at(xk, 0, 0), at(-k, 0, 0))
                terms = (terms + xs[0] + xs[1] + at(0, k, 0)
                         + at(0, -k, 0))
            lap = lap + w[k] * terms
    lap = lap * f32(0.01)
    if fault == 'no Laplacian':
        lap = np.zeros_like(u)
    a = (f32(1.0) / (vp * vp)) * f32(100.0)
    b = dp * f32(5.0)
    out = np.zeros((8, 128), np.float32)
    out[:ny, :nz] = (f32(2.0) * a * u - (a - b) * u1 + lap) / (a + b)
    return out


@pytest.mark.parametrize('taps', P7.TAPS)
def test_resident_varied_field_matches_numpy(taps):
    """With u varying with position the Laplacian does not cancel."""
    fills, vary = P7.VARIED
    got = P7.resident_step(T0, 2, taps, fills, N, 'cpu', vary).numpy()
    assert _close(got, _probe_b_varied(fills, vary, T0, N, taps))
    assert np.array_equal(
        P7.u_window((T0 + 8, N + 8, N + 8), 0.5, vary).numpy(),
        0.5 * (1 + vary * np.fromfunction(
            lambda x, y, z: (7 * x + 13 * y + 29 * z) % 17,
            (T0 + 8, N + 8, N + 8))).astype(np.float32))


@pytest.mark.parametrize('fault', FAULTS)
def test_resident_varied_field_shows_faults(fault):
    """Each fault that constant fields hide moves the 'full' output on the
    varied field by more than the tolerance the card's check uses; on
    probe_B's constant fills, where the Laplacian cancels, each stays
    inside it."""
    fills, vary = P7.VARIED
    good = P7.resident_step_reference(T0, 2, 'full', fills, N, 'cpu',
                                      vary).numpy()
    assert not _close(_probe_b_varied(fills, vary, T0, N, 'full', fault),
                      good)
    const = P7.resident_step_reference(T0, 2, 'full', P7.FILLS, N).numpy()
    assert _close(_probe_b_varied(P7.FILLS, 0.0, T0, N, 'full', fault),
                  const)


def test_resident_output_at_small_interior():
    out = P7.resident_step(2, 1, 'z', P7.FILLS, 5, 'cpu').numpy()
    assert (out[:5, :5] != 0).all() and not out[5:].any() and \
        not out[:, 5:].any()


def test_resident_reference_reads_unwritten_scratch(p7, interpret):
    """The JAX kernel's output is ow[0, 0:8, 0:128], scratch rows y < H that
    the stencil never writes: not finite in interpret mode. The port's is
    the interior value."""
    p7.probe_B(t0=T0, reps=2, taps='full')
    ref = np.asarray(interpret[-1](jnp.zeros((1,), jnp.int32)))
    assert ref.shape == (8, 128) and not np.isfinite(ref).any()
    got = P7.resident_step(T0, 2, 'full', P7.FILLS, N, 'cpu').numpy()
    assert np.isfinite(got).all()
    assert np.allclose(got[:, :N], _probe_b_numpy(P7.FILLS, 'full'),
                       rtol=TOL, atol=0)


def test_resident_tile_picks_by_shape():
    """t0 = 16 takes the pinned tile on the unrolled instantiation; any
    other t0 the generic one, the largest TY that lets two CTAs share an
    SM; the pick is the record ``resident_tiles`` lists for it."""
    fit = P7.resident_tile(P7.RESIDENT_T0)
    assert fit[0] == P7.RESIDENT_TILE
    assert fit in P7.resident_tiles(P7.RESIDENT_T0)
    assert P7.resident_instantiation(fit[0]) == 'unrolled'
    for t0 in (1, 3, 5, 8, 17):
        (ty, rows), smem, threads, ctas, _ = P7.resident_tile(t0)
        assert rows == 0 and ctas >= 2 and threads == ty * 8
        assert P7.resident_instantiation((ty, rows)) == 'generic'
        bigger = [f for f in P7.resident_tiles(t0)
                  if f[0][1] == 0 and ty < f[0][0] <= 8]
        assert all(f[3] < 2 for f in bigger)
    with pytest.raises(ValueError, match='do not fit'):
        P7.resident_tile(80)


@pytest.mark.parametrize('t0', [3, 16, 24])
def test_resident_tiles_fit_and_count_threads(t0):
    recs = P7.resident_tiles(t0)
    assert len({r[0] for r in recs}) == len(recs)
    for (ty, rows), smem, threads, ctas, warps in recs:
        assert rows == 0 or t0 % rows == 0
        assert smem == 4 * ((t0 + 8) * (ty + 8) * 40 + 3 * t0 * ty * 32)
        assert smem <= 232448 and threads == ty * 8 * (t0 // rows if rows
                                                       else 1)
        # the kernel's __launch_bounds__: 128 registers a thread at most
        assert 10 <= threads <= (128 if rows == 0 else 512 if rows <= 4
                                 else 2048 // rows)
        assert ctas == min(233472 // (smem + 1024), 2048 // threads)
        assert warps == ctas * threads // 32
    # every candidate ROWS that divides t0 is there with some TY
    assert {r[0][1] for r in recs} == {0} | {
        r for r in P7.RESIDENT_ROWS if t0 % r == 0}


@pytest.mark.parametrize('t0,tile,match', [
    (16, (8, 3), 'ROWS'), (16, (6, 4), 'TY'), (64, (16, 0), 'fit'),
    (16, (16, 2), 'TY'), (16, (8, 1, 4), 'ROWS')])
def test_resident_step_checks_tile(t0, tile, match):
    """A tile outside ``resident_tiles`` raises, on the CPU as on the
    card, and counts no pick."""
    picks = dict(P7.resident_picks)
    with pytest.raises(ValueError, match=match):
        P7.resident_step(t0, 1, 'full', P7.FILLS, N, 'cpu', tile=tile)
    assert P7.resident_picks == picks


def test_resident_step_on_cpu_takes_any_tile_and_division():
    """On the CPU the plain version runs whatever the tile and division:
    the same values, no launch and no pick counted."""
    launches, picks = P7.resident_launches, dict(P7.resident_picks)
    want = P7.resident_step_reference(T0, 2, 'full', P7.FILLS, N)
    for tile, *_ in P7.resident_tiles(T0):
        got = P7.resident_step(T0, 2, 'full', P7.FILLS, N, 'cpu',
                               tile=tile, fast_div=True)
        assert torch.equal(got, want)
    assert (P7.resident_launches, P7.resident_picks) == (launches, picks)


def test_resident_step_checks_arguments():
    with pytest.raises(ValueError, match='taps'):
        P7.resident_step(4, 1, 'x', device='cpu')
    with pytest.raises(ValueError, match='positive'):
        P7.resident_step(0, 1, device='cpu')
    with pytest.raises(ValueError, match='four values'):
        P7.resident_step(4, 1, 'z', (1.0, 2.0), device='cpu')
    with pytest.raises(ValueError, match='no resident-step kernel'):
        P7.resident_step(4, 1, device='meta')
    with pytest.raises(ValueError, match='four values'):
        P7.resident_step_reference(4, 1, 'z', (1.0,))


# -- K12 -----------------------------------------------------------------------

@pytest.mark.parametrize('reps', [1, 4, 16])
def test_empty_grid_matches_pallas_kernel(reps, p7, interpret):
    p7.probe_C(reps)
    ref = np.asarray(interpret[-1]())
    assert ref.shape == (8, 128) and (ref == reps - 1).all()
    assert np.array_equal(P7.empty_grid(reps, 'cpu').numpy(), ref)


def test_empty_grid_checks_arguments():
    with pytest.raises(ValueError, match='at least one'):
        P7.empty_grid(0, 'cpu')
    with pytest.raises(ValueError, match='no empty-grid kernel'):
        P7.empty_grid(4, 'meta')


@pytest.mark.parametrize('reps', [1, 7, 16, 300])
def test_empty_grid_into_out(reps):
    out = torch.full((8, 128), float('nan'))
    got = P7.empty_grid(reps, 'cpu', out)
    assert got is out
    assert torch.equal(out, P7.empty_grid_reference(reps))
    assert P7.empty_grid_reference(reps, out=out) is out


@pytest.mark.parametrize('out,device,match', [
    (torch.empty(8, 64), 'cpu', 'contiguous'),
    (torch.empty(8, 128, dtype=torch.float64), 'cpu', 'fp32'),
    (torch.empty(128, 8).t(), 'cpu', 'contiguous'),
    (np.empty((8, 128), np.float32), 'cpu', 'tensor'),
    (torch.empty(8, 128), 'cuda', 'not on cuda'),
    (torch.empty(8, 128), 'cuda:0', 'not on cuda:0'),
    (torch.empty(8, 128, device='meta'), 'cpu', 'not on cpu')])
def test_empty_grid_checks_out(out, device, match):
    """A wrong shape, type, layout or device of ``out`` raises before
    anything runs; ``out`` is never copied."""
    with pytest.raises(ValueError, match=match):
        P7.empty_grid(4, device, out)


def test_empty_grid_cpu_path_needs_no_cuda(monkeypatch):
    """On the CPU neither the raw stream, the CUDA runtime nor nvcc is
    reached, with or without ``out``."""
    def fail(*args, **kwargs):
        raise AssertionError("the CPU path reached CUDA")

    monkeypatch.delattr(torch._C, '_cuda_getCurrentRawStream',
                        raising=False)
    for name in ('current_stream', 'device', 'current_device'):
        monkeypatch.setattr(torch.cuda, name, fail)
    monkeypatch.setattr(P7._nvcc, 'entry', fail)
    before = P7.empty_launches
    out = torch.empty(8, 128)
    assert torch.equal(P7.empty_grid(5, 'cpu', out), torch.full(
        (8, 128), 4.0))
    assert torch.equal(P7.empty_grid(5, torch.device('cpu')),
                       torch.full((8, 128), 4.0))
    assert P7.empty_launches == before


# -- K13, K14 ------------------------------------------------------------------

def _chunk_sum(src, t0):
    acc = np.zeros((8, 128), np.float32)
    for i in range(N // t0):
        acc = acc + src[H + i * t0, 0:8, 0:128]
    return acc


@pytest.mark.parametrize('nwin', [1, 2, 4])
@pytest.mark.parametrize('depth', [2, 3, 4])
def test_stream_windows_matches_pallas_kernel(depth, nwin, p7, interpret):
    p7.probe_E(t0=T0, nwin=nwin, depth=depth)
    src = _src(10 * depth + nwin)
    ref = np.asarray(interpret[-1](jnp.asarray(src)))
    got = P7.stream_windows(torch.from_numpy(src), T0, nwin, depth).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _chunk_sum(src, T0))


@pytest.mark.parametrize('nwin', [1, 2, 4])
def test_probe_d_is_e_at_depth_2(nwin, p7, interpret):
    p7.probe_D(t0=T0, nwin=nwin)
    src = _src(nwin)
    ref = np.asarray(interpret[-1](jnp.asarray(src)))
    got = P7.stream_windows(torch.from_numpy(src), T0, nwin, 2).numpy()
    assert np.array_equal(got, ref)


def test_stream_windows_checks_arguments():
    src = P7.inputs(N, ZA, 0, 'cpu')
    with pytest.raises(ValueError, match='depth=0'):
        P7.stream_windows(src, 4, 2, 0)
    with pytest.raises(ValueError, match='depth=9'):
        P7.stream_windows(src, 4, 2, 9)
    with pytest.raises(ValueError, match='z 0:128'):
        P7.stream_windows(P7.inputs(N, 64, 0, 'cpu'), 4, 2, 2)
    with pytest.raises(ValueError, match='does not divide'):
        P7.stream_windows(src, 3)
    with pytest.raises(ValueError, match='no window-stream kernel'):
        P7.stream_windows(src.to('meta'), 4)


def test_stream_windows_checks_tile():
    src = P7.inputs(N, ZA, 0, 'cpu')
    for tile in ((3, 64), (1, 32), (8, 512)):
        with pytest.raises(ValueError, match=re.escape(f'tile {tile}')):
            P7.stream_windows(src, 4, 2, 2, tile)
    with pytest.raises(ValueError, match='fits in'):   # (8, 256): 1 MiB
        P7.stream_windows(src, 16, 4, 2, (8, 256))
    want = P7.stream_windows_reference(src, 4, 2, 2)
    for tile, _, _ in P7.stream_tiles(2, 2, 4):
        assert torch.equal(P7.stream_windows(src, 4, 2, 2, tile), want)


def test_stream_needs():
    assert P7.stream_needs(256, 16) == (4 * 1024 * 17, 1024 * 16)


def test_stream_tile_pins():
    """K13's and K14's tiles at the JAX script's t0 and nwin: the shared
    bytes of a ring of 2 and 3 slots of four (16, TY, TZ) fp32 windows,
    256 bytes of slack and barriers, and the CTAs an SM holds by them."""
    assert P7.stream_tile(2, 4, 16) == ((1, 64), 33024, 6)
    assert P7.stream_tile(3, 4, 16) == ((1, 64), 49408, 4)
    with pytest.raises(ValueError, match='do not fit'):
        P7.stream_tile(8, 8, 64)


@pytest.mark.parametrize('depth', P7.DEPTHS)
@pytest.mark.parametrize('nwin,t0', [(1, 16), (4, 16), (3, 257)])
def test_stream_tiles_fit_in_preference_order(depth, nwin, t0):
    fits = P7.stream_tiles(depth, nwin, t0)
    for (ty, tz), smem, ctas in fits:
        assert ty in P7.STREAM_TYS and tz in P7.STREAM_TZS
        assert smem == 256 + 4 * depth * nwin * t0 * ty * tz <= 232448
        assert ctas == min(233472 // (smem + 1024), 2048 // 160)
    assert [f[1] for f in fits] == sorted(f[1] for f in fits)
    all_tiles = len(P7.STREAM_TYS) * len(P7.STREAM_TZS)
    assert len(fits) == all_tiles - sum(
        256 + 4 * depth * nwin * t0 * ty * tz > 232448
        for ty in P7.STREAM_TYS for tz in P7.STREAM_TZS)
    if fits:
        assert P7.stream_tile(depth, nwin, t0) == fits[0]
        assert fits[0][0] == (1, 64)
    else:
        with pytest.raises(ValueError, match='do not fit'):
            P7.stream_tile(depth, nwin, t0)


def test_tiles_fit_shared_memory():
    # A's defaults: a ring of COPY_DEPTH slots and two staging windows
    tile, smem, ctas = P7.copy_tile(P7.COPY_DEPTH, 4, 16)
    assert (tile, smem, ctas) == ((1, 64), 57600, 3)
    assert P7.copy_tile(4, 4, 16)[::2] == ((1, 64), 3)  # a ring of 4 slots
    assert P7.resident_tile(16) == ((16, 4), 190464, 512, 1, 16)
    with pytest.raises(ValueError, match='do not fit'):
        P7.copy_tile(8, 8, 64)


# -- the entry point -------------------------------------------------------------

@pytest.mark.parametrize('which,args', [
    ('A', ['4', '2', 'wb', '2']), ('A', ['4', '1', 'nowb']), ('B', ['z']),
    ('C', []), ('D', ['4', '2']), ('E', ['4', '2', '3'])])
def test_probe_main_on_cpu(which, args, capsys):
    counts = (P7.copy_launches, P7.resident_launches, P7.empty_launches,
              dict(P7.stream_launches))
    rec = P7.main(which, *args, device='cpu', n=N, za=ZA)
    out = capsys.readouterr().out
    assert rec['probe'] == which and rec['device'] == 'cpu'
    assert re.search(rf'^{which}\b.*(ms/|us per)', out, re.M)
    if which in 'ADE':
        assert 'GB/s agg DMA' in out and 'GB/s unique' in out
        assert rec['share'] is None       # no bound share off the card
        # A's result needs the bytes it streams; D's and E's only the
        # (8, 128) tile of each chunk
        assert rec['bytes_needed'] == (
            rec['bytes_unique'] if which == 'A' else P7.stream_needs(N, 4)[0])
        assert rec['bound_ms'] <= rec['stream_bound_ms']
    assert counts == (P7.copy_launches, P7.resident_launches,
                      P7.empty_launches, P7.stream_launches)


@pytest.mark.parametrize('which,args,match', [
    ('F', [], 'expected one of'), ('A', ['4', '2', 'maybe'], 'wb or nowb'),
    ('B', ['x'], 'taps'), ('C', ['1'], 'at most 0'),
    ('D', ['4', '2', '3'], 'at most 2'), ('E', ['5'], 'does not divide')])
def test_probe_main_checks_arguments(which, args, match):
    with pytest.raises(ValueError, match=match):
        P7.main(which, *args, device='cpu', n=N, za=ZA)


@pytest.mark.parametrize('args', [['D', '4', '2'], ['A', '4', '2', 'nowb'],
                                  ['B', 'none'], ['C']])
def test_entry_point_runs_as_script(args):
    res = subprocess.run(
        [sys.executable, '-m', 'devito_tpu_torch.experiments.stencil_probe7',
         *args, '--device', 'cpu', '--n', '16', '--za', '160'], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={'PATH': '/usr/bin:/bin', 'OMP_NUM_THREADS': '1'})
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith(args[0])


def test_entry_point_needs_cuda_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(DevitoTpuError, match='is_available'):
        P7.main('C')


# -- on the card -----------------------------------------------------------------

#: K10 on one buffer at depths d0..d1, nwin 1, 3 and 4, nsplit 1 and 2
#: (where it divides t0), with and without write-back, on the card, in a
#: process of its own: a wrong byte count would leave a barrier incomplete
#: (the kernel traps after 4 s; the process is killed after TIMEOUT). With
#: ``tiles`` every tile of ``copy_tiles``, else ``copy_tile``'s. Prints
#: [depth, nwin, nsplit, wb, tile, rows [H, H+n) equal to src + 1 (True
#: without write-back), launches counted], or the error for rings that fit
#: no tile.
_COPY_CASES = """
import json, sys, torch
from devito_tpu_torch.experiments import stencil_probe7 as P7
n, t0, za, tiles, d0, d1 = map(int, sys.argv[1:])
src = P7.inputs(n, za, n + t0, 'cuda')
want = src[8:8 + n] + 1.0
rows = []
for depth in range(d0, d1 + 1):
    for nwin in (1, 3, 4):
        for nsplit in [s for s in (1, 2) if t0 % s == 0]:
            for wb in (True, False):
                case = [depth, nwin, nsplit, wb]
                fits = [f[0] for f in P7.copy_tiles(depth, nwin, t0, wb)]
                if not fits:
                    try:
                        P7.copy_windows(src, t0, nwin, wb, nsplit, None, depth)
                        rows.append(case + [None, 'ran'])
                    except ValueError as e:
                        rows.append(case + [None, str(e)])
                for tile in fits if tiles else fits[:1]:
                    before = P7.copy_launches
                    got = P7.copy_windows(src, t0, nwin, wb, nsplit, tile,
                                          depth)
                    torch.cuda.synchronize()
                    rows.append(case + [tile, not wb or torch.equal(
                        got[8:8 + n], want), P7.copy_launches - before])
print(json.dumps(rows))
"""


@pytest.mark.cuda
@pytest.mark.parametrize('n,t0,za,tiles,depths', [
    (22, 2, 60, True, (2, 4)),      # za < 64: one column, boxes 60 wide
    (22, 11, 40, True, (2, 4)),     # t0 odd: nsplit 1 only
    (40, 8, 68, True, (2, 4)),      # the last column's boxes 4 floats wide
    (514, 257, 532, False, (1, 4))])  # t0 > 256: a window is two boxes
def test_copy_kernel_on_card(card, n, t0, za, tiles, depths):
    res = subprocess.run(
        [sys.executable, '-c', _COPY_CASES, str(n), str(t0), str(za),
         str(int(tiles)), *map(str, depths)], cwd=REPO, capture_output=True,
        text=True, timeout=TIMEOUT, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr[-4000:]
    rows = json.loads(res.stdout.splitlines()[-1])
    runs = [r for r in rows if len(r) == 7]
    splits = [s for s in (1, 2) if t0 % s == 0]
    cases = {(d, w, s, wb) for d in range(depths[0], depths[1] + 1)
             for w in (1, 3, 4) for s in splits for wb in (True, False)}

    def fits(c):
        return P7.copy_tiles(c[0], c[1], t0, c[3])

    assert {tuple(r[:4]) for r in rows} == cases
    assert {tuple(r[:4]) for r in runs} == {c for c in cases if fits(c)}
    assert all(r[5] is True and r[6] == 1 for r in runs), runs
    assert all('do not fit' in r[5] for r in rows if len(r) == 6), rows
    if tiles:
        assert len(runs) == sum(len(fits(c)) for c in cases)


@pytest.mark.cuda
@pytest.mark.parametrize('fills,vary', [(f, 0.0) for f in FILL_SETS]
                         + [P7.VARIED])
@pytest.mark.parametrize('n,t0', [(40, 3), (20, 16), (7, 5), (37, 16),
                                  (70, 16), (45, 24)])
def test_resident_kernel_on_card(card, n, t0, fills, vary):
    """The pick by shape -- the unrolled instantiation at t0 = 16, the
    generic one elsewhere -- for every tap ablation, at n that a tile
    divides and n that none does (37, 45, 70), with IEEE division and
    with __fdividef; each launch counted once, under its instantiation."""
    before, picks = P7.resident_launches, dict(P7.resident_picks)
    kind = P7.resident_instantiation(P7.resident_tile(t0)[0])
    for taps in P7.TAPS:
        want = P7.resident_step_reference(t0, 3, taps, fills, n, card, vary)
        for fast in (False, True):
            got = P7.resident_step(t0, 3, taps, fills, n, card, vary,
                                   fast_div=fast)
            torch.cuda.synchronize()
            assert (got - want).abs().max().item() <= \
                TOL * want.abs().max().item()
    assert P7.resident_launches == before + 6
    assert P7.resident_picks[kind] == picks[kind] + 6


@pytest.mark.cuda
@pytest.mark.parametrize('n,t0', [(37, 16), (64, 8)])
def test_resident_tiles_on_card(card, n, t0):
    """Every tile of ``resident_tiles`` (both instantiations, every ROWS
    dividing t0) on the varied field, every tap ablation, with 0 spills in
    the kernel's ptxas report."""
    from devito_tpu_torch.kernels import _nvcc
    fills, vary = P7.VARIED
    for taps in P7.TAPS:
        want = P7.resident_step_reference(t0, 2, taps, fills, n, card, vary)
        for tile, *_ in P7.resident_tiles(t0):
            got = P7.resident_step(t0, 2, taps, fills, n, card, vary, tile)
            torch.cuda.synchronize()
            assert (got - want).abs().max().item() <= \
                TOL * want.abs().max().item(), (taps, tile)
            assert P7.resident_occupancy(t0, taps, tile, device=card) >= 1
    report = _nvcc.build_log.get(_nvcc.fixed_key('probe7_resident'))
    if report is not None:          # built by this process: ptxas ran
        assert re.findall(r'(\d+) bytes spill stores', report)
        assert not any(int(b) for b in re.findall(
            r'(\d+) bytes spill stores', report))


@pytest.mark.cuda
@pytest.mark.parametrize('reps', [1, 7, 16, 300])
def test_empty_kernel_on_card(card, reps):
    """K12 new and into ``out``, then both captured in a CUDA graph and
    replayed: equal to the plain version each time; a launch counted per
    call and per captured call, none per replay."""
    want = P7.empty_grid_reference(reps, card)
    out = torch.zeros(8, 128, device=card)
    before = P7.empty_launches
    assert torch.equal(P7.empty_grid(reps, card), want)
    assert P7.empty_grid(reps, card, out) is out
    assert torch.equal(out, want)
    out.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new = P7.empty_grid(reps, card)
        P7.empty_grid(reps, card, out)
    assert P7.empty_launches == before + 4
    for _ in range(3):
        new.zero_()
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(new, want) and torch.equal(out, want)
    assert P7.empty_launches == before + 4


#: K13/K14 at depths 1-8 and nwin 1, 3 and 4 on one buffer, on the card, in
#: a process of its own: a wrong byte count in the kernel would leave a
#: barrier incomplete (the kernel traps after 4 s; the process is killed
#: after TIMEOUT). With ``tiles`` every tile of ``stream_tiles``, else
#: ``stream_tile``'s. Prints [depth, nwin, tile, equal to the plain version,
#: launches counted], or the error for rings that fit no tile.
_STREAM_CASES = """
import json, sys, torch
from devito_tpu_torch.experiments import stencil_probe7 as P7
n, t0, za, tiles = map(int, sys.argv[1:])
src = P7.inputs(n, za, n + t0, 'cuda')
rows = []
for depth in P7.DEPTHS:
    for nwin in (1, 3, 4):
        fits = [f[0] for f in P7.stream_tiles(depth, nwin, t0)]
        if not fits:
            try:
                P7.stream_windows(src, t0, nwin, depth)
                rows.append([depth, nwin, None, 'ran'])
            except ValueError as e:
                rows.append([depth, nwin, None, str(e)])
        for tile in (fits if tiles else [None]) if fits else []:
            before = P7.stream_launches.get(depth, 0)
            got = P7.stream_windows(src, t0, nwin, depth, tile)
            want = P7.stream_windows_reference(src, t0, nwin, depth)
            torch.cuda.synchronize()
            rows.append([depth, nwin, tile, torch.equal(got, want),
                         P7.stream_launches[depth] - before])
print(json.dumps(rows))
"""
TIMEOUT = 600


@pytest.mark.cuda
@pytest.mark.parametrize('n,t0,za,tiles', [
    (22, 2, 132, True),      # ragged: ny % TY and za % TZ not 0; the
                             # last column's boxes 4 floats wide
    (40, 8, 140, False),
    (514, 257, 532, False)])  # t0 > 256: a window is two boxes, 129 + 128
def test_stream_kernel_on_card(card, n, t0, za, tiles):
    res = subprocess.run(
        [sys.executable, '-c', _STREAM_CASES, str(n), str(t0), str(za),
         str(int(tiles))], cwd=REPO, capture_output=True, text=True,
        timeout=TIMEOUT, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr[-4000:]
    rows = json.loads(res.stdout.splitlines()[-1])
    runs = [r for r in rows if len(r) == 5]
    assert {(r[0], r[1]) for r in rows} == {
        (d, w) for d in P7.DEPTHS for w in (1, 3, 4)}
    assert {r[0] for r in runs} == (set(P7.DEPTHS) if t0 < 64 else {1, 2, 3})
    assert all(r[3] is True and r[4] == 1 for r in runs), runs
    assert all('do not fit' in r[3] for r in rows if len(r) == 4), rows


@pytest.mark.cuda
def test_probe_entry_points_on_card(card, capsys):
    for which, args in (('A', ('8', '2', 'wb')), ('B', ('full',)), ('C', ()),
                        ('D', ('8', '2')), ('E', ('8', '2', '4'))):
        rec = P7.main(which, *args, n=64, za=128)
        assert rec['device'] == torch.cuda.get_device_name(card)
    assert 'of the bound' in capsys.readouterr().out
