"""K2 (the self-test, devito_tpu_torch/kernels/stencil.py), K15
(devito_tpu_torch/experiments/stencil_probe9.py) and K9 and K8
(devito_tpu_torch/experiments/stencil_probe6.py) against the TPU kernels
they port, which run here in Pallas interpret mode: the tests swap
``pallas_call`` for a wrapper that passes ``interpret=True`` and keeps the
callable it returns, then call that callable on seeded numpy inputs.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the CUDA kernels are held against those versions by the ``cuda``-marked
tests, on the card. Tolerances are 1e-5 * max|reference| (fp32 sums taken
in another order) unless a comparison is exact."""

import importlib
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu.compiler.executor import _load_pallas
from devito_tpu_torch.exceptions import CompilationError, DevitoTpuError
from devito_tpu_torch.experiments import stencil_probe6 as P6
from devito_tpu_torch.experiments import stencil_probe9 as P9
from devito_tpu_torch.kernels import stencil as K

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pallas_call`` made while the test runs is built with
    ``interpret=True``; the list collects the callables, in order. The
    test runs in JAX's default 32-bit mode, which the probes were written
    for (importing devito_tpu turns on 64-bit mode)."""
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
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device('cuda', 0)


def _jax_probe(name):
    return importlib.import_module(f'experiments.{name}')


def _close(got, ref):
    return np.abs(got - ref).max() <= TOL * np.abs(ref).max()


# -- K2 ------------------------------------------------------------------------

def _window_sum_formula(x):
    """pallas_backend.py:95-98 over both tiles, in numpy."""
    H, T, NZ, ZP = 2, 4, 16, 128
    out = np.zeros((2 * T, T, ZP), np.float32)
    for i in range(2):
        w = x[i * T:i * T + T + 2 * H, :T + 2 * H]
        out[i * T:(i + 1) * T, :, :NZ] = (w[H:-H, H:-H, H:H + NZ]
                                          + w[H + 1:H + 1 + T, H:-H,
                                              H + 1:H + 1 + NZ])
    return out


def test_selftest_matches_pallas_kernel(interpret, monkeypatch):
    pb = _load_pallas()
    monkeypatch.setattr(pb, '_backend_ok', None)
    assert pb.validate_backend(interpret=True) is True
    call = interpret[-1]
    ones = np.ones(K.SELFTEST_SHAPE, np.float32)
    got = K.selftest_window_sum_reference(torch.from_numpy(ones)).numpy()
    assert np.array_equal(got, np.asarray(call(jnp.asarray(ones))))
    x = np.random.default_rng(2).standard_normal(
        K.SELFTEST_SHAPE).astype(np.float32)
    want = _window_sum_formula(x)
    got = K.selftest_window_sum(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(call(jnp.asarray(x))), want)


def test_validate_backend_passes_once_per_call():
    before, launches = K.selftests, K.selftest_launches
    assert K.validate_backend('cpu') is True
    assert K.selftests == before + 1
    assert K.selftest_launches == launches      # CPU: the plain version ran
    assert torch.device('cpu') in K.validated


@pytest.mark.parametrize('fault', ['value', 'padding lane', 'nan'])
def test_validate_backend_raises_on_wrong_answer(fault, monkeypatch):
    plain = K.selftest_window_sum_reference

    def broken(x):
        out = plain(x)
        if fault == 'value':
            out[7, 3, 15] = 2.0001
        elif fault == 'padding lane':
            out[0, 0, 16] = 1.0
        else:
            out[4, 1, 0] = float('nan')
        return out

    monkeypatch.setattr(K, 'selftest_window_sum_reference', broken)
    monkeypatch.setattr(K, 'validated', set())
    with pytest.raises(CompilationError, match='wrong answer'):
        K.validate_backend('cpu')
    assert not K.validated


def test_selftest_rejects_other_inputs():
    with pytest.raises(ValueError, match='shape'):
        K.selftest_window_sum(torch.ones(4, 4, 4))
    with pytest.raises(ValueError, match='no self-test kernel'):
        K.selftest_window_sum(torch.ones(K.SELFTEST_SHAPE, device='meta'))


@pytest.mark.parametrize('out', [
    torch.empty(8, 4, 64), torch.empty(8, 4, 128, dtype=torch.float64),
    torch.empty(8, 128, 4).transpose(1, 2), torch.empty(8, 4, 128,
                                                        device='meta')])
def test_selftest_checks_out(out):
    with pytest.raises(ValueError, match='out'):
        K.selftest_window_sum(torch.ones(K.SELFTEST_SHAPE), out)


def test_selftest_into_out_on_cpu():
    """On the CPU ``out`` gets the plain version's values, stale lanes
    zeroed; no launch is counted."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        K.SELFTEST_SHAPE).astype(np.float32))
    out = torch.full(K.SELFTEST_OUT, 5.0)
    launches = K.selftest_launches
    assert K.selftest_window_sum(x, out) is out
    assert np.array_equal(out.numpy(), _window_sum_formula(x.numpy()))
    assert K.selftest_launches == launches


# -- K15 -----------------------------------------------------------------------

def _ring_inputs(N, seed):
    rng = np.random.default_rng(seed)
    u0 = rng.standard_normal((N + 16, N + 16, N)).astype(np.float32)
    u1 = rng.standard_normal((N + 16, N, N)).astype(np.float32)
    vp = (1.5 + np.abs(rng.standard_normal((N + 16, N, N)))).astype(
        np.float32)
    dp = (0.05 * np.abs(rng.standard_normal((N + 16, N, N)))).astype(
        np.float32)
    return u0, u1, vp, dp


def test_ring_step_matches_pallas_kernel(interpret):
    N, TX, c = 24, 8, 0.01
    call = _jax_probe('stencil_probe9').make_kernel(N, TX)
    arrs = _ring_inputs(N, 15)
    ref = np.asarray(call(jnp.asarray([c], np.float32),
                          *map(jnp.asarray, arrs)))
    before = P9.launches
    got = P9.ring_step(*map(torch.from_numpy, arrs), c, TX).numpy()
    assert got.shape == ref.shape == (N, N, N)
    assert _close(got, ref)
    assert P9.launches == before


def test_ring_step_checks_arguments():
    u0, u1, vp, dp = map(torch.from_numpy, _ring_inputs(8, 0))
    with pytest.raises(ValueError, match='does not divide'):
        P9.ring_step(u0, u1, vp, dp, 1e-4, TX=3)
    with pytest.raises(ValueError, match='expected'):
        P9.ring_step(u0, u1[:, :4].contiguous(), vp, dp, 1e-4, TX=8)
    with pytest.raises(TypeError, match='fp32'):
        P9.ring_step(u0.double(), u1, vp, dp, 1e-4, TX=8)
    meta = [t.to('meta') for t in (u0, u1, vp, dp)]
    with pytest.raises(ValueError, match='no ring-step kernel'):
        P9.ring_step(*meta, 1e-4, TX=8)


# -- K9 ------------------------------------------------------------------------

@pytest.fixture
def small_probe6(monkeypatch):
    """stencil_probe6 with its module sizes cut to N, NY, ZA = 32, 48, 64."""
    p6 = _jax_probe('stencil_probe6')
    for k, v in dict(N=32, NY=48, ZA=64).items():
        monkeypatch.setattr(p6, k, v)
    return p6


def _step_inputs(seed):
    rng = np.random.default_rng(seed)
    ut, utm1, tgt = (rng.standard_normal((48, 48, 64)).astype(np.float32)
                     for _ in range(3))
    vp = (1.5 + np.abs(rng.standard_normal((48, 48, 64)))).astype(np.float32)
    damp = (0.05 * np.abs(rng.standard_normal((48, 48, 64)))).astype(
        np.float32)
    return ut, utm1, vp, damp, tgt


@pytest.mark.parametrize('taps,out_mode,zin_full', [
    (taps, mode, True) for taps in P6.TAPS for mode in P6.OUT_MODES]
    + [('full', 'fullz', False)])
def test_inplace_step_matches_pallas_kernel(taps, out_mode, zin_full,
                                            small_probe6, interpret):
    t0, N, H = 8, 32, 8
    arrs = _step_inputs(9)
    call = small_probe6.make_step(t0, zin_full, out_mode, taps)
    ref = np.asarray(call(*map(jnp.asarray, arrs)))
    tgt = torch.from_numpy(arrs[4].copy())
    out = P6.inplace_step(*map(torch.from_numpy, arrs[:4]), tgt, t0,
                          out_mode, taps, zin_full)
    assert out is tgt                      # written in place
    got = tgt.numpy()
    inner = (slice(H, H + N),) * 3
    assert np.abs(got - ref).max() <= TOL * np.abs(ref[inner]).max()
    # x-halo rows keep the target's content, in both packages
    for sl in (slice(0, H), slice(H + N, None)):
        assert np.array_equal(got[sl], arrs[4][sl])
        assert np.array_equal(ref[sl], arrs[4][sl])
    rows = got[H:H + N].copy()
    rows[:, H:H + N, H:H + N] = 0.0
    if out_mode == 'fullz':
        assert not rows.any()               # y/z halo zeroed
    else:
        kept = arrs[4][H:H + N].copy()
        kept[:, H:H + N, H:H + N] = 0.0
        assert np.array_equal(rows, kept)   # y/z halo untouched


def test_ref_step_matches_jax_reference(small_probe6):
    arrs = _step_inputs(3)[:4]
    want = np.asarray(small_probe6.ref_step(*map(jnp.asarray, arrs)))
    got = P6.ref_step(*map(torch.from_numpy, arrs)).numpy()
    assert _close(got, want)


def test_inplace_step_checks_arguments():
    ut, utm1, vp, damp, tgt = map(torch.from_numpy, _step_inputs(0))
    with pytest.raises(ValueError, match='does not divide'):
        P6.inplace_step(ut, utm1, vp, damp, tgt, 5)
    with pytest.raises(ValueError, match='u\\[t\\] itself'):
        P6.inplace_step(ut, utm1, vp, damp, ut, 8)
    with pytest.raises(ValueError, match='taps'):
        P6.inplace_step(ut, utm1, vp, damp, tgt, 8, taps='x')
    with pytest.raises(ValueError, match='expected'):
        P6.inplace_step(ut[:, :40].contiguous(), utm1, vp, damp, tgt, 8)
    meta = [t.to('meta') for t in (ut, utm1, vp, damp, tgt)]
    with pytest.raises(ValueError, match='no in-place step kernel'):
        P6.inplace_step(*meta, 8)


@pytest.mark.parametrize('case', ['float64', 'shape', 'za', 'device'])
def test_inplace_step_checks_types_and_shapes(case):
    ut, utm1, vp, damp, tgt = map(torch.from_numpy, _step_inputs(0))
    if case == 'float64':
        with pytest.raises(TypeError, match='fp32'):
            P6.inplace_step(ut, utm1.double(), vp, damp, tgt, 8)
    elif case == 'shape':
        with pytest.raises(ValueError, match='differ in shape'):
            P6.inplace_step(ut, utm1, vp, damp, tgt[:, :, :60].contiguous(),
                            8)
    elif case == 'za':                   # ZA < NY
        small = [t[:, :, :40].contiguous() for t in (ut, utm1, vp, damp, tgt)]
        with pytest.raises(ValueError, match=r'ZA >= N\+16'):
            P6.inplace_step(*small, 8)
    else:
        with pytest.raises(ValueError, match='different devices'):
            P6.inplace_step(ut, utm1, vp, damp.to('meta'), tgt, 8)


def test_inplace_rows_put_the_region_at_h():
    """K9's rows for the streaming engine: the target, u[t] (staged), u[t-1],
    vp and damp (centre), each its own (48, 48, 64) allocation with the
    region's first point at (8, 8, 8)."""
    ts = [torch.from_numpy(a) for a in _step_inputs(1)]
    ut, utm1, vp, damp, tgt = ts
    ptrs, dims, org = P6._rows(ut, utm1, vp, damp, tgt)
    assert list(ptrs) == [t.data_ptr() for t in (tgt, ut, utm1, vp, damp)]
    assert list(dims) == [48, 48, 64] * 5 and list(org) == [8, 8, 8] * 5


@pytest.mark.parametrize('case', ['unaligned', 'za % 4', 'not contiguous'])
def test_inplace_rows_check_alignment(case):
    ut, utm1, vp, damp, tgt = map(torch.from_numpy, _step_inputs(2))
    if case == 'unaligned':       # starts 4 bytes into its storage
        ut = torch.zeros(48 * 48 * 64 + 1)[1:].view(48, 48, 64)
    elif case == 'za % 4':
        ut, utm1, vp, damp, tgt = (torch.zeros((48, 48, 50))
                                   for _ in range(5))
    else:
        vp = vp.transpose(0, 1)
    with pytest.raises(ValueError, match='16-byte'):
        P6._rows(ut, utm1, vp, damp, tgt)


def test_inplace_tile_fits_two_ctas_per_sm():
    """K9's unit is compiled for _stream.TILE, K1's fp32 tile, which
    stream_tile fits with _stream.X_CHUNK at two or more CTAs an SM for one
    staged and three centre groups of radius 4, with TMA boxes starting at
    z = 4 (16 bytes: the staged origin 8 less the radius)."""
    from devito_tpu_torch.experiments import _stream as S
    src = (REPO / 'devito_tpu_torch/csrc/probe6_stream.cu').read_text()
    ty, tz, py, stages = map(int, re.search(
        r'StreamTile<float, 1, 3, R, R, R, (\d+), (\d+), (\d+), (\d+)>',
        src).groups())
    fit = K.stream_tile(np.float32, S.RADII, 1, 3, S.TILE + (S.X_CHUNK,))
    assert (ty, tz, py, stages) == S.TILE and S.X_CHUNK in S.X_CHUNKS
    assert fit['ctas_per_sm'] >= 2 and fit['threads'] == 256
    assert (P6.H - S.RADII[2]) * 4 % 16 == 0 and P6.H * 4 % 16 == 0


# -- K8 ------------------------------------------------------------------------

def test_window_copy_matches_pallas_kernel(interpret, monkeypatch, capsys):
    p6 = _jax_probe('stencil_probe6')
    for k, v in dict(N=256, NY=264, ZA=272).items():
        monkeypatch.setattr(p6, k, v)
    monkeypatch.setattr(p6, 'timeit', lambda fn, *a, **k: (1.0, fn(*a)))
    p6.p2_misaligned_dma()
    assert capsys.readouterr().out.count('correct=True') == 3
    calls = interpret[-3:]
    src = np.random.default_rng(8).standard_normal(
        (264, 264, 272)).astype(np.float32)
    wins = P6.p2_windows(256)
    assert [w for _, w in wins] == [((0, 64), (8, 256), (z, n)) for z, n in
                                    ((0, 256), (8, 256), (0, 272))]
    for call, (label, window) in zip(calls, wins):
        ref = np.asarray(call(jnp.asarray(src)))
        got = P6.window_copy(torch.from_numpy(src), window).numpy()
        sl = tuple(slice(a, a + n) for a, n in window)
        assert np.array_equal(got[sl], ref[sl]), label
        assert np.array_equal(got[sl], src[sl]), label


def test_window_copy_checks_arguments():
    src = torch.zeros(8, 8, 8)
    with pytest.raises(ValueError, match='outside'):
        P6.window_copy(src, ((0, 8), (4, 8), (0, 8)))
    with pytest.raises(ValueError, match='no window-copy kernel'):
        P6.window_copy(src.to('meta'), ((0, 8), (0, 8), (0, 8)))


# -- the entry points on the CPU -------------------------------------------------

def test_probe9_main_on_cpu(capsys):
    before = P9.launches
    res = P9.main(16, 8, 2, device='cpu')
    out = capsys.readouterr().out
    err, tol = map(float, re.search(
        r'max abs err vs plain version: (\S+) \(tolerance (\S+)\)',
        out).groups())
    assert err <= tol and res['err'] == err
    assert re.search(r'N=16 TX=8: \S+ ms/step, \S+ GPts/s', out)
    assert P9.launches == before


def test_probe6_main_on_cpu(capsys):
    before = (P6.inplace_launches, P6.window_copy_launches)
    res = P6.main(4, device='cpu', n=16)
    out = capsys.readouterr().out
    assert out.count('correct=True') == 3 and 'correct=False' not in out
    assert 'P1 read+write' in out
    p3 = re.findall(r'P3 t0=(\d+) taps=(\w+): max\|err\|=(\S+)', out)
    assert [(a, b) for a, b, _ in p3] == [
        (t, taps) for t in ('4', '8') for taps in P6.TAPS]
    assert all(r['err'] <= r['tol'] for r in res['p3'])
    assert (P6.inplace_launches, P6.window_copy_launches) == before


@pytest.mark.parametrize('module,args', [
    ('stencil_probe9', ['16', '8', '1']), ('stencil_probe6', ['4', '--n', '8'])])
def test_entry_points_run_as_scripts(module, args):
    res = subprocess.run(
        [sys.executable, '-m', f'devito_tpu_torch.experiments.{module}',
         *args, '--device', 'cpu'], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={'PATH': '/usr/bin:/bin',
                                     'OMP_NUM_THREADS': '1'})
    assert res.returncode == 0, res.stderr
    assert 'ms' in res.stdout


@pytest.mark.parametrize('run', ['probe9', 'probe6'])
def test_entry_points_need_cuda_when_asked(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(DevitoTpuError, match='is_available'):
        if run == 'probe9':
            P9.main(16, 8, 1)
        else:
            P6.main(4, n=8)


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_selftest_kernel_on_card(card, monkeypatch):
    """K2 bit-equal to its plain version on random input and on ones, new
    and into ``out``, one launch counted a call; then validate_backend."""
    out = torch.full(K.SELFTEST_OUT, 7.0, device=card)
    for x in (torch.randn(K.SELFTEST_SHAPE, device=card),
              torch.ones(K.SELFTEST_SHAPE, device=card)):
        want = K.selftest_window_sum_reference(x)
        before = K.selftest_launches
        got = K.selftest_window_sum(x)
        torch.cuda.synchronize()
        assert K.selftest_launches == before + 1
        assert torch.equal(got, want)
        assert K.selftest_window_sum(x, out) is out
        torch.cuda.synchronize()
        assert K.selftest_launches == before + 2
        assert torch.equal(out, want)
        out.fill_(7.0)
    monkeypatch.setattr(K, 'validated', set())
    runs = K.selftests
    assert K.validate_backend(card) is True
    assert card in K.validated and K.selftests == runs + 1


@pytest.mark.cuda
@pytest.mark.parametrize('N,TX', [(64, 16), (96, 32), (32, 1)])
def test_ring_kernel_on_card(card, N, TX):
    arrs = [torch.from_numpy(a).to(card) for a in _ring_inputs(N, N)]
    before = P9.launches
    got = P9.ring_step(*arrs, 0.01, TX)
    ref = P9.ring_step_reference(*arrs, 0.01)
    torch.cuda.synchronize()
    assert P9.launches == before + 1
    assert (got - ref).abs().max().item() <= TOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize('za', [48, 64])
@pytest.mark.parametrize('out_mode', P6.OUT_MODES)
@pytest.mark.parametrize('taps', P6.TAPS)
def test_inplace_kernel_on_card(card, taps, out_mode, za):
    g = torch.Generator(device=card).manual_seed(6)
    ut, utm1, tgt = (torch.randn((48, 48, za), generator=g, device=card)
                     for _ in range(3))
    vp = 1.5 + torch.rand((48, 48, za), generator=g, device=card)
    damp = 0.05 * torch.rand((48, 48, za), generator=g, device=card)
    ref = P6.inplace_step_reference(ut, utm1, vp, damp, tgt.clone(),
                                    out_mode, taps)
    before = P6.inplace_launches
    for t0 in (8, 16, 32):
        got = P6.inplace_step(ut, utm1, vp, damp, tgt.clone(), t0, out_mode,
                              taps)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= \
            TOL * ref.abs().max().item()
    assert P6.inplace_launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize('n,za', [(45, 64), (37, 60), (50, 80)])
def test_inplace_kernel_ragged_on_card(card, n, za):
    """K9 where no tile or x-chunk divides N, with ZA > NY: both output
    modes and every ablation against the plain version, the x-halo rows
    untouched, each x-chunk of _stream.X_CHUNKS bit-equal to the pick."""
    from devito_tpu_torch.experiments import _stream as S
    NY = n + 16
    g = torch.Generator(device=card).manual_seed(n)
    ut, utm1, tgt = (torch.randn((NY, NY, za), generator=g, device=card)
                     for _ in range(3))
    vp = 1.5 + torch.rand((NY, NY, za), generator=g, device=card)
    damp = 0.05 * torch.rand((NY, NY, za), generator=g, device=card)
    for out_mode in P6.OUT_MODES:
        for taps in P6.TAPS:
            ref = P6.inplace_step_reference(ut, utm1, vp, damp, tgt.clone(),
                                            out_mode, taps)
            got = P6.inplace_step(ut, utm1, vp, damp, tgt.clone(), n,
                                  out_mode, taps)
            torch.cuda.synchronize()
            assert (got - ref).abs().max().item() <= \
                TOL * ref.abs().max().item()
            for sl in (slice(0, 8), slice(8 + n, None)):
                assert torch.equal(got[sl], tgt[sl])
            for xc in S.X_CHUNKS:
                assert torch.equal(P6.inplace_kernel(
                    ut, utm1, vp, damp, tgt.clone(), out_mode, taps, xc), got)


@pytest.mark.cuda
def test_inplace_kernel_builds_clean_on_card(card):
    """K9's kernels build without spills (when ptxas ran in this process)
    and the CUDA runtime fits two or more CTAs of each on an SM."""
    from devito_tpu_torch.experiments import _stream as S
    from devito_tpu_torch.kernels import _nvcc
    _nvcc.fixed('probe6_stream')
    log = _nvcc.build_log.get(_nvcc.fixed_key('probe6_stream'))
    if log is not None:
        assert 'bytes spill' in log and not re.search(
            r'[1-9]\d* bytes spill', log), log
    for taps in range(3):
        assert S.occupancy('probe6_stream', taps) >= 2


@pytest.mark.cuda
def test_window_copy_kernel_on_card(card):
    src = torch.randn((272, 272, 272), device=card)
    before = P6.window_copy_launches
    for _, window in P6.p2_windows(256):
        got = P6.window_copy(src, window)
        sl = tuple(slice(a, a + n) for a, n in window)
        assert torch.equal(got[sl], src[sl])
    assert P6.window_copy_launches == before + 3


@pytest.mark.cuda
def test_entry_points_on_card(card, capsys):
    assert P9.main(64, 16, 2)['err'] >= 0
    P6.main(8, n=32)
    assert capsys.readouterr().out.count('correct=True') == 3


# -- the build helper ------------------------------------------------------------

def test_stencil_build_key_unchanged():
    """K1's build key (of its point design, which this 3-D star takes
    only on request) is still the hash of stencil.cuh, the generated
    source and the nvcc flags, as before the helper was taken out."""
    import hashlib
    from devito_tpu_torch.ir.lowering import lower_expressions
    from devito_tpu_torch.kernels import _nvcc
    g = dt.Grid(shape=(8, 9, 10), extent=(7., 8., 9.))
    u = dt.TimeFunction(name='u', grid=g, time_order=2, space_order=8)
    eq = dt.Eq(u.forward, dt.solve(u.dt2 - u.laplace, u.forward))
    (item,) = [i for i in lower_expressions([eq], subs=g.spacing_map)
               .all_items if getattr(i, 'kind', '') == 'dense']
    plan = K.plan_for(item, _design='point')
    text = ((REPO / 'devito_tpu_torch/csrc/stencil.cuh').read_text()
            + plan.source + ' '.join(_nvcc._NVCC_FLAGS))
    assert plan.key == hashlib.sha256(text.encode()).hexdigest()[:20]


def test_failed_build_raises():
    from devito_tpu_torch.kernels import _nvcc
    with pytest.raises(CompilationError, match='nvcc'):
        _nvcc.build('0' * 20, 'broken', 'this is not CUDA\n')
