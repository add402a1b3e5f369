"""The bookkeeping of chip_smoke.py that runs without the card: every probe
kernel's launch counter is found, read and set to 0, and the byte counts
of its bounds."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as C  # noqa: E402
from devito_tpu_torch.experiments import stencil_probe7 as P7  # noqa: E402
from devito_tpu_torch.experiments import stencil_probe9 as P9  # noqa: E402

torch.set_num_threads(1)


def test_every_probe_kernel_has_a_counter():
    main_path = {'stencil_update', 'selftest_window_sum'}
    assert set(C.PROBE_COUNTERS) == {k[0] for k in C.KERNELS} - main_path
    assert len(C.KERNELS) == 15


@pytest.mark.parametrize('name', sorted(C.PROBE_COUNTERS))
def test_probe_launches_reads_and_zeroes(name, monkeypatch):
    mod, attr, depth = C.PROBE_COUNTERS[name]
    C.probe_launches(zero=True)      # imports every probe module
    m = sys.modules[f'devito_tpu_torch.experiments.{mod}']
    monkeypatch.setattr(m, attr, 7 if depth is None else {depth: 7, 8: 1})
    counts = C.probe_launches()
    assert counts.pop(name) == 7 and not any(counts.values())
    assert not any(C.probe_launches(zero=True).values())


def test_cpu_probes_leave_the_counts_at_zero():
    C.probe_launches(zero=True)
    P9.main(16, 8, 1, 'cpu')
    P7.main('E', '4', '2', '3', device='cpu', n=16, za=160)
    assert not any(C.probe_launches().values())


def test_star_points():
    # the interior and 4-deep slabs on each face of a 2^3 cube
    assert C.star_points(2) == 8 + 6 * 4 * 4
    assert C.star_points(2, faces=4) == 8 + 4 * 4 * 4


def test_every_record_has_the_point_design_key():
    assert 'point_ms' in C.RECORD_KEYS
    assert C.KERNELS[0][:3] == ('stencil_update',
                                'devito_tpu_torch/csrc/stencil_stream.cuh',
                                'experiments/pallas_backend.py:303')


@pytest.mark.parametrize('tile', C.FULL['sweep'])
def test_sweep_tiles_fit_the_headline_equation(tile):
    from devito_tpu_torch import switchconfig
    from devito_tpu_torch.kernels import stencil as K
    with switchconfig(device='cpu'):
        op, _ = C.operator_for('acoustic', (12, 13, 14), 8, np.float32)
    plan = K.plan_for(op.kernel_plans[0][1].eq, _tile=tile)
    assert plan.design == 'stream' and plan.tile['ctas_per_sm'] >= 2
    assert tuple(plan.tile[k] for k in ('ty', 'tz', 'py', 'stages', 'tx')) \
        == tile


def test_inverse_phase_runs_on_the_cpu():
    """Phase 9 at a tiny size on the CPU, where no kernel launches: every
    path's counts stay at 0, the Revolver takes the optimal count + 1, and
    the fp64 checks (dot tests, checkpointed against full-save gradient)
    hold."""
    from devito_tpu_torch import Function, switchconfig
    sizes = dict(C.FULL, fwd_n=16, fwd_nbl=4, fwd_tn=60., fwd_nrec=8,
                 inv_n=12, inv_tn=60., inv_nrec=6, inc_steps=3)
    record = {'launches': 0, 'launches_by_design': {'stream': 0, 'point': 0}}
    with switchconfig(device='cpu'):
        solver = C.forward_solver(16, 4, 60., 8)
        shot = np.array(solver.forward()[0].data)
        small = C.forward_solver(12, 4, 60., 6, np.float64)
        vp0 = Function(name='vp0', grid=solver.model.grid, space_order=8)
        C.inverse(torch.device('cpu'), sizes, solver, shot, vp0, small,
                  record)
    inv = record['inverse']
    assert record['launches'] == 0 and set(record['launches_by_path']) == \
        {'adjoint', 'smooth', 'born', 'gradient'}
    g = inv['gradient']
    assert g['forward_steps'] == g['optimal_forward_count'] + 1
    assert inv['fp64']['ck_bit_equal'] and abs(inv['fp64']['dot_F']) < 1e-11


def test_host_us_per_call_counts_every_call():
    calls = []
    us = C.host_us_per_call(lambda: calls.append(1), torch.device('cpu'),
                            calls=5)
    assert len(calls) == 6 and us >= 0


def test_probe7_phase_runs_on_the_cpu():
    """Phase 8 at N=112 (ZA = NY = 128, the least the D and E sums take) on
    the CPU, where every probe runs its plain version: no kernel launches,
    and K13/K14's records get the sweep's tile, shared bytes and nwin 1
    time, with every tile of ``stream_tiles`` at depths 2-4, nwin 1 and 4;
    K10's its tile, the write-back / nwin ablation and the rows of every
    tile of ``copy_tiles``; K12's its calls' times."""
    from devito_tpu_torch import switchconfig
    records = [{'name': n, 'route': 'cuda', 'source': s, 'replaces': r}
               for n, s, r, _ in C.KERNELS]
    sizes = dict(C.FULL, p7_n=112, p7_sizes=(112,), reps=1, plain_reps=1)
    dev = torch.device('cpu')
    C.probe_launches(zero=True)
    with switchconfig(device='cpu'):
        C.probe7(dev, sizes, torch.Generator(device=dev).manual_seed(1),
                 records, 1000.0)
    assert not any(C.probe_launches().values())
    by = {r['name']: r for r in records}
    for name, depths in (('stream_windows_depth2', {2}),
                         ('stream_windows_depth3', {3, 4})):
        rec = by[name]
        d = min(depths)
        assert rec['launches'] == 0 and rec['max_abs_err'] == 0.0
        assert (rec['tile'], rec['smem_bytes']) == P7.stream_tile(d, 4, 16)[:2]
        assert rec['nwin1_tile'] == P7.stream_tile(d, 1, 16)[0]
        assert rec['nwin1_ms'] > 0 and rec['l2_to_shared_gbs'] > 0
        assert sorted((r['depth'], r['nwin'], r['tile'])
                      for r in rec['sweep']) == sorted(
            (dd, w, t) for dd in depths for w in (1, 4)
            for t, _, _ in P7.stream_tiles(dd, w, 16))
    # K10: every tile of copy_tiles at depths 2-4, nwin 1 and 4, with and
    # without write-back; the record at COPY_DEPTH's chosen tiles
    k10 = by['copy_windows']
    d = P7.COPY_DEPTH
    assert k10['launches'] == 0 and k10['depth'] == d
    assert k10['stages'] == P7.COPY_STAGES
    assert (k10['tile'], k10['smem_bytes']) == P7.copy_tile(d, 4, 16)[:2]
    assert set(k10['ablation']) == {'wb nwin 1', 'wb nwin 4', 'nowb nwin 1',
                                    'nowb nwin 4'}
    assert sorted((r['depth'], r['nwin'], r['writeback'], r['tile'])
                  for r in k10['sweep']) == sorted(
        (dd, w, wb, t) for dd in (2, 3, 4) for w in (1, 4)
        for wb in (True, False) for t, _, _ in P7.copy_tiles(dd, w, 16, wb))
    assert all(r['ms'] > 0 and r['ctas_per_sm'] is None
               for r in k10['sweep'])
    # K12: the calls timed on the CPU; no graph, no ctypes entry there
    assert set(by['empty_grid']['us_per_call']) == {
        'add', 'alloc', 'torch.full', 'out', 'fill_'}
    assert by['empty_grid']['library_call'] == 'out.fill_(reps - 1)'


def test_probe_phases_6_and_7_run_on_the_cpu():
    """Phases 6 and 7 at tiny sizes on the CPU, where every probe runs its
    plain version: no kernel launches; K9's, K3's, K4's to K7's records
    get their x-chunk (no sweep and no CTAs per SM off the card), K4's to
    K7's also their tile and frame bytes (no times of the frame or without
    it off the card), K3 and K6 into up's interior are held bit-equal to
    K3 and K6 into a new tensor, and K4 and K5 into up itself likewise."""
    from devito_tpu_torch.experiments import _tiled as T
    from devito_tpu_torch import switchconfig
    from devito_tpu_torch.experiments import _stream as S
    records = [{'name': n, 'route': 'cuda', 'source': s, 'replaces': r}
               for n, s, r, _ in C.KERNELS]
    records[0].update(ms=1.0, plain_ms=1.0)
    sizes = dict(C.FULL, p9_n=16, p9_tx=8, p9_steps=1, p6_n=16, p6_t0=4,
                 big_n=16, reps=1, plain_reps=1,
                 tiled={'halo_tiles_step': (16, 1, 8, 8),
                        'neighbour_blocks_step': (40, 1, 8),
                        'neighbour_blocks_zeroed_step': (16, 1, 4),
                        'tiles_step': (24, 1, 8, 16),
                        'xtiles_step': (16, 1, 8)})
    dev = torch.device('cpu')
    C.probe_launches(zero=True)
    with switchconfig(device='cpu'):
        gen = torch.Generator(device=dev).manual_seed(1)
        ceiling = C.probes(dev, sizes, gen, records)
        C.tiled_probes(dev, sizes, gen, records, ceiling)
    assert not any(C.probe_launches().values())
    by = {r['name']: r for r in records}
    for name in ('inplace_step', 'halo_tiles_step'):
        rec = by[name]
        assert rec['x_chunk'] == S.X_CHUNK and rec['x_chunk_sweep'] == []
        assert rec['ctas_per_sm'] is None and rec['max_abs_err'] == 0.0
        assert rec['bound_ms'] > 0 and rec['launches'] == 0
    assert by['halo_tiles_step']['in_place_bit_equal']
    assert by['inplace_step']['ms_interior'] > 0
    for name, frame in (('tiles_step', 16 * 16 * (128 - 16)),
                        ('xtiles_step', 32 * 24 * 128 - 16 ** 3)):
        rec = by[name]
        assert rec['x_chunk'] == S.X_CHUNK and rec['x_chunk_sweep'] == [] \
            and rec['tile'] == list(T.STREAM_TILE) \
            and rec['tile_sweep'] == []
        assert rec['ctas_per_sm'] is None and rec['max_abs_err'] == 0.0
        assert all(rec[k] is None for k in (
            'ms_interior', 'frame_device_ms', 'engine_device_ms',
            'frame_library_device_ms', 'frame_fill_device_ms'))
        assert rec['frame_bytes'] == 4 * frame and rec['launches'] == 0
    assert by['tiles_step']['in_place_bit_equal']
    for name, frame in (('neighbour_blocks_step', 24 * 24 * 128 - 24 * 256),
                        ('neighbour_blocks_zeroed_step',
                         24 * 24 * 128 - 16 ** 3)):
        rec = by[name]
        assert rec['x_chunk'] == S.X_CHUNK and rec['x_chunk_sweep'] == [] \
            and rec['tile'] == list(T.STREAM_TILE) \
            and rec['tile_sweep'] == [] and rec['out_up_bit_equal']
        assert rec['ctas_per_sm'] is None and rec['max_abs_err'] == 0.0
        assert all(rec[k] is None for k in (
            'ms_interior', 'frame_device_ms', 'engine_device_ms',
            'frame_library_device_ms', 'frame_fill_device_ms'))
        assert rec['frame_bytes'] == 4 * frame and rec['launches'] == 0
    assert by['neighbour_blocks_step']['edge_device_ms'] is None
    assert by['neighbour_blocks_step']['edge_rows_t'] == 8


_SASS = """
        Function : _ZN12_GLOBAL__N_115resident_kernelILi2ELi4ELb0EEEvPfS1_NS_4ArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FADD R5, R4, R6 ;
        /*0030*/                   LDS.128 R8, [R2+0x10] ;
        /*0040*/                   FCHK P1, R5, R8 ;
        /*0050*/               @!P1 BRA 0x90 ;
        /*0060*/                   MOV R10, R5 ;
        /*0070*/                   CALL.REL.NOINC 0x200 ;
        /*0080*/                   MOV R5, R10 ;
        /*0090*/                   FFMA R6, R5, R5, R4 ;
        /*00a0*/               @P0 BRA 0x10 ;
        /*00b0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_115resident_kernelILi2ELi8ELb0EEEvPfS1_NS_4ArgsE
        /*0000*/                   EXIT ;
"""


def test_sass_loop_counts_the_issued_loop(monkeypatch):
    """The repetition loop is the longest backward branch's span (0x10 to
    0xa0: 10 instructions); the 3 that a forward branch skips over a CALL
    (a division's slow path) are not issued; 2 LDS.128 in it. A kernel
    without a loop, or no cuobjdump, gives None."""
    import shutil
    monkeypatch.setattr(shutil, 'which', lambda exe: sys.executable)
    monkeypatch.setattr(C.subprocess, 'run', lambda *a, **k: type(
        'R', (), {'stdout': _SASS})())
    assert C.sass_loop('k.so', 'resident_kernelILi2ELi4ELb0E') == (10, 7, 2)
    assert C.sass_loop('k.so', 'resident_kernelILi2ELi8ELb0E') is None
    monkeypatch.setattr(shutil, 'which', lambda exe: None)
    monkeypatch.setattr(C.Path, 'exists', lambda self: False)
    assert C.sass_loop('k.so', 'resident_kernelILi2ELi4ELb0E') is None


@pytest.mark.parametrize('tile,t0,taps,words', [
    ((16, 4), 16, 'full', 16.0), ((8, 8), 16, 'full', 15.0),
    ((8, 0), 16, 'full', 14.5), ((4, 2), 16, 'z', 6), ((4, 2), 16, 'none', 4)])
def test_resident_words_and_entry(tile, t0, taps, words):
    assert C.resident_words(tile, t0, taps) == words
    assert C.resident_entry(tile, taps, True) == (
        f"resident_kernelILi{P7.TAPS.index(taps)}ELi{tile[1]}ELb1E")


def test_selftest_calls_on_the_cpu():
    """K2's and K12's host and device times on the CPU: device 0 (no
    device events), no first-call process off the card."""
    from devito_tpu_torch.kernels import stencil as K
    x = torch.ones(K.SELFTEST_SHAPE)
    res = C.selftest_calls(K, x, torch.empty(K.SELFTEST_OUT),
                           torch.device('cpu'))
    assert res['first_call_ms'] is None
    assert res['device_us'] == res['k12_device_us'] == 0
    assert min(res['host_us'], res['host_us_alloc'], res['k12_host_us']) > 0


def _x(cat, name, ts, dur, tid=7, **args):
    return dict(ph='X', cat=cat, name=name, ts=ts, dur=dur, pid=0, tid=tid,
                args=args)


#: Synthetic Chrome traces: (events, the rows of ``trace_of``, its busy us).
#: A ``dtpu::k1.launch`` range on the device's timeline and on the host,
#: and a host op, are not device events; two kernels on two streams that
#: overlap count their union; memcpy and memset are device events.
TRACES = {
    'kernel in a k1.launch range': (
        [_x('gpu_user_annotation', 'dtpu::k1.launch', 0, 100),
         _x('user_annotation', 'dtpu::k1.launch', 0, 20, tid=1),
         _x('cpu_op', 'aten::zero_', 2, 5, tid=1),
         _x('kernel', 'dtpu::stencil_kernel', 10, 50, correlation=1)],
        [('dtpu::stencil_kernel', 0.05, 1)], 50),
    'two kernels overlapping on two streams': (
        [_x('kernel', 'k_a', 0, 100, tid=7),
         _x('kernel', 'k_b', 50, 100, tid=8),
         _x('kernel', 'k_a', 400, 20, tid=7)],
        [('k_b', 0.1, 1), ('k_a', 0.12, 2)], 170),
    'a memcpy and a memset': (
        [_x('gpu_memcpy', 'Memcpy HtoD', 0, 30),
         _x('gpu_memset', 'Memset (Device)', 40, 10),
         _x('cuda_runtime', 'cudaMemcpyAsync', 0, 3, tid=1)],
        [('Memcpy HtoD', 0.03, 1), ('Memset (Device)', 0.01, 1)], 40),
    'no device event (a CPU run)': (
        [_x('user_annotation', 'dtpu_sec0', 0, 20, tid=1)], [], 0)}


@pytest.mark.parametrize('case', sorted(TRACES))
def test_profiled_reads_device_events_only(case, tmp_path):
    """``trace_of`` (``profiled``'s reader) counts each device event once,
    by name, and none of the program's ranges; its busy time is the union
    of the device events, so the idle share of a loop is 1 - union over
    the loop's time."""
    evs, rows, busy_us = TRACES[case]
    (tmp_path / 'x.pt.trace.json').write_text(
        json.dumps({'traceEvents': evs}))
    got, busy = C.trace_of(str(tmp_path))
    assert sorted((n, round(ms, 9), c) for n, ms, c in got) == \
        sorted(rows)
    assert [r[1] for r in got] == sorted((r[1] for r in got), reverse=True)
    assert busy == pytest.approx(busy_us * 1e-3)


#: Phase 10 at a tiny size: SO=12 on a 14x15x16 (+nbl 4) grid, 4 steps.
TTI_TINY = dict(C.FULL, tti_shape=(14, 15, 16), tti_nbl=4, tti_so=12,
                tti_steps=4, tti_nrec=8, tti_cmp_n=12,
                tti_cmp_so=8, tti_cmp_steps=3, tti_stag_n=12, tti_stag_so=4,
                tti_stag_steps=3, tti_2d_shape=(20, 18),
                tti_dot_shape=(12, 13, 14), tti_dot_so=4, tti_dot_tn=30.)


def test_tti_solver_runs_the_steps_asked_for():
    from devito_tpu_torch import switchconfig
    with switchconfig(device='cpu'):
        s = C.tti_solver((10, 11, 12), 8, 4, 7, 5)
        kinds = C.tti_kinds(s.op_fwd(None))
        assert s.geometry.nt - 2 == 7 and s.geometry.rec.npoint == 5
    assert {k for k, _, _ in kinds} == {
        'body update', 'CIRE temporary', 'hoisted prologue item'}
    # at SO=8 cire3 reads u at radius 4 and streams; cire2's radius-2
    # groups, and every other equation, take the point design
    assert {eq.target.name for _, eq, p in kinds
            if p.design == 'stream'} == {'cire3'}
    assert all(p.design == 'point' for _, eq, p in kinds
               if eq.target.name != 'cire3')
    assert not C.trig_taps_on(s.op_fwd(None))


def test_tti_phase_runs_on_the_cpu():
    """Phase 10 at a tiny size on the CPU, where no kernel launches: the
    halo-extended items equal their plain version, the forward's counts
    stay at 0, both hoist-trig-taps settings give the same record, the
    comparison with the plain version and the fp64 dot tests hold, and
    each unit of the forward is held against its plain version."""
    from devito_tpu_torch import switchconfig
    record = {'launches': 0, 'launches_by_design': {'stream': 0, 'point': 0}}
    with switchconfig(device='cpu'):
        res = C.tti(torch.device('cpu'), TTI_TINY, record,
                    torch.Generator().manual_seed(1))
    assert record['launches'] == 0 and res is record['tti']
    import json
    json.dumps(res)      # the kernels line carries it
    assert {r['item'].split()[-1][:4] for r in res['halo']} >= {'cire'}
    assert all(r['max_abs_err'] <= r['tol'] for r in res['halo'])
    f = res['forward']
    assert f['steps'] == 4 and not f['hoist_trig_taps_auto']
    assert res['forward_forced']['hoist_trig_taps'] is True
    assert res['forward_forced']['rec_max_abs_diff'] == 0
    assert all(e['max_abs_err'] <= e['tol'] for e in f['per_equation'])
    # four CIRE temporaries, u and v
    assert f['launches_per_step'] == 6 and not any(
        f['launches_by_kind'].values())
    assert abs(res['dot']['F']) < 1e-11 and abs(res['dot']['J']) < 1e-12
    assert res['compare']['max_abs_diff'] <= res['compare']['tol']


def test_tti_receiver_gather_both_ways_agree():
    """With 512 receivers in 3-D the schedule computes the sampled u + v
    into a dense temporary (devito_tpu's 4096-corner rule); the phase
    times that way against the direct gather from the fields, and both
    give the same record."""
    from devito_tpu_torch import switchconfig
    with switchconfig(device='cpu'):
        s = C.tti_solver((10, 11, 12), 4, 4, 3, 512)
        kinds = C.tti_kinds(s.op_fwd(None))
        rec, u, v, _ = s.forward()
        out = C.tti_gather_ms(s, kinds, u, v, torch.device('cpu'))
        assert out['npoint'] == 512 and np.abs(rec.data).max() > 0
        assert out['max_abs_diff'] <= 1e-6 * np.abs(rec.data).max()
        assert min(out['itmp_ms'], out['gather_ms'], out['direct_ms']) > 0
        small = C.tti_solver((10, 11, 12), 4, 4, 3, 8)
        assert C.tti_gather_ms(small, C.tti_kinds(small.op_fwd(None)),
                               u, v, torch.device('cpu')) is None


SOL_TINY = dict(C.FULL, sol_n=8, sol_nbl=4, sol_steps=4, sol_cmp_n=8,
                sol_cmp_steps=4, sol_dot_tn=60., sa_dot_tn=60.)


@pytest.mark.parametrize('kind', ['elastic', 'viscoelastic',
                                  'viscoacoustic sls-2', 'self-adjoint',
                                  'viscoacoustic kv-1'])
def test_solver_for_runs_the_steps_asked_for(kind):
    from devito_tpu_torch import switchconfig
    with switchconfig(device='cpu'):
        s = C.solver_for(kind, (8, 9, 10), 4, 4, 5, 10.)
        op = s.op_fwd(None)
        # a first-order system's loop runs from t = 0: one step more
        first = kind in ('elastic', 'viscoelastic') or kind.endswith('-1')
        assert C.loop_steps(op) == 5 + first
        assert s.geometry.nt == 7 and s.geometry.rec.npoint == 8 * 9
        kinds = C.tti_kinds(op)
        assert kinds and all(p is not None for _, _, p in kinds)


def test_precomputed_receivers_are_linear_ones():
    """The phase's precomputed receivers hold each point's minimum corner
    and linear weights: they record what linear receivers record."""
    from devito_tpu_torch import switchconfig
    with switchconfig(device='cpu'):
        recs = []
        for how in ('linear', 'precomputed'):
            s = C.solver_for('elastic', (8, 9, 10), 4, 4, 4, 10.,
                             interpolation=how)
            rec = s.geometry.new_rec(name='rec1')
            assert (rec.interpolation == how) and rec.npoint == 72
            recs.append(C.records_of(s.forward()))
        for nm, want in recs[0].items():
            assert np.abs(recs[1][nm] - want).max() <= \
                1e-6 * np.abs(want).max()


def test_launch_ms_raises_on_a_kernel_that_disagrees(monkeypatch):
    """launch_ms holds each launch against its plain version: a kernel
    that writes a wrong value over its region makes it raise."""
    from devito_tpu_torch import switchconfig
    from devito_tpu_torch.kernels import stencil as K
    gen = torch.Generator().manual_seed(2)
    with switchconfig(device='cpu'):
        s = C.solver_for('self-adjoint', (8, 9, 10), 8, 4, 3, 10.)
        op = s.op_fwd(None)
        kinds = C.tti_kinds(op)
        rows = C.launch_ms(op, kinds, {}, s.dt, torch.device('cpu'), gen)
        # a fused unit is one launch (its CIRE temporaries)
        assert len(rows) == len(C.units(kinds)) < len(kinds)
        assert all(r['max_abs_err'] <= r['tol'] for r in rows)
        right = K.stencil_update

        def first(rows):
            return rows[0] if isinstance(rows[0], torch.Tensor) else \
                rows[0][0]

        def off(plan, rows, params):
            right(plan, rows, params)
            first(rows).view(-1)[first(rows).numel() // 2] += 1.
        monkeypatch.setattr(K, 'stencil_update', off)
        with pytest.raises(AssertionError, match='max.kernel - plain'):
            C.launch_ms(op, kinds, {}, s.dt, torch.device('cpu'), gen)
        # a launch whose plain version overflows is no agreement
        plain = K.stencil_update_reference

        def overflows(plan, rows, params):
            plain(plan, rows, params)
            first(rows).view(-1)[first(rows).numel() // 2] = float('inf')
        monkeypatch.setattr(K, 'stencil_update', overflows)
        monkeypatch.setattr(K, 'stencil_update_reference', overflows)
        with pytest.raises(AssertionError, match='max.kernel - plain'):
            C.launch_ms(op, kinds, {}, s.dt, torch.device('cpu'), gen)


def test_solvers_phase_runs_on_the_cpu():
    """Phase 11 at a tiny size on the CPU, where no kernel launches: every
    dense equation planned for K1, every path's counts at 0, the
    comparisons with the plain versions and the fp64 dot tests holding,
    every launch held against its plain version, and each run but the
    elastic forward's split under profiling='measured'."""
    import json
    from devito_tpu_torch import switchconfig
    record = {'launches': 0, 'launches_by_design': {'stream': 0, 'point': 0}}
    with switchconfig(device='cpu'):
        res = C.solvers(torch.device('cpu'), SOL_TINY, record,
                        torch.Generator().manual_seed(1))
        # the K1 units a step launches: a fused unit once
        neqs = {k: len(C.units(C.tti_kinds(C.solver_for(
            k, (8,) * 3, so, 4, 4, 10.).op_fwd(None))))
                for k, so in C.SOLVERS.items()}
    json.dumps(res)      # the kernels line carries it
    assert record['launches'] == 0 and res is record['solvers']
    assert set(record['launches_by_path']) == {
        'elastic forward', 'elastic forward, sinc receivers',
        'elastic forward, precomputed receivers', 'viscoelastic forward',
        'viscoacoustic sls-2 forward', 'viscoacoustic sls-2 adjoint',
        'self-adjoint forward', 'self-adjoint adjoint'}
    assert res['n_units'] > 0 and res['n_equations'] >= res['n_units'] / 2
    for k in ('elastic', 'viscoelastic', 'viscoacoustic sls-2',
              'self-adjoint'):
        row = res[f'{k} forward']
        assert len(row['per_equation']) == neqs[k] and row['rec_norms']
    assert len(res['compare']) == 11 and all(
        c['max_abs_diff'] <= c['tol'] for r in res['compare'].values()
        for c in r.values())
    assert len(res['dot']) == 7 and all(abs(d['dot']) < 1e-11
                                        for d in res['dot'].values())
    assert [r[0] for r in res['receivers']['sinc']['sparse']][-2:] == [
        'interp rec1', 'interp rec2']
    # a streaming equation is held and timed beside its point design (the
    # self-adjoint update; elastic's lines of radius 2 take the point
    # design)
    assert any(e['design'] == 'stream' and 'point_ms' in e and
               e['point_max_abs_err'] <= e['tol']
               for e in res['self-adjoint forward']['per_equation'])
    assert all(e['design'] == 'point'
               for e in res['elastic forward']['per_equation'])
    # elastic's velocities and stresses, each a fused unit, held and timed
    # beside their equations' own units
    fused = [e for e in res['elastic forward']['per_equation']
             if 'apart_ms' in e]
    assert {e['target'] for e in fused} == {
        'v_x+v_y+v_z', 'tau_xx+tau_xy+tau_xz+tau_yy+tau_yz+tau_zz'}
    assert all(e['apart_max_abs_err'] <= e['tol'] for e in fused)
    # every launch at full width, forwards and adjoints, held against its
    # plain version; each loop but the elastic forward's (a cell's) split
    # into its items
    assert 'measured' not in res['elastic forward']
    for lab in ('elastic forward', 'viscoelastic forward',
                'viscoacoustic sls-2 forward', 'viscoacoustic sls-2 adjoint',
                'self-adjoint forward', 'self-adjoint adjoint',
                'receivers'):
        rows = [res[lab]] if lab != 'receivers' else [
            res[lab]['sinc'], res[lab]['precomputed']]
        for row in rows:
            for e in row.get('per_equation', []):
                assert e['max_abs_err'] <= e['tol'] and e['tol'] > 0
            if lab == 'elastic forward':
                continue
            sp = row['measured']
            assert sp['loop_ms'] > 0 and sp['waited_ms'] >= 0
            assert any(k.startswith('K1') for k in sp['items'])
    assert {'interp rec1', 'interp rec2'} <= set(
        res['receivers']['sinc']['measured']['items'])
    # the adjoints at the small size, from the card's record
    for k in ('self-adjoint', 'viscoacoustic sls-2', 'viscoacoustic kv-1'):
        assert set(res['compare'][k]) == {'rec', 'srca'}


#: Phase 12 at a size the CPU runs in seconds: the headline at 16^3, the
#: elastic forward at 32^3 (1024 surface receivers: the least the separable
#: path takes), the superstep at k = 2, a 100-step forward shot.
P12_SMALL = dict(C.FULL, p12_n=16, p12_steps=3, head_compare=2,
                 sol_n=32, sol_nbl=4, sol_steps=4, p12_ss_n=16,
                 p12_ss_ks=(2,), p12_box=((3, 12), (2, 13), (1, 14)),
                 fwd_n=16, fwd_nbl=4, fwd_tn=150., fwd_nrec=8, reps=1,
                 plain_reps=1)


def test_narrow_phase_runs_on_the_cpu():
    """Phase 12's driver on the CPU at a small size: every part runs and
    checks (the plain versions stand in for the kernels, so K1's counts
    stay 0), and the narrow-storage record has every key."""
    from devito_tpu_torch import switchconfig
    records = [{'launches': 0}]
    dev = torch.device('cpu')
    with switchconfig(device='cpu'):
        res = C.narrow_phase(dev, P12_SMALL,
                             records, torch.Generator().manual_seed(1))
    narrow = records[-1]
    assert narrow['name'] == 'stencil_update_narrow'
    assert not [k for k in C.RECORD_KEYS if k not in narrow]
    assert narrow['launches'] == 0 and records[0]['launches'] == 0
    assert set(res['narrow_k1']) == {'bf16 fields', 'bf16 all',
                                     'fp16 fields'}
    bytes_ = {k: r['bound_bytes'] for k, r in res['narrow_k1'].items()}
    assert bytes_['bf16 fields'] == 14 * 16 ** 3
    assert bytes_['bf16 all'] == 10 * 16 ** 3
    assert res['second_row']['drift_from_fp32'] > 0
    for interp in ('linear', 'sinc'):
        assert res['separable'][interp]['nrec'] == 1024
    assert res['superstep'][2]['designs'] == ['point', 'stream']
    assert res['bounds']['x_m/x_M']['region'] == ((3, 13), (2, 14), (1, 15))
    assert res['bounds']['bare x=']['region'] == ((0, 13), (2, 14), (1, 15))
    assert res['pickle']['bit_equal'] and res['pickle']['fresh']['builds'] == 0
    assert 'at step 100' in res['errctl']['raised']
    assert res['errctl']['shot']['errctl']['checks'] == 1


def test_narrow_close_allows_one_ulp():
    want = torch.tensor([1.0, 2.0, 3.0, 1e-6]).to(torch.bfloat16)
    got = want.clone()
    got[1] = torch.tensor(2.015625).to(torch.bfloat16)   # one ulp at 2
    err, off = C.narrow_close('x', got, want)
    assert err == pytest.approx(0.015625) and off == 0.25
    got[2] = torch.tensor(3.0625).to(torch.bfloat16)     # two ulps at 3
    with pytest.raises(AssertionError):
        C.narrow_close('x', got, want)


def test_phase_13_runs_last():
    """Phase 13 (streaming_phase) runs after phase 12, and phase 14
    (sharded_phase) after it, the last phase _smoke drives; the self-test
    is checked after each."""
    import inspect
    src = inspect.getsource(C._smoke)
    calls = [src.index(f'{name}(device') for name in (
        'inverse', 'tti', 'solvers', 'narrow_phase', 'streaming_phase',
        'sharded_phase')]
    assert calls == sorted(calls)
    assert 'phase 13 ran the self-test again' in src
    assert 'phase 14 ran the self-test again' in src
    assert src.index('streaming_phase(device') > src.index(
        'narrow_phase(device')
    assert '13. Host streaming' in C.__doc__
    assert '14. Multi-device through the port' in C.__doc__


def test_streaming_phase_runs_on_the_cpu():
    """Phase 13 at a small size on the CPU, where no kernel launches: the
    streamed and resident rows, records and gradients bit-equal, a save
    of 13 rows against a card of 10 under 'auto' (a budget of 5 rows
    standing in for the default), the measured mode falling back to the
    cost model, the roofline line against cpu-generic."""
    from devito_tpu_torch import switchconfig
    sizes = dict(C.FULL, p13_n=16, fwd_nbl=4, fwd_nrec=8, p13_rows=12,
                 p13_K=4, p13_prof_steps=6)
    row = 40 * 40 * 128 * 4
    sizes.update(p13_card_bytes=10 * row, p13_auto_budget=5 * row)
    record = {'launches': 0, 'ms': 1.0}
    C.set_bound(record, 4 * 16 ** 3 * 5, 76 * 16 ** 3)
    with switchconfig(device='cpu'):
        res = C.streaming_phase(torch.device('cpu'), sizes, record)
    json.dumps(res)
    one = res['both_fit']
    assert one['bit_equal'] == {'rows': True, 'rec': True, 'gradient': True}
    st = one['streamed']
    assert (st['forward']['K'], st['gradient']['K']) == (4, 6)
    assert len(st['forward']['chunks']) == 3     # 10 steps in chunks of 4
    assert set(st['forward']['chunks'][0]) == {'steps', 'pin', 'h2s', 's2d',
                                                'compute', 'd2s', 's2h'}
    assert 'pin' not in st['forward']['chunks'][1]    # staging reused
    assert 'd2s' not in st['gradient']['chunks'][0]    # u is only read
    assert one['resident']['forward']['K'] is None
    two = res['larger']
    assert (two['rows'], two['wanted_rows'], two['reason']) == (13, 13, None)
    assert two['rec_max_abs_diff'] == 0 and two['same_design']
    assert two['grad_max_abs_diff'] <= two['grad_tol']
    assert two['forward']['K'] == 4 and len(two['forward']['chunks']) == 3
    m = res['measured']
    assert m['unattributed'] == 0 and 'cpu-generic HBM roofline' in \
        m['log_line']
    assert res['platform']['row']['name'] == 'cpu-generic'
    assert record['launches'] == 0


P14_SMALL = dict(C.FULL, p14_n=17, fwd_nbl=4, fwd_nrec=8, p14_steps=6,
                 p14_grad_steps=6, p14_stream_n=12, p14_stream_rows=10,
                 p14_stream_K=4, p14_gather_n=12, p14_gather_steps=3,
                 p14_prof_steps=3)


def test_sharded_phase_runs_on_the_cpu():
    """Phase 14 at a small size on the CPU (4 shards on 'cpu', 6 for the
    uneven (3, 2, 1); 25^3 with nbl 4, uneven on every topology), where
    no kernel launches: every sharded shot, the gradient, the streamed run
    and the gathered schedule bit-equal to their unsharded runs, the
    exchange's copies and bytes equal to the plan's, the one-card branch
    counted as not run."""
    from devito_tpu_torch import switchconfig
    record = {'launches': 0}
    with switchconfig(device='cpu'):
        res = C.sharded_phase(torch.device('cpu'), P14_SMALL, record)
    json.dumps(res)
    for key in ('(2, 2, 1)', '(4, 1, 1)', 'uneven'):
        row = res[key]
        assert row['bit_equal'] and row['rec_err'] == 0
        assert row['exchange_bytes_per_step'] == row['plan_bytes_per_step']
        assert all(d['design'] == 'stream' for d in row['designs'])
    assert res['uneven']['shards'] == 6
    assert res['(2, 2, 1)']['plan_copies_per_step'] == 8
    assert res['gradient']['(2, 2, 1)']['bit_equal']
    assert res['streaming']['bit_equal'] and res['streaming']['chunks'] == 2
    assert "'dirty'" in res['gathered']['reason']
    assert res['one_shard_a_card'] == 'not run'
    assert record['launches'] == 0


def test_sharded_phase_fails_loudly_on_a_mismatch(monkeypatch):
    """A sharded shot that departs from the unsharded one raises."""
    import devito_tpu_torch.parallel.halo as H
    restore = H.ShardedRunner.restore

    def off_by_one(self, name, locals_, arr):
        out = restore(self, name, locals_, arr)
        if name == 'u':
            arr[:, 10, 10, 10] += 1.0      # a domain point of every row
        return out
    monkeypatch.setattr(H.ShardedRunner, 'restore', off_by_one)
    from devito_tpu_torch import switchconfig
    with switchconfig(device='cpu'), pytest.raises(AssertionError):
        C.sharded_phase(torch.device('cpu'), P14_SMALL, {'launches': 0})


P15_SMALL = dict(C.FULL, p15_args={
    'cfd.linear_convection': dict(nx=21, ny=21, nt=10),
    'cfd.diffusion': dict(nx=21, ny=21, nt=20),
    'cfd.burgers': dict(nx=21, ny=21, nt=10),
    'cfd.poisson': dict(nx=20, ny=20, niter=20),
    'cfd.nonlinear_convection': dict(nx=21, ny=21, nt=10),
    'cfd.laplace': dict(nx=11, ny=11, niter=10),
    'cfd.cavity_flow': dict(nx=11, ny=11, nt=10),
    'cfd.shallow_water': dict(nx=21, ny=21, nt=10),
    'cfd.darcy_flow': dict(n=16, niter=20),
    'seismic_abc.reflecting': dict(shape=(61, 61), extent=(600., 600.),
                                   nt=400),
    'seismic_abc.damping_abc': dict(shape=(61, 61), extent=(600., 600.),
                                    nt=400, nbl=10),
    'seismic_abc.pml_abc': dict(shape=(61, 61), extent=(600., 600.), nt=400,
                                nbl=10),
    'seismic_abc.habc': dict(shape=(61, 61), extent=(600., 600.), nt=400,
                             nbl=10),
    'seismic_fwi.run_fwi': dict(shape=(31, 31), nshots=2, nreceivers=11,
                                fwi_iterations=2, tn=300., nbl=10),
    'finance.black_scholes': dict(tmax=0.1, dt0=0.002),
    'multichip.sharded_diffusion': dict(shape=(32, 32), steps=10),
    'multichip.halo_modes_demo': dict(steps=5)},
    p15_fwi=dict(shape=(41, 41), spacing=(10., 10.), nbl=10, space_order=4,
                 tn=300., nshots=2, nreceivers=11, fwi_iterations=2),
    p15_born_n=21, p15_born_tn=100., p15_diff_n=24, p15_diff_steps=5)


def test_examples_phase_runs_on_the_cpu():
    """Phase 15 at small sizes on the CPU, where no kernel launches: every
    example against its run in the child process, the facts devito_tpu's
    tests assert, the FWI survey's objective decreasing and its repeated
    gradient bit-equal, both overrides bit-equal to the Operator's own
    layout, the sharded examples bit-equal to the unsharded run."""
    from devito_tpu_torch import switchconfig
    record = {'launches': 0}
    with switchconfig(device='cpu'):
        res = C.examples_phase(torch.device('cpu'), P15_SMALL, record)
    json.dumps(res)
    assert sorted(res['examples']) == sorted(
        f'{m}.{n}' for m, names in C.EXAMPLES for n in names)
    assert all(r['tol_ratio'] == 0 for r in res['examples'].values())
    assert res['examples']['seismic_fwi.run_fwi']['declined'] == \
        {'increment': 1}
    fwi = res['fwi']
    assert fwi['objective'][1] < fwi['objective'][0]
    assert fwi['repeat']['bit_equal'] and len(fwi['iteration_s']) == 2
    assert set(fwi['ms_per_step']) == {'forward', 'save-forward',
                                       'gradient'}
    for row in res['override'].values():
        assert row['bit_equal_own'] and row['relayouts'] == 1
    mc = res['multichip']
    assert mc['sharded_bit_equal'] and mc['auto_bit_equal'] and \
        mc['explicit_bit_equal'] and mc['refused'] == 'InvalidArgument'
    assert record['launches'] == 0


def test_held_example_fails_loudly_on_a_mismatch():
    want = {'/0': np.ones(4, np.float32), '/1': 'a', '/2': 3}
    assert C.held_example('k', dict(want), want) == 0
    for bad in ({'/0': np.ones(4, np.float32) * 1.001, '/1': 'a', '/2': 3},
                {'/0': want['/0'], '/1': 'b', '/2': 3},
                {'/0': want['/0'], '/1': 'a'}):
        with pytest.raises(AssertionError):
            C.held_example('k', bad, want)
