"""The port's own spans (``devito_tpu_torch/utils/tools.py`` ``span``):
opened only while a profiler records, nested at the layer boundaries of a
shot (the solver's entry point, ``Operator.apply`` and its prepare, loop
and finish, the executor's sections, the sparse ops, K1's launch), and the
benchmark's per-layer readers of them (``gpubench/metrics/``) on a
hand-built Chrome trace."""

import json
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import profile, ProfilerActivity

import devito_tpu_torch as dt
from devito_tpu_torch.ir.lowering import LoweredEq, LoweredSparse
from devito_tpu_torch.kernels import stencil as K
from devito_tpu_torch.models.seismic import (
    AcquisitionGeometry, AcousticWaveSolver, AnisotropicWaveSolver,
    ElasticWaveSolver, SaIsoWaveSolver, ViscoacousticWaveSolver,
    ViscoelasticWaveSolver, demo_model)
from devito_tpu_torch.models.seismic.utils import SOLVER_ENTRIES
from devito_tpu_torch.parallel.distributor import Distributor
from devito_tpu_torch.utils import tools as T
from gpubench.manifest import Manifest
from gpubench.tracefile import JOB_SPAN, Trace

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

APPLY_PARTS = ('dtpu::apply.prepare', 'dtpu::apply.loop',
               'dtpu::apply.finish')


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _solver(device='cpu', tn=40.):
    with dt.switchconfig(device=device):
        model = demo_model('layers-isotropic', shape=(31, 31),
                           spacing=(10., 10.), nbl=6, space_order=4)
        geometry = AcquisitionGeometry(
            model, np.stack([np.linspace(0, 300, 11), np.full(11, 20.)], 1),
            np.array([[150., 20.]]), 0., tn, f0=0.010, src_type='Ricker')
        return AcousticWaveSolver(model, geometry, space_order=4)


def _spy_gate(monkeypatch):
    """The names of the ranges the gate opens from now on."""
    calls = []
    rf = T.record_function

    def spy(name):
        calls.append(name)
        return rf(name)
    monkeypatch.setattr(T, 'record_function', spy)
    return calls


def _traced(tmp_path, fn, cuda=False):
    """The program's spans of ``fn()`` under torch.profiler: [(name, start,
    end)] in start order, from the exported Chrome trace."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())['traceEvents']
    return sorted(((e['name'], float(e['ts']), float(e['ts']) + e['dur'])
                   for e in evs if e.get('cat') == 'user_annotation' and
                   e['name'].startswith('dtpu')), key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_forward_opens_no_range_without_a_profiler(monkeypatch):
    s = _solver()
    calls = _spy_gate(monkeypatch)
    rec = s.forward()[0]
    assert calls == [] and np.linalg.norm(rec.data) > 0


def test_forward_spans_nest(tmp_path):
    s = _solver()
    s.forward()
    spans = _traced(tmp_path, s.forward)
    by = {}
    for sp in spans:
        by.setdefault(sp[0], []).append(sp)
    (solver,), (apply,) = by['dtpu::solver.forward'], by['dtpu::apply']
    parts = [by[n] for n in APPLY_PARTS]
    assert all(len(p) == 1 for p in parts)
    prepare, loop, finish = (p[0] for p in parts)
    assert _inside(apply, solver)
    assert all(_inside(p, apply) for p in (prepare, loop, finish))
    assert prepare[2] <= loop[1] and loop[2] <= finish[1]
    # every span of the time loop lies inside the loop's
    rest = [sp for sp in spans if sp[0].startswith('dtpu_sec') or
            sp[0].startswith('dtpu::sparse.')]
    assert rest and all(_inside(sp, loop) for sp in rest)


def test_forward_spans_per_step(tmp_path):
    """A ``dtpu_secN`` range a body item a step, one injection and one
    interpolation a step, and no K1 launch: the CPU runs the plain
    version."""
    s = _solver()
    op = s.op_fwd(None)
    counts = Counter(sp[0] for sp in _traced(tmp_path, s.forward))
    steps = s.geometry.nt - 2
    body = len(op._schedule.body)
    assert {n: counts[n] for n in counts if n.startswith('dtpu_sec')} == \
        {f'dtpu_sec{i}': steps for i in range(body)}
    assert counts['dtpu::sparse.inject'] == steps
    assert counts['dtpu::sparse.interp'] == steps
    assert 'dtpu::k1.launch' not in counts and 'dtpu::nvcc' not in counts


@pytest.mark.parametrize('entry', SOLVER_ENTRIES)
def test_each_entry_point_holds_its_applies(tmp_path, entry):
    s = _solver()
    rec, u = s.forward(save=True)[:2]
    dm = dt.Function(name='dm', grid=s.model.grid, space_order=0)
    dm.data[:] = 1e-3
    call = {'forward': lambda: s.forward(),
            'adjoint': lambda: s.adjoint(rec),
            'jacobian': lambda: s.born(dm),
            'jacobian_adjoint': lambda: s.gradient(rec, u)}[entry]
    call()
    spans = _traced(tmp_path, call)
    (outer,) = [sp for sp in spans if sp[0].startswith('dtpu::solver.')]
    applies = [sp for sp in spans if sp[0] == 'dtpu::apply']
    assert outer[0] == f'dtpu::solver.{entry}'
    assert len(applies) == 1 and _inside(applies[0], outer)


@pytest.mark.parametrize('cls', [
    AcousticWaveSolver, AnisotropicWaveSolver, ElasticWaveSolver,
    SaIsoWaveSolver, ViscoacousticWaveSolver, ViscoelasticWaveSolver])
def test_every_solver_spans_its_entry_points(cls, monkeypatch):
    """Each entry point of every solver, and each alias of one, opens its
    ``dtpu::solver.<entry>`` span (here with the gate held open and the
    call failing at once: no solver is built)."""
    entries = [n for n in SOLVER_ENTRIES if n in cls.__dict__]
    assert 'forward' in entries
    opened = []
    monkeypatch.setattr(T, '_profiler_enabled', lambda: True)
    monkeypatch.setattr(T, 'record_function',
                        lambda name: opened.append(name) or T._CLOSED)
    aliases = {'born': 'jacobian', 'gradient': 'jacobian_adjoint'}
    names = entries + [a for a, e in aliases.items() if a in cls.__dict__]
    for name in names:
        with pytest.raises((AttributeError, TypeError)):
            getattr(cls, name)(None)
    assert opened == [f'dtpu::solver.{aliases.get(n, n)}' for n in names]


def test_relaid_apply_opens_one_apply(tmp_path):
    """An override of another halo re-enters apply on its relaid copy: one
    ``dtpu::apply`` all the same."""
    s = _solver()
    dm = dt.Function(name='dm', grid=s.model.grid, space_order=1)
    dm.data[:] = 1e-3
    s.jacobian(dm)
    op = s.op_born()
    relayouts = op.relayouts
    counts = Counter(sp[0] for sp in _traced(tmp_path,
                                             lambda: s.jacobian(dm)))
    assert op.relayouts == relayouts >= 1
    assert counts['dtpu::apply'] == 1
    assert all(counts[n] == 1 for n in APPLY_PARTS)


def test_sharded_runner_spans(tmp_path):
    """The sharded runner tags its body items (the exchange's markers as
    ``dtpu_exchange``) a step, and one sparse span an item a step across
    the shards."""
    grid = dt.Grid(shape=(24, 24), extent=(23., 23.), dtype=np.float64)
    grid._distributor = Distributor(grid, topology=(2, 2),
                                    devices=[torch.device('cpu')] * 4)
    nt = 6
    u = dt.TimeFunction(name='u', grid=grid, space_order=2)
    src = dt.SparseTimeFunction(name='src', grid=grid, npoint=2, nt=nt,
                                coordinates=[[11., 11.], [5.5, 17.2]])
    src.data[:] = 1.0
    rec = dt.SparseTimeFunction(name='rec', grid=grid, npoint=3, nt=nt,
                                coordinates=[[11., 11.], [6., 17.],
                                             [20., 3.]])
    op = dt.Operator([dt.Eq(u.forward, 0.5 * u + 0.1 * u.dx),
                      src.inject(field=u.forward, expr=src),
                      rec.interpolate(expr=u)])
    op.apply(time_M=nt - 2, dt=1.0)
    hr = op._halo_runner
    assert hr is not None
    counts = Counter(sp[0] for sp in _traced(
        tmp_path, lambda: op.apply(time_M=nt - 2, dt=1.0)))
    steps = nt - 1
    want = Counter()
    for it in hr.local_schedule.body:
        want[f'dtpu_sec{it._section}' if isinstance(
            it, (LoweredEq, LoweredSparse)) else 'dtpu_exchange'] += steps
    assert want['dtpu_exchange'] >= steps
    assert {n: c for n, c in counts.items()
            if n.startswith('dtpu_')} == dict(want)
    assert counts['dtpu::sparse.inject'] == steps
    assert counts['dtpu::sparse.interp'] == steps


@pytest.mark.cuda
def test_one_launch_span_a_launch_on_card(tmp_path):
    """On the card each K1 launch is one ``dtpu::k1.launch`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    with dt.switchconfig(device='cuda'):
        s = _solver('cuda')
        s.forward()
        before = K.launches
        counts = Counter(sp[0] for sp in _traced(tmp_path, s.forward,
                                                 cuda=True))
        torch.cuda.synchronize()
    assert counts['dtpu::k1.launch'] == K.launches - before > 0
    assert counts['dtpu::k1.launch'] == s.geometry.nt - 2


@pytest.mark.cuda
def test_measured_profiling_keeps_its_sections_on_card():
    """``profiling='measured'`` still gives each body section its device
    time: the new spans nest inside the sections' ranges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    with dt.switchconfig(device='cuda'):
        s = _solver('cuda')
        s.forward()
        with dt.switchconfig(profiling='measured'):
            s.forward()
    op = s.op_fwd(None)
    body = len(op._schedule.body)
    assert set(op._measured_secs) == {f'dtpu_sec{i}' for i in range(body)}
    assert min(op._measured_secs.values()) > 0


# -- the per-layer readers ---------------------------------------------------

def _x(cat, name, ts, end):
    return {'ph': 'X', 'cat': cat, 'name': name, 'pid': 1, 'tid': 1,
            'ts': ts, 'dur': end - ts}


#: One traced job, 0-1000 us: a zeroing apply (20-60, its loop 30-50), then
#: the solver (100-880) around an apply (150-870) whose loop (200-700) runs
#: two K1 launches and two sparse ops, with runtime calls in and out of the
#: spans; four device events leave five gaps.
EVENTS = [
    _x('user_annotation', JOB_SPAN, 0, 1000),
    _x('user_annotation', 'gpubench::forward', 90, 890),
    _x('user_annotation', 'dtpu::apply', 20, 60),
    _x('user_annotation', 'dtpu::apply.loop', 30, 50),
    _x('user_annotation', 'dtpu::solver.forward', 100, 880),
    _x('cuda_runtime', 'cudaMemcpyAsync', 120, 130),
    _x('user_annotation', 'dtpu::apply', 150, 870),
    _x('user_annotation', 'dtpu::apply.prepare', 150, 200),
    _x('user_annotation', 'dtpu::apply.loop', 200, 700),
    _x('user_annotation', 'dtpu_sec0', 290, 320),
    _x('user_annotation', 'dtpu::k1.launch', 290, 320),
    _x('cuda_runtime', 'cudaLaunchKernel', 300, 310),
    _x('user_annotation', 'dtpu::sparse.inject', 400, 430),
    _x('cuda_driver', 'cuLaunchKernel', 410, 415),
    _x('user_annotation', 'dtpu::sparse.interp', 430, 460),
    _x('user_annotation', 'dtpu::k1.launch', 600, 640),
    _x('cuda_runtime', 'cudaLaunchKernel', 610, 625),
    _x('cuda_runtime', 'cudaEventSynchronize', 700, 750),
    _x('user_annotation', 'dtpu::apply.finish', 750, 870),
    _x('cpu_op', 'aten::copy_', 760, 800),
    _x('gpu_user_annotation', 'dtpu::apply.loop', 200, 900),
    _x('kernel', 'void dtpu::stream_kernel<float>(x)', 210, 400),
    _x('kernel', 'void at::native::index_put_kernel(x)', 450, 690),
    _x('kernel', 'void at::native::fill_kernel(x)', 30, 45),
    _x('gpu_memcpy', 'Memcpy DtoH', 760, 770),
]

#: by hand: the apply and solver spans 40 + 780 us, less the loops (20,
#: 500) and the runtime calls outside them (10, 50): 240 us a job; the
#: loops' idle 5 + 10 + 50 + 10 us over 5 steps; the sparse spans 60 us
#: less 5 of runtime over 5 steps; the launches (30 - 10 + 40 - 15) / 2;
#: the gaps' midpoints at 15 and 885 lie under no span: 30 + 230 of 545 us
#: of idle time
WANT = {'apply_host_ms': 0.24, 'loop_idle_ms_per_step': 0.075 / 5,
        'sparse_host_ms_per_step': 0.055 / 5, 'k1_launch_host_us': 22.5,
        'idle_unnamed_pct': 100 * 260 / 545}


def _read(name, events, steps=5):
    ctx = SimpleNamespace(trace=Trace(events), traced_steps=steps)
    return Manifest.reader('per_layer', name)(ctx)


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_on_a_hand_built_trace(name):
    assert _read(name, EVENTS) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_finds_nothing_without_the_programs_spans(name):
    """A trace with the benchmark's spans and device events but none of
    the program's (the parent's program) gives no number; nor does a
    trace without a job."""
    plain = [e for e in EVENTS if e['cat'] != 'user_annotation' or
             not e['name'].startswith('dtpu')]
    assert _read(name, plain) is None
    assert _read(name, []) is None


def test_device_readers_need_device_events():
    """On the CPU the trace has no device event: the idle readers give no
    number, the host readers do."""
    host = [e for e in EVENTS if e['cat'] not in ('kernel', 'gpu_memcpy')]
    assert _read('loop_idle_ms_per_step', host) is None
    assert _read('idle_unnamed_pct', host) is None
    assert _read('apply_host_ms', host) == pytest.approx(0.24)


def test_spans_clipped_to_the_window_count_once():
    """Nested and overlapping spans count once, and a span outside the
    traced window counts nothing."""
    extra = [_x('user_annotation', 'dtpu::solver.forward', 100, 880),
             _x('user_annotation', 'dtpu::apply', 1200, 1300),
             _x('user_annotation', 'dtpu::k1.launch', 1200, 1300)]
    assert _read('apply_host_ms', EVENTS + extra) == pytest.approx(0.24)
    assert _read('k1_launch_host_us', EVENTS + extra) == pytest.approx(22.5)
