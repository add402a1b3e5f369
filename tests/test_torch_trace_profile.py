"""Measured per-section profiling through devito_tpu_torch
(``configuration['profiling'] = 'measured'``, ``profile-dir``): the
reader of torch.profiler's Chrome trace (operator/trace_profile.py), the
runner's ``dtpu_secN`` ranges (opened only while a profiler records), and
the measured branch of ``Operator._add_sections`` against devito_tpu's
(tests/test_trace_profile.py).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch
from torch.profiler import profile, ProfilerActivity

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu_torch.logger import logger  # noqa: E402
from devito_tpu_torch.utils import tools as T  # noqa: E402
from devito_tpu_torch.operator.trace_profile import (  # noqa: E402
    attribute, categorize_ops, device_events, device_op_durations,
    section_durations)

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

K1 = 'void dtpu::stream_kernel<dtpu::StreamLayout<float, 4, 4>, 1>(x)'
INJ = 'void at::native::indexing_backward_kernel<float, 4>(x)'
GATHER = 'void at::native::index_elementwise_kernel<128, 4>(x)'
ADD = 'void at::native::vectorized_elementwise_kernel<4, AddFunctor>(x)'


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _write(tmp_path, events, name='op.1.pt.trace.json'):
    with open(tmp_path / name, 'w') as f:
        json.dump({'schemaVersion': 1, 'traceEvents': events}, f)
    return str(tmp_path)


def _x(cat, name, ts, dur, pid=0, tid=7, **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'pid': pid, 'tid': tid,
            'ts': ts, 'dur': dur, 'args': args}


#: A synthetic trace of one step (times in us): sec0 and sec1 each hold a
#: kernel inside their device ranges; sec1's second kernel has no device
#: range but its launch lies in sec1's CPU range; a memcpy is launched
#: outside every range; a kernel with no range and no launch is
#: unattributable; CPU-side events carry no device time.
EVENTS = [
    _x('user_annotation', 'dtpu_sec0', 0, 10, pid=99, tid=1),
    _x('cuda_runtime', 'cudaLaunchKernel', 2, 1, pid=99, tid=1,
       correlation=1),
    _x('user_annotation', 'dtpu_sec1', 10, 10, pid=99, tid=1),
    _x('cuda_runtime', 'cudaLaunchKernel', 12, 1, pid=99, tid=1,
       correlation=2),
    _x('cuda_runtime', 'cudaLaunchKernel', 14, 1, pid=99, tid=1,
       correlation=3),
    _x('cuda_runtime', 'cudaMemcpyAsync', 25, 1, pid=99, tid=1,
       correlation=4),
    _x('cpu_op', 'aten::index_put_', 11, 5, pid=99, tid=1),
    _x('gpu_user_annotation', 'dtpu_sec0', 100, 300),
    _x('kernel', K1, 100, 300, correlation=1),
    _x('gpu_user_annotation', 'dtpu_sec1', 400, 50),
    _x('kernel', INJ, 400, 50, correlation=2),
    _x('kernel', GATHER, 450, 20, correlation=3),
    _x('gpu_memcpy', 'Memcpy HtoD (Pinned -> Device)', 480, 40,
       correlation=4),
    _x('kernel', ADD, 530, 8, correlation=77),
]


class TestReader:

    def test_attribution(self, tmp_path):
        res = attribute(_write(tmp_path, EVENTS))
        assert res['events'] == 5
        assert res['sections'] == pytest.approx({'dtpu_sec0': 300e-6,
                                                 'dtpu_sec1': 70e-6})
        assert res['other'] == pytest.approx(48e-6)
        assert res['unattributed'] == 1
        assert res['unattributed_s'] == pytest.approx(8e-6)
        secs, other = section_durations(str(tmp_path))
        assert secs == res['sections'] and other == res['other']

    def test_categories(self, tmp_path):
        durs = device_op_durations(_write(tmp_path, EVENTS))
        assert 'aten::index_put_' not in durs and len(durs) == 5
        cats = categorize_ops(durs)
        assert list(cats) == ['stencil', 'scatter', 'gather', 'copy',
                              'elementwise', 'other']
        assert cats == pytest.approx({'stencil': 300e-6, 'scatter': 50e-6,
                                      'gather': 20e-6, 'copy': 40e-6,
                                      'elementwise': 8e-6, 'other': 0.})

    def test_newest_trace_is_read(self, tmp_path):
        _write(tmp_path, EVENTS[:9], 'op.1.pt.trace.json')
        path = _write(tmp_path, EVENTS, 'op.2.pt.trace.json')
        os.utime(tmp_path / 'op.1.pt.trace.json', (1, 1))
        assert len(device_events(path)) == 5

    def test_no_trace_gives_none(self, tmp_path):
        assert device_events(str(tmp_path)) is None
        assert device_op_durations(str(tmp_path)) is None
        assert attribute(str(tmp_path)) is None
        assert section_durations(str(tmp_path)) == (None, 0.0)

    def test_cpu_only_events_give_none(self, tmp_path):
        path = _write(tmp_path, EVENTS[:7])
        assert device_events(path) is None and attribute(path) is None


def _spy_gate(monkeypatch):
    """The names of the ranges the program's span gate opens from now on
    (``utils/tools.py`` ``span``)."""
    calls = []
    rf = T.record_function

    def spy(name):
        calls.append(name)
        return rf(name)
    monkeypatch.setattr(T, 'record_function', spy)
    return calls


def _diffusion(pkg, n=32):
    grid = pkg.Grid(shape=(n, n), extent=(1., 1.))
    u = pkg.TimeFunction(name='u', grid=grid, space_order=2)
    u.data[0] = 1.0
    eq = pkg.Eq(u.forward, pkg.solve(pkg.Eq(u.dt, 0.1 * u.laplace),
                                     u.forward))
    return pkg.Operator([eq])


class TestMeasuredMode:

    def test_cpu_falls_back_to_modeled(self, caplog):
        op = _diffusion(dt)
        with dt.switchconfig(profiling='measured'):
            with caplog.at_level(logging.WARNING, logger=logger.name):
                summary = op.apply(time_M=4, dt=1e-5)
        assert any('no device event' in r.getMessage()
                   for r in caplog.records)
        assert summary['section0'].time > 0 and op._measured_secs is None
        assert summary.globals['fdlike'].time == pytest.approx(
            summary['section0'].time)

    def test_synthetic_attribution_as_devito_tpu(self):
        """devito_tpu's numbers (tests/test_trace_profile.py:91-112)
        through the port's _add_sections, and the same section times as
        devito_tpu's _add_sections gives."""
        times = []
        for pkg in (dj, dt):
            grid = pkg.Grid(shape=(32, 32), extent=(310., 310.))
            u = pkg.TimeFunction(name='u', grid=grid, time_order=2,
                                 space_order=2)
            rec = pkg.SparseTimeFunction(name='rec', grid=grid, npoint=4,
                                         nt=6)
            rec.coordinates.data[:] = [[50., 50.], [100., 100.],
                                       [150., 150.], [200., 200.]]
            eq = pkg.Eq(u.forward, pkg.solve(pkg.Eq(u.dt2, 4.0 * u.laplace),
                                             u.forward))
            op = pkg.Operator([eq, rec.interpolate(expr=u)])
            op.apply(time_m=1, time_M=4, dt=0.5)
            op._measured_secs = {'dtpu_sec0': 0.3, 'dtpu_sec1': 0.6}
            op._measured_other = 0.1
            summary = pkg.operator.profiling.PerformanceSummary()
            op._add_sections(summary, elapsed=1.1, nsteps=4)
            by_label = {summary.labels[k]: v.time
                        for k, v in summary.items()}
            assert by_label['interp:rec'] > 0.6
            assert by_label['u'] > 0.3
            assert sum(v.time for v in summary.values()) == \
                pytest.approx(1.0)
            times.append(by_label)
        assert times[1] == pytest.approx(times[0], rel=1e-12)

    def test_tagged_runner_under_torch_profiler(self):
        """Under a profiler the runner tags each body item a step."""
        op = _diffusion(dt)
        bufs, params, tm, tM, _, _ = op._prepare({'dt': 1e-5, 'time_M': 2})
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            op._runner(bufs, params, tm, tM)
        counts = {e.key: e.count for e in prof.key_averages()}
        assert counts['dtpu_sec0'] == 3 and 'dtpu_sec1' not in counts

    def test_basic_opens_no_range(self, monkeypatch):
        """With no profiler recording an apply opens no range; measured
        profiling records the loop's span and a section a step."""
        calls = _spy_gate(monkeypatch)
        op = _diffusion(dt)
        op.apply(time_M=3, dt=1e-5)
        assert calls == []
        with dt.switchconfig(profiling='measured'):
            op.apply(time_M=3, dt=1e-5)
        assert calls == ['dtpu::apply.loop'] + ['dtpu_sec0'] * 4

    def test_profile_dir_gets_a_trace(self, tmp_path):
        op = _diffusion(dt)
        with dt.switchconfig(**{'profile-dir': str(tmp_path)}):
            op.apply(time_M=2, dt=1e-5)
        (path,) = tmp_path.glob('*.pt.trace.json')
        evs = json.load(open(path))['traceEvents']
        assert sum(e.get('name') == 'dtpu_sec0' for e in evs) == 3
        assert op._measured_secs is None     # 'basic': nothing read

    def test_bounded_runner_keeps_section_numbers(self, monkeypatch):
        """A body item a box drops leaves the others their tags."""
        grid = dt.Grid(shape=(16, 16))
        sd = dt.SubDomain(name='left', spec={'x': ('left', 3)}, grid=grid)
        u = dt.TimeFunction(name='u', grid=grid, space_order=2)
        v = dt.TimeFunction(name='v', grid=grid, space_order=2)
        op = dt.Operator([dt.Eq(u.forward, u + 1, subdomain=sd),
                          dt.Eq(v.forward, v + 1)])
        run = op._bounded_runner({'x': (10, None)})
        assert len(op._runner.plans) == 2 and len(run.plans) == 1
        calls = _spy_gate(monkeypatch)
        bufs, params, *_ = op._prepare({'time_M': 0})
        with profile(activities=[ProfilerActivity.CPU]):
            run(bufs, params, 0, 0)
        assert calls == ['dtpu_sec1']
