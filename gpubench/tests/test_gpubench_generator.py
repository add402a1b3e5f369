"""The general generator and the trace reader, on small made-up inputs:
receivers on a line or a surface grid, sources drawn per axis, the same
work for every seed, and the device's busy time as the window less its
idle gaps."""

import numpy as np
import pytest

from gpubench import generator
from gpubench.tests.helpers import SEED, tiny
from gpubench.tracefile import JOB_SPAN, Trace


def test_receiver_line_and_surface_grid():
    cfg = tiny('acoustic')                    # 24 x 20 x 28, 10 m
    line = generator.receivers(cfg)
    assert line.shape == (24, 3)
    assert np.allclose(line[:, 0], np.linspace(0, 230, 24))
    assert np.allclose(line[:, 1], 95.0) and np.allclose(line[:, 2], 20.0)
    grid = generator.receivers(dict(cfg, receivers={'counts': [4, 3],
                                                    'depth_spacings': 1}))
    assert grid.shape == (12, 3)
    assert sorted(set(grid[:, 1])) == [0.0, 95.0, 190.0]
    flat = generator.receivers(dict(cfg, shape=[30, 40], spacing=[5., 5.],
                                    origin=[0., 0.],
                                    receivers={'counts': [30],
                                               'depth_spacings': 2}))
    assert flat.shape == (30, 2) and np.allclose(flat[:, 1], 10.0)


def test_sources_drawn_per_axis():
    cfg = tiny('acoustic')
    line = {'axes': ['uniform', 'centre'], 'depth_spacings': 1}
    a = generator.sources(line, cfg, SEED, 50)
    assert a.shape == (50, 1, 3)
    assert (a[:, 0, 0] >= 0).all() and (a[:, 0, 0] <= 230).all()
    assert np.allclose(a[:, 0, 1], 95.0) and np.allclose(a[:, 0, 2], 10.0)
    assert np.array_equal(a, generator.sources(line, cfg, SEED, 50))
    b = generator.sources(line, cfg, SEED + 1, 50)
    assert b.shape == a.shape and not np.array_equal(a, b)
    surface = generator.sources({'axes': ['uniform', 'uniform'],
                                 'depth_spacings': 1}, cfg, SEED, 50)
    assert len(set(surface[:, 0, 1])) == 50
    with pytest.raises(ValueError):
        generator.sources({'axes': ['receiver_line', 'centre'],
                           'depth_spacings': 1}, cfg, SEED, 2)


def test_sample_keeps_the_last_job():
    idx = generator.sample(SEED, 100, 3)
    assert len(idx) == 3 and idx[-1] == 99
    assert generator.sample(SEED, 1, 3) == [0]
    assert generator.sample(SEED, 0, 3) == []


def _event(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}


def test_busy_is_the_window_less_its_gaps():
    events = [_event(JOB_SPAN, 'user_annotation', 0, 100),
              _event(JOB_SPAN, 'user_annotation', 110, 90),
              # two streams overlapping: counted once
              _event('dtpu::stream_kernel', 'kernel', 10, 40),
              _event('index_put_kernel', 'kernel', 30, 30),
              _event('Memcpy DtoH', 'gpu_memcpy', 120, 20),
              # outside the window: left out
              _event('dtpu::stream_kernel', 'kernel', 300, 10)]
    tr = Trace(events)
    assert tr.jobs == 2 and tr.window_s == pytest.approx(200e-6)
    assert tr.gaps() == [(0, 10), (60, 120), (140, 200)]
    assert tr.busy_s == pytest.approx(70e-6)
    assert tr.seconds(('stencil',)) == pytest.approx(40e-6)
    assert tr.seconds(exclude=('scatter', 'gather')) == pytest.approx(60e-6)
    assert tr.device_ops()[0] == ['dtpu::stream_kernel', pytest.approx(4e-5)]
