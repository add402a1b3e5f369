"""devito_tpu_torch.checkpointing: the optimal schedule against brute
force, the Revolver's forward counts and live snapshots
(tests/test_checkpointing.py's patterns), the equal-segments path beyond
the exact planner's cap, snapshots that stay on their device, and the
checkpointed FWI gradient: bit-equal to the full-save one within the port
and within rtol 1e-11 of devito_tpu's (tests/test_checkpointing.py:120)."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu.builtins import smooth as smooth_j  # noqa: E402
from devito_tpu.models import seismic as sj  # noqa: E402
from devito_tpu_torch import checkpointing as CK  # noqa: E402
from devito_tpu_torch.builtins import smooth  # noqa: E402
from devito_tpu_torch.models import seismic as st  # noqa: E402
from devito_tpu_torch.utils import load_numpy_state, numpy_state  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


@lru_cache(maxsize=None)
def _t_bruteforce(n, c):
    """Independent memoized evaluation of the binomial recurrence."""
    if n <= 1:
        return 0
    if c == 0:
        return n * (n - 1) // 2
    return min(m + _t_bruteforce(n - m, c - 1) + _t_bruteforce(m, c)
               for m in range(1, n))


@pytest.mark.parametrize('n', [1, 2, 3, 5, 10, 20, 37, 60])
def test_optimal_count_matches_bruteforce(n):
    for c in (0, 1, 2, 3, 5, 8):
        assert CK.optimal_forward_count(n, c) == _t_bruteforce(n, c)


class _CountingOp:
    def __init__(self):
        self.count = 0

    def apply(self, a, b):
        self.count += b - a + 1


class _CountingRev:
    def __init__(self):
        self.reversed_ts = []

    def apply(self, a, b):
        assert a == b
        self.reversed_ts.append(a)


class _CountingCp:
    def __init__(self):
        self.n_live = 0
        self.max_live = 0

    def save(self):
        self.n_live += 1
        self.max_live = max(self.max_live, self.n_live)
        return object()

    def load(self, state):
        pass


def _counted(nt, ncp):
    fw, rv, cp = _CountingOp(), _CountingRev(), _CountingCp()
    r = CK.Revolver(cp, fw, rv, ncp, nt, t_min=1)
    orig_exec = r._exec

    def counting_exec(action, recompute):
        if action[0] == 'free':
            cp.n_live -= 1
        orig_exec(action, recompute)

    r._exec = counting_exec
    return r, fw, rv, cp


@pytest.mark.parametrize('nt,ncp', [(100, 10), (1000, 30), (7, 3), (17, 2),
                                    (412, 20)])
def test_revolver_schedule_is_griewank_walther_optimal(nt, ncp):
    """Executed forward-application counts equal the Griewank-Walther
    optimum (+1 final completion step) and memory stays within the
    checkpoint budget."""
    r, fw, rv, cp = _counted(nt, ncp)
    r.apply_forward()
    assert fw.count == nt  # single full sweep, no recompute going forward
    r.apply_reverse()
    opt = CK.optimal_forward_count(nt, ncp - 1)
    # +1: the completion step that finishes the forward outputs at nt-1
    assert fw.count == r.forward_steps == opt + 1
    assert r.reverse_recompute_steps == opt + 1 - nt
    assert cp.max_live <= ncp
    # every timestep reversed exactly once, in descending order
    assert rv.reversed_ts == list(range(nt, 0, -1))


def test_revolver_default_snapshots_at_forward_shot_size():
    """The forward shot's 412 steps (time_m=1 .. time_M=nt-2, nt=414)
    take int(sqrt(412)) = 20 snapshots by default and 983 + 1 forward
    steps."""
    r, fw, rv, cp = _counted(412, None)
    r.apply_forward()
    r.apply_reverse()
    assert r.n_checkpoints == 20
    assert CK.optimal_forward_count(412, 19) == 983
    assert r.forward_steps == 984 and cp.max_live <= 20


def test_revolver_equal_segments_beyond_the_cap(monkeypatch):
    """Beyond the exact planner's cap the Revolver plans equal top-level
    segments and exact sub-plans within: every step is still reversed
    once, in order, within the snapshot budget."""
    monkeypatch.setattr(CK, '_EXACT_PLANNER_CAP', 50)
    fw, rv = _CountingOp(), _CountingRev()
    r = CK.Revolver(_CountingCp(), fw, rv, 8, 130, t_min=1)
    assert not r._exact and len(r._segments) == 4
    live = []
    orig_exec = r._exec

    def counting_exec(action, recompute):
        orig_exec(action, recompute)
        live.append(len(r._stored))

    r._exec = counting_exec
    r.apply_forward()
    assert fw.count == 130 and len(r._stored) == 4
    r.apply_reverse()
    assert rv.reversed_ts == list(range(130, 0, -1))
    assert max(live) <= 8 and not r._stored
    assert r.reverse_recompute_steps == fw.count - 130


def test_checkpoint_snapshots_stay_on_the_device():
    """save clones each function's tensor where it lives; load copies the
    snapshot back into that same tensor, which stays authoritative."""
    grid = dt.Grid(shape=(6, 7))
    u = dt.TimeFunction(name='u', grid=grid, time_order=2, space_order=2)
    w = dt.Function(name='w', grid=grid, space_order=2)
    u.data[:] = np.arange(np.prod(u.shape)).reshape(u.shape)
    w.data[:] = 3.
    cp = CK.DevitoCheckpoint([u, w])
    assert cp.size == int(np.prod(u.shape_allocated)) + \
        int(np.prod(w.shape_allocated))
    snap = cp.save()
    buf = u._device_array()
    assert all(isinstance(s, torch.Tensor) for s in snap)
    assert snap[0].device == buf.device and \
        snap[0].data_ptr() != buf.data_ptr()
    buf.add_(1.)
    u._set_device_array(buf)
    cp.load(snap)
    assert u._device_array().data_ptr() == buf.data_ptr()
    assert np.array_equal(u.data, np.arange(np.prod(u.shape))
                          .reshape(u.shape))
    assert np.all(w.data == 3.)


@pytest.fixture(scope='module')
def fwi():
    """devito_tpu's FWI problem (tests/test_checkpointing.py:104): its
    state, its full-save gradient and its checkpointed gradient."""
    kw = dict(shape=(40, 45), spacing=(10., 10.), dtype=np.float64,
              kernel='OT2', tn=250.0, space_order=4, nbl=20)
    wave = sj.acoustic_setup(**kw)
    vel0 = dj.Function(name='vel0', grid=wave.model.grid, space_order=4)
    smooth_j(vel0, wave.model.vp)
    rec = wave.forward()[0]
    rec0, u0 = wave.forward(vp=vel0, save=True)[0:2]
    residual = sj.Receiver(name='resid', grid=wave.model.grid,
                           data=np.asarray(rec0.data) - np.asarray(rec.data),
                           time_range=wave.geometry.time_axis,
                           coordinates=wave.geometry.rec_positions)
    state = numpy_state([wave.model.vp, wave.model.damp, residual])
    g_full, _ = wave.jacobian_adjoint(residual, u0, vp=vel0)
    g_ck, _ = wave.jacobian_adjoint(residual, None, vp=vel0,
                                    checkpointing=True)
    return kw, state, np.array(g_full.data), np.array(g_ck.data)


def test_checkpointed_gradient(fwi):
    kw, state, gj_full, gj_ck = fwi
    wave = st.acoustic_setup(**kw)
    load_numpy_state([wave.model.vp, wave.model.damp], state)
    vel0 = dt.Function(name='vel0', grid=wave.model.grid, space_order=4)
    smooth(vel0, wave.model.vp)
    u0 = wave.forward(vp=vel0, save=True)[1]
    residual = st.Receiver(name='resid', grid=wave.model.grid,
                           data=state['resid'],
                           time_range=wave.geometry.time_axis,
                           coordinates=state['resid_coords'])
    g_full = np.array(wave.jacobian_adjoint(residual, u0, vp=vel0)[0].data)
    g_ck = np.array(wave.jacobian_adjoint(residual, None, vp=vel0,
                                          checkpointing=True)[0].data)
    assert np.abs(g_full).max() > 0
    # the same kernels on the same values: bit-equal within the port
    assert np.array_equal(g_ck, g_full)
    for want in (gj_ck, gj_full):
        assert np.allclose(g_ck, want, rtol=1e-11, atol=0)
