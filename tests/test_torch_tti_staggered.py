"""The staggered TTI kernel's tests of tests/test_tti_staggered.py through
devito_tpu_torch, at devito_tpu's sizes and tolerances (fp64): the dot
test (atol 1e-11), propagation, and the arrival kinematics against the
centered kernel."""

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu_torch.builtins import inner, norm
from devito_tpu_torch.models.seismic.tti import tti_setup

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


@pytest.mark.parametrize('shape, space_order', [
    ((30, 35), 8),
    ((30, 35), 4),
    ((24, 26, 22), 4),
])
def test_tti_staggered_adjoint(shape, space_order):
    solver = tti_setup(shape=shape, spacing=[15.] * len(shape), tn=500.,
                       space_order=space_order, nbl=10, kernel='staggered',
                       dtype=np.float64)
    rec, u, v, _ = solver.forward()
    assert np.isfinite(rec.data).all()
    srca, p, r, _ = solver.adjoint(rec=rec)
    term1 = inner(srca, solver.geometry.src)
    term2 = norm(rec) ** 2
    assert np.isclose((term1 - term2) / term1, 0., atol=1.e-11), \
        (term1, term2)


def test_tti_staggered_forward_propagates():
    solver = tti_setup(shape=(30, 35), spacing=(15., 15.), tn=500.,
                       space_order=8, kernel='staggered', nbl=10,
                       dtype=np.float64)
    rec, u, v, _ = solver.forward()
    assert np.isfinite(rec.data).all()
    assert norm(rec) > 1


def test_tti_staggered_vs_centered_kinematics():
    recs = {}
    for kernel in ('staggered', 'centered'):
        solver = tti_setup(shape=(30, 35), spacing=(15., 15.), tn=400.,
                           space_order=8, kernel=kernel, nbl=10,
                           dtype=np.float64)
        rec, _, _, _ = solver.forward()
        recs[kernel] = np.array(rec.data)
    mid = recs['staggered'].shape[1] // 2
    pk_s = np.argmax(np.abs(recs['staggered'][:, mid]))
    pk_c = np.argmax(np.abs(recs['centered'][:, mid]))
    assert abs(int(pk_s) - int(pk_c)) <= 12, (pk_s, pk_c)
