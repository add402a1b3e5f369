"""The TTI dot tests of tests/test_adjoint.py through devito_tpu_torch, at
devito_tpu's sizes and tolerances (fp64): <F x, y> == <x, F^T y> for the
centered kernel (atol 1e-11) and <J dm, y> == <dm, J^T y> for its
Jacobian pair (atol 1e-12)."""

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
    ((24, 26, 28), 4),
    ((24, 26, 28), 8),
])
def test_adjoint_F_tti(shape, space_order):
    solver = tti_setup(shape=shape, spacing=[15.] * len(shape),
                       nbl=10, tn=250., space_order=space_order,
                       dtype=np.float64)
    rec, u, v, _ = solver.forward(save=False)
    srca, p, r, _ = solver.adjoint(rec)
    term1 = inner(srca, solver.geometry.src)
    term2 = norm(rec) ** 2
    assert np.isclose((term1 - term2) / term1, 0., atol=1.e-11), \
        (term1, term2, (term1 - term2) / term1)


def test_adjoint_J_tti():
    solver = tti_setup(shape=(25, 30), spacing=(10., 10.), tn=250.,
                       space_order=4, nbl=12, dtype=np.float64)
    vp = np.asarray(solver.model.vp.data)
    dm = (vp ** -2) - (np.full_like(vp, 1.5) ** -2)
    rec_lin = solver.jacobian(dm)[0]
    term2 = norm(rec_lin) ** 2
    rec, u0, v0, _ = solver.forward(save=True)
    im, _ = solver.jacobian_adjoint(rec_lin, u0, v0)
    term1 = float(np.dot(np.asarray(im.data).ravel(), dm.ravel()))
    assert np.isclose((term1 - term2) / term1, 0., atol=1e-12), \
        (term1, term2)
