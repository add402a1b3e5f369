"""The TTI adjoint, Born (``jacobian``) and gradient
(``jacobian_adjoint``) operators through devito_tpu_torch against
devito_tpu, centered kernel in 2-D and 3-D: both packages from the same
model, source and receiver state (``solver_pair`` of test_torch_tti.py),
fed the same receiver data, their outputs agree to fp64 rtol 1e-10 (max
|diff| over max |devito_tpu|). The dot tests of test_torch_tti_adjoint.py
hold each pair against itself; these hold it against the reference."""

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from test_torch_tti import RTOL, assert_close, solver_pair

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


@pytest.mark.parametrize('shape,so,tn', [
    ((30, 35), 8, 250.),
    ((24, 26, 28), 4, 150.),
])
def test_adjoint_matches_devito_tpu(shape, so, tn):
    """The adjoint operator: from the same receiver data (devito_tpu's
    forward record), the port's srca and its adjoint wavefields p and r
    equal devito_tpu's, fp64 rtol 1e-10."""
    st, sj = solver_pair(shape, so, 'centered', np.float64, 7, tn)
    recj = sj.forward()[0]
    rect = st.forward()[0]
    rect.data[:] = np.array(recj.data)
    outs = [[np.array(f.data) for f in s.adjoint(r)[:3]]
            for s, r in ((st, rect), (sj, recj))]
    assert_close(zip(*outs), RTOL[np.float64])


@pytest.mark.parametrize('shape,so,tn', [
    ((30, 35), 4, 250.),
    ((24, 26, 28), 4, 150.),
])
def test_jacobian_pair_matches_devito_tpu(shape, so, tn):
    """The Born operator (``jacobian``) and the gradient
    (``jacobian_adjoint``): from the same model perturbation, the port's
    Born receivers and its du, dv equal devito_tpu's; from the same Born
    record and each package's saved forward, its gradient image equals
    devito_tpu's; fp64 rtol 1e-10."""
    st, sj = solver_pair(shape, so, 'centered', np.float64, 7, tn)
    vp = np.array(sj.model.vp.data)
    dm = vp ** -2 - np.full_like(vp, 1.5) ** -2
    outs = [s.jacobian(dm) for s in (st, sj)]
    assert_close(zip(*[[np.array(o[i].data) for i in (0, 3, 4)]
                       for o in outs]), RTOL[np.float64])
    born = np.array(outs[1][0].data)
    grads = []
    for s in (st, sj):
        rec_lin = s.geometry.new_rec(name='rec_lin')
        rec_lin.data[:] = born
        _, u0, v0, _ = s.forward(save=True)
        grads.append(np.array(s.jacobian_adjoint(rec_lin, u0, v0)[0].data))
    assert_close([grads], RTOL[np.float64])
