"""The viscoelastic (SLS) forward model through devito_tpu_torch against
devito_tpu: both packages build ``viscoelastic_setup``'s layered model,
the port's state (lam, mu, b, qp, qs, the mask damping and the source)
carried over from devito_tpu's. Both receivers and every component of v,
tau and the memory variable r agree to rtol 1e-10 in fp64 and 5e-4 in
fp32; the reference norms hold through the port in fp32 and fp64."""

import numpy as np
import pytest
import torch

import devito_tpu as dj
import devito_tpu_torch as dt
from devito_tpu_torch.builtins import norm
from devito_tpu_torch.models import seismic as st_
from test_torch_elastic import (RTOL, assert_pairs_close, components,
                                plans_all_on_k1, solver_pair)

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


@pytest.mark.parametrize('shape,dtype', [
    ((30, 32), np.float64), ((12, 13, 14), np.float64),
    ((30, 32), np.float32)])
def test_forward_matches_devito_tpu(shape, dtype):
    st, sj = solver_pair('viscoelastic_setup', shape=shape,
                         spacing=(15.,) * len(shape), tn=150.,
                         space_order=4, nbl=10, dtype=dtype)
    outs = []
    for s, pkg in ((st, dt), (sj, dj)):
        # forward() returns no memory variable: pass one in
        r = pkg.TensorTimeFunction(name='r', grid=s.model.grid,
                                   space_order=4, time_order=1)
        rec1, rec2, v, tau, _ = s.forward(r=r)
        outs.append(components([rec1, rec2, v, tau, r]))
    got, want = outs
    ntens = len(shape) * (len(shape) + 1) // 2
    assert len(got) == 2 + len(shape) + 2 * ntens
    assert_pairs_close(got, want, RTOL[dtype])
    assert plans_all_on_k1(st.op_fwd(None))


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_reference_norms(dtype):
    """examples/seismic/viscoelastic's run (tests/test_viscoelastic.py)."""
    s = st_.viscoelastic_setup(shape=(50, 50), spacing=(20., 20.),
                               tn=1000., space_order=4, nbl=40, dtype=dtype)
    rec1, rec2, _, _, _ = s.forward()
    assert np.isfinite(rec1.data).all() and np.isfinite(rec2.data).all()
    assert np.isclose(norm(rec1), 12.62339, atol=1e-3, rtol=0)
    assert np.isclose(norm(rec2), 0.330103, atol=1e-3, rtol=0)
