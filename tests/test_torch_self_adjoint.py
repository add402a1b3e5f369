"""The self-adjoint variable-density propagator through devito_tpu_torch
against devito_tpu, in fp64: both packages build ``sa_setup``'s model,
the port's state (vp, b, the w/Q attenuation field and the source)
carried over from devito_tpu's; the forward's receivers and wavefield and
the adjoint's source record and wavefield agree to rtol 1e-10 (max |diff|
over max |devito_tpu|) in 2-D and 3-D; through the port, the dot test of
tests/test_self_adjoint.py holds at atol 1e-11 and the forward is linear
in the source (rtol 1e-10)."""

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu_torch.builtins import inner, norm
from devito_tpu_torch.models import seismic as st_
from test_torch_elastic import plans_all_on_k1, solver_pair

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


@pytest.mark.parametrize('shape,tn', [((41, 41), 250.), ((14, 15, 16), 150.)])
def test_forward_and_adjoint_match_devito_tpu(shape, tn):
    st, sj = solver_pair('sa_setup', shape=shape, spacing=(10.,) * len(shape),
                         tn=tn, space_order=8, dtype=np.float64)
    outs = []
    for s in (st, sj):
        rec, u, _ = s.forward()
        srca, v, _ = s.adjoint(rec)
        outs.append([np.array(f.data) for f in (rec, u, srca, v)])
    for got, want in zip(*outs):
        assert got.shape == want.shape and np.abs(want).max() > 0
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert plans_all_on_k1(st.op_fwd(None)) and plans_all_on_k1(st.op_adj())


def test_dot_test():
    s = st_.sa_setup(shape=(41, 41), spacing=(10., 10.), tn=250.,
                     space_order=8, dtype=np.float64)
    rec, _, _ = s.forward()
    assert np.isfinite(rec.data).all() and norm(rec) > 1
    srca, _, _ = s.adjoint(rec)
    t1, t2 = inner(srca, s.geometry.src), norm(rec) ** 2
    assert np.isclose((t1 - t2) / t1, 0., atol=1e-11)


def test_linearity():
    s = st_.sa_setup(shape=(41, 41), spacing=(10., 10.), tn=150.,
                     space_order=8, dtype=np.float64)
    src = s.geometry.src
    rec1 = np.array(s.forward(src=src)[0].data)
    src2 = s.geometry.new_src(name='src2', src_type=None)
    src2.data[:] = 2.5 * np.asarray(src.data)
    rec2 = np.array(s.forward(src=src2)[0].data)
    assert np.abs(rec1).max() > 0
    assert np.allclose(rec2, 2.5 * rec1, rtol=1e-10, atol=0)
