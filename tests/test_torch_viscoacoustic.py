"""The six viscoacoustic kernels (sls, kv and maxwell at time orders 1
and 2) through devito_tpu_torch against devito_tpu, in fp64 on
tests/test_viscoacoustic.py's 21x25 model: the port's state (vp, qp, b,
the mask damping and the source) carried over from devito_tpu's, the
forward's receivers and pressure and the adjoint's source record and
pressure agree to rtol 1e-10 (max |diff| over max |devito_tpu|); the dot
tests hold through the port at atol 1e-11; and the port's schedule of the
sls-2 adjoint under CIRE is devito_tpu's, item for item (the placement
tests/test_cire.py test_viscoacoustic_adjoint_with_cire guards)."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu.models import seismic as sj_
from devito_tpu_torch.builtins import inner, norm
from devito_tpu_torch.models import seismic as st_
from test_torch_cire import schedule_items
from test_torch_elastic import plans_all_on_k1, solver_pair

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

KERNELS = [(k, o) for k in ('sls', 'kv', 'maxwell') for o in (1, 2)]


@lru_cache(maxsize=None)
def runs(kernel, time_order):
    """{package: (rec, p, srca, pa) as arrays} of a forward and the
    adjoint of its record, and the port's dot test and whether every
    dense equation of both its operators is planned for K1."""
    st, sj = solver_pair('viscoacoustic_setup', shape=(21, 25),
                         spacing=(20., 20.), tn=250., space_order=4,
                         nbl=10, kernel=kernel, time_order=time_order,
                         dtype=np.float64)
    out = {}
    for name, s in (('port', st), ('devito_tpu', sj)):
        rec, p, _, _ = s.forward()
        srca, pa, _ = s.adjoint(rec)
        out[name] = [np.array(f.data) for f in (rec, p, srca, pa)]
        if name == 'port':
            t1, t2 = inner(srca, s.geometry.src), norm(rec) ** 2
            dot = (t1 - t2) / t1
            on_k1 = plans_all_on_k1(s.op_fwd(None)) and \
                plans_all_on_k1(s.op_adj())
    dt.clear_cache()
    return out, dot, on_k1


@pytest.mark.parametrize('kernel,time_order', KERNELS)
def test_forward_and_adjoint_match_devito_tpu(kernel, time_order):
    out, _, on_k1 = runs(kernel, time_order)
    for got, want in zip(out['port'], out['devito_tpu']):
        assert got.shape == want.shape and np.abs(want).max() > 0
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert on_k1


@pytest.mark.parametrize('kernel,time_order', KERNELS)
def test_dot_test(kernel, time_order):
    _, dot, _ = runs(kernel, time_order)
    assert np.isclose(dot, 0., atol=1e-11), dot


def test_sls2_adjoint_cire_schedule_equals_devito_tpu():
    kw = dict(shape=(40, 40), spacing=(20., 20.), tn=300., space_order=4,
              nbl=10, kernel='sls', time_order=2, dtype=np.float64)
    ops = [m.viscoacoustic_setup(**kw).op_adj() for m in (st_, sj_)]
    items = [schedule_items(op) for op in ops]
    names = [it[2] for it in items[0] if it[0] == 'body']
    # CIRE's temporaries read r.backward: scheduled after its update
    assert 'r' in names and any(n.startswith('cire') for n in names)
    assert names.index('r') < min(i for i, n in enumerate(names)
                                  if n.startswith('cire'))
    assert items[0] == items[1]
    dt.clear_cache()
