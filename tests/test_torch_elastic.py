"""The elastic forward model through devito_tpu_torch against devito_tpu:
both packages build ``elastic_setup``'s layered model, the port's state
(lam, mu, b, the mask damping and the source) carried over from
devito_tpu's with ``load_numpy_state``. Both receivers (tau_zz and div(v))
and every wavefield component agree to rtol 1e-10 in fp64 and 5e-4 in
fp32 (max |diff| over max |devito_tpu|), in 2-D and 3-D; the reference
norms hold through the port; and the port's CIRE schedule of the
staggered system is devito_tpu's, item for item."""

import numpy as np
import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu.models import seismic as sj_
from devito_tpu_torch.builtins import norm
from devito_tpu_torch.models import seismic as st_
from devito_tpu_torch.utils import load_numpy_state, numpy_state
from test_torch_cire import schedule_items

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

RTOL = {np.float64: 1e-10, np.float32: 5e-4}


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def model_state(s):
    """The functions of a solver's state: the model's physical parameters
    that are Functions, its damping, the source and receivers."""
    m = s.model
    fns = [f for f in m.physical_params().values()
           if getattr(f, 'is_Function', False)]
    if getattr(m.damp, 'is_Function', False):
        fns.append(m.damp)
    return fns + [s.geometry.src, s.geometry.rec]


def solver_pair(setup, **kw):
    """(port, devito_tpu) solvers of ``models.seismic.<setup>(**kw)``, the
    port's state carried over from devito_tpu's."""
    sj = getattr(sj_, setup)(**kw)
    st = getattr(st_, setup)(**kw)
    load_numpy_state(model_state(st), numpy_state(model_state(sj)))
    assert st.dt == sj.dt
    return st, sj


def components(out):
    """The distinct arrays of a forward's outputs: sparse records, and
    each distinct component of vector and tensor wavefields."""
    arrays, seen = [], set()
    for f in out:
        comps = f.values() if hasattr(f, 'values') else \
            getattr(f, 'components', [f])
        for c in comps:
            if c != 0 and c.name not in seen:
                seen.add(c.name)
                arrays.append((c.name, np.array(c.data)))
    return arrays


def assert_pairs_close(got, want, rtol):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and np.abs(b).max() > 0, name
        assert np.abs(a - b).max() <= rtol * np.abs(b).max(), name


def plans_all_on_k1(op):
    """Every dense equation of ``op`` is planned for K1 (none runs in the
    torch translator)."""
    plans = op.kernel_plans
    return plans and all(p is not None for _, p in plans)


@pytest.mark.parametrize('shape,dtype', [
    ((30, 32), np.float64), ((14, 15, 16), np.float64),
    ((30, 32), np.float32)])
def test_forward_matches_devito_tpu(shape, dtype):
    st, sj = solver_pair('elastic_setup', shape=shape,
                         spacing=(15.,) * len(shape), tn=150.,
                         space_order=4, nbl=10, dtype=dtype)
    got, want = (components(s.forward()[:4]) for s in (st, sj))
    assert len(got) == 2 + len(shape) + len(shape) * (len(shape) + 1) // 2
    assert_pairs_close(got, want, RTOL[dtype])
    assert plans_all_on_k1(st.op_fwd(None))


def test_reference_norms():
    """examples/seismic/elastic's run (tests/test_elastic.py)."""
    s = st_.elastic_setup(shape=(50, 50), spacing=(20., 20.), tn=1000.,
                          space_order=4, nbl=40)
    rec1, rec2, _, _, _ = s.forward()
    assert np.isclose(norm(rec1), 19.9367, atol=1e-2, rtol=0)
    assert np.isclose(norm(rec2), 0.6689, atol=1e-3, rtol=0)


@pytest.mark.parametrize('shape', [(30, 30), (12, 13, 14)])
def test_cire_schedule_equals_devito_tpu(shape):
    """The shared diag(div(v)) group is extracted for the three node
    stress equations (tests/test_cire.py), and the whole schedule is
    devito_tpu's."""
    kw = dict(shape=shape, spacing=(20.,) * len(shape), tn=200.,
              space_order=4, nbl=10)
    ops = [m.elastic_setup(**kw).op_fwd() for m in (st_, sj_)]
    items = [schedule_items(op) for op in ops]
    assert any(it[2].startswith('cire') for it in items[0])
    assert items[0] == items[1]
