"""devito_tpu_torch.examples.seismic_abc and .seismic_fwi against
devito_tpu's examples: the ABC methods at tests/test_abc_methods.py's
size and the FWI driver at tests/test_fwi.py's, through both packages,
with the facts those tests assert held on the port's results.

Stated tolerances: the ABC examples run in fp64, each wavefield within
rtol 1e-10 x max|devito_tpu's| (the worst found is 1.8e-11, habc's 900
steps); the FWI example's model is fp32, its objective history and its
updated velocity within 1e-4 x max (the worst found is 1.3e-6).
"""

import inspect

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu_torch as dt  # noqa: E402
from devito_tpu_torch.examples import seismic_abc as ta  # noqa: E402
from devito_tpu_torch.examples import seismic_fwi as tf  # noqa: E402
from examples import seismic_abc as ja  # noqa: E402
from examples import seismic_fwi as jf  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

TOL64, TOL32 = 1e-10, 1e-4
#: tests/test_abc_methods.py's experiment: long enough for the wavefront
#: to hit and bounce off the boundaries
CFG = dict(shape=(101, 101), extent=(1000., 1000.), nt=900, dt=1.0)
#: tests/test_fwi.py's survey
FWI = dict(shape=(41, 41), nshots=2, nreceivers=15, fwi_iterations=2,
           tn=400., nbl=15)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


_energy = {}


@pytest.mark.parametrize('name', ['reflecting', 'damping_abc', 'pml_abc',
                                  'habc'])
def test_abc_matches_devito_tpu(name):
    want = np.asarray(getattr(ja, name)(**CFG).data)
    u = getattr(ta, name)(**CFG)
    got = np.asarray(u.data)
    assert got.dtype == np.float64
    close(got, want, TOL64)
    _energy[name] = ta.interior_energy(u)


@pytest.mark.parametrize('name', ['damping_abc', 'pml_abc', 'habc'])
def test_abc_absorbs(name):
    """tests/test_abc_methods.py's fact, on the port: a treated boundary
    leaves under a quarter of the reflecting case's interior energy."""
    for n in ('reflecting', name):
        if n not in _energy:
            _energy[n] = ta.interior_energy(getattr(ta, n)(**CFG))
    e, ref = _energy[name], _energy['reflecting']
    assert np.isfinite(e) and e < 0.25 * ref, (e, ref)


def test_fwi_matches_devito_tpu_and_decreases():
    hj, mj = jf.run_fwi(**FWI)
    ht, mt = tf.run_fwi(**FWI)
    close(ht, hj, TOL32)
    close(mt.vp.data, mj.vp.data, TOL32)
    assert ht[1] < ht[0]


def test_signatures_are_devito_tpu_s():
    for mod_t, mod_j in ((ta, ja), (tf, jf)):
        names = [n for n, f in vars(mod_j).items() if inspect.isfunction(f)
                 and f.__module__ == mod_j.__name__]
        assert names
        for n in names:
            assert inspect.signature(getattr(mod_t, n)) == \
                inspect.signature(getattr(mod_j, n)), n
    assert ta.__all__ == ja.__all__
