"""The FWI gradient on a sharded grid through devito_tpu_torch
(tests/test_parallel_fwi.py's cases): the forward with its save=nt
wavefield and the gradient, full-save and checkpointed, against the
port's unsharded run and devito_tpu's.

Stated tolerances (fp64): receivers and gradients within 1e-12 x max of
the port's unsharded run (the receivers' partial sums add across shards
in another order, and the adjoint injects them), the saved wavefield
bit-equal to it; all within rtol 1e-10 (x max) of devito_tpu's unsharded
run.
"""

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

from devito_tpu.models import seismic as sj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu_torch.models import seismic as st  # noqa: E402
from devito_tpu_torch.parallel.distributor import Distributor  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

TOL = 1e-10


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def grad_run(seis, shape, topology=None, checkpointing=False, tn=150.):
    solver = seis.acoustic_setup(shape=shape, spacing=[12.5] * len(shape),
                                 kernel='OT2', nbl=6, tn=tn, space_order=4,
                                 preset='layers-isotropic', dtype=np.float64)
    if topology is not None:
        n = int(np.prod(topology))
        solver.model.grid._distributor = Distributor(
            solver.model.grid, topology=topology,
            devices=[torch.device('cpu')] * n)
    rec, u, _ = solver.forward(save=not checkpointing)
    grad, _ = solver.jacobian_adjoint(rec, u, src=solver.geometry.src,
                                      checkpointing=checkpointing)
    usave = np.array(u.data) if not checkpointing else None
    return np.array(grad.data), np.array(rec.data), usave


_serial = {}


def serial(seis, shape, **kw):
    key = (seis.__name__, shape, tuple(sorted(kw.items())))
    if key not in _serial:
        _serial[key] = grad_run(seis, shape, **kw)
    return _serial[key]


def check(got, ref, want):
    (g1, r1, u1), (g0, r0, u0), (gj, rj, uj) = got, ref, want
    close(r1, r0, 1e-12)
    close(g1, g0, 1e-12)
    if u0 is not None:
        assert np.array_equal(u1, u0)
        close(u1, uj)
    close(r1, rj)
    close(g1, gj)
    assert np.abs(g0).max() > 0


@pytest.mark.parametrize('topology', [(4, 2), (2, 2)])
def test_sharded_fwi_gradient_2d(topology):
    check(grad_run(st, (36, 36), topology), serial(st, (36, 36)),
          serial(sj, (36, 36)))


def test_sharded_fwi_gradient_3d():
    shape = (20, 20, 12)
    check(grad_run(st, shape, (4, 2, 1), tn=100.),
          serial(st, shape, tn=100.), serial(sj, shape, tn=100.))


def test_sharded_checkpointed_gradient_2d():
    """The Revolver's forward and reverse applies each run sharded."""
    check(grad_run(st, (36, 36), (2, 2), checkpointing=True),
          serial(st, (36, 36), checkpointing=True),
          serial(sj, (36, 36), checkpointing=True))
