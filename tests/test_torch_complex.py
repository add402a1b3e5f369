"""Complex Constants in the port's Operator (devito_tpu_torch/operator/
operator.py ``_scalar``) against devito_tpu: a complex Constant, bound at
build and overridden at apply, keeps its complex value and dtype."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)  # complex128 paths

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def _override(pkg, dtype, **apply):
    """tests/test_complex_port.py test_complex_override: u = x h_x +
    c y h_y on a 5x5 grid, c complex."""
    grid = pkg.Grid(shape=(5, 5))
    x, y = grid.dimensions
    c = pkg.Constant(name='c', dtype=dtype, value=1.0 + 0.5j)
    u = pkg.Function(name='u', grid=grid, dtype=dtype)
    pkg.Operator(pkg.Eq(u, x * x.spacing + c * y * y.spacing)).apply(**apply)
    return np.asarray(u.data)


@pytest.mark.parametrize('apply', [{}, {'c': 2.0 + 1.0j}],
                         ids=['bound', 'overridden'])
@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
def test_complex_constant_matches_reference(dtype, apply):
    args = {k: dtype(v) for k, v in apply.items()}
    want = _override(dj, dtype, **args)
    dt.clear_cache()
    got = _override(dt, dtype, **args)
    assert got.dtype == want.dtype == dtype
    assert np.abs(want.imag).max() > 0
    assert np.allclose(got, want)
    # the reference test's own expectation
    grid = dt.Grid(shape=(5, 5))
    dx, dy = grid.spacing_map.values()
    xx, yy = np.meshgrid(np.linspace(0, 4, 5, dtype=dtype),
                         np.linspace(0, 4, 5, dtype=dtype))
    c = args.get('c', dtype(1.0 + 0.5j))
    assert np.allclose(got.T, xx * float(dx) + yy * float(dy) * c)
