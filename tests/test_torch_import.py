"""devito_tpu_torch stands alone: it imports neither jax nor devito_tpu,
and it never runs on the CPU when CUDA was asked for."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import devito_tpu_torch
from devito_tpu_torch import (Grid, Function, TimeFunction, configuration,
                              switchconfig)
from devito_tpu_torch.exceptions import DevitoTpuError, InvalidArgument

configuration['device'] = 'cpu'
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    devito_tpu_torch.clear_cache()


def test_import_pulls_in_no_jax():
    code = ("import sys, devito_tpu_torch, devito_tpu_torch.models.seismic\n"
            "import devito_tpu_torch.experiments.stencil_probe6\n"
            "import devito_tpu_torch.experiments.stencil_probe9\n"
            "import devito_tpu_torch.experiments.stencil_probe\n"
            "import devito_tpu_torch.experiments.stencil_probe2\n"
            "import devito_tpu_torch.experiments.stencil_probe3\n"
            "import devito_tpu_torch.experiments.stencil_probe4\n"
            "import devito_tpu_torch.experiments.stencil_probe5\n"
            "import devito_tpu_torch.experiments.stencil_probe7\n"
            "from devito_tpu_torch.models.seismic import (elastic_setup, "
            "viscoelastic_setup, viscoacoustic_setup, sa_setup)\n"
            "import devito_tpu_torch.models.seismic.elastic\n"
            "import devito_tpu_torch.models.seismic.viscoelastic\n"
            "import devito_tpu_torch.models.seismic.viscoacoustic\n"
            "import devito_tpu_torch.models.seismic.self_adjoint\n"
            "from devito_tpu_torch.operations.interpolators import (\n"
            "    SincInterpolator, PrecomputedInterpolator, "
            "MatrixInterpolator)\n"
            "import devito_tpu_torch.operations.separable\n"
            "import devito_tpu_torch.timestepping\n"
            "import devito_tpu_torch.checkpointing\n"
            "import devito_tpu_torch.arch\n"
            "import devito_tpu_torch.operator.trace_profile\n"
            "import devito_tpu_torch.parallel, devito_tpu_torch.data\n"
            "from devito_tpu_torch.parallel import (Distributor, "
            "redistribute, halo)\n"
            "from devito_tpu_torch.examples import (cfd, userapi, "
            "seismic_abc, seismic_fwi, linalg, finance, multichip, "
            "compiler_tour)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'devito_tpu', 'ml_dtypes'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_exports_of_the_solver_slice():
    """The tensor types and the precomputed and matrix sparse types are
    exported as devito_tpu exports them, and each solver module names
    devito_tpu's entry points."""
    from devito_tpu_torch.models.seismic import (elastic, viscoelastic,
                                                 viscoacoustic, self_adjoint)
    for name in ('TensorFunction', 'VectorFunction', 'TensorTimeFunction',
                 'VectorTimeFunction', 'PrecomputedSparseFunction',
                 'PrecomputedSparseTimeFunction',
                 'MatrixSparseTimeFunction'):
        assert getattr(devito_tpu_torch, name).__module__.startswith(
            'devito_tpu_torch.types.')
    assert elastic.__all__ == ['ForwardElasticOperator',
                               'ElasticWaveSolver', 'elastic_setup']
    assert viscoelastic.__all__ == ['ViscoelasticForwardOperator',
                                    'ViscoelasticWaveSolver',
                                    'viscoelastic_setup']
    assert viscoacoustic.__all__ == ['ViscoForwardOperator',
                                     'ViscoAdjointOperator',
                                     'ViscoacousticWaveSolver',
                                     'viscoacoustic_setup']
    assert set(viscoacoustic.stencils) == {
        (k, o) for k in ('sls', 'kv', 'maxwell') for o in (1, 2)}
    assert self_adjoint.__all__ == ['setup_w_over_q', 'sa_iso_stencil',
                                    'IsoFwdOperator', 'IsoAdjOperator',
                                    'SaIsoWaveSolver', 'sa_setup']


@pytest.mark.parametrize('build', ['grid', 'function', 'timefunction'])
def test_cuda_without_cuda_raises(build, monkeypatch):
    grid = Grid(shape=(4, 4))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with switchconfig(device='cuda'):
        with pytest.raises(DevitoTpuError, match='is_available'):
            if build == 'grid':
                Grid(shape=(4, 4))
            elif build == 'function':
                Function(name='f', grid=grid)
            else:
                TimeFunction(name='u', grid=grid)


def test_cpu_device_and_dtypes():
    grid = Grid(shape=(5, 6), dtype=np.float64)
    u = TimeFunction(name='u', grid=grid, space_order=2)
    f = Function(name='f', grid=grid, dtype=np.float32)
    assert u._device_array().device.type == 'cpu'
    assert u._device_array().dtype == torch.float64
    assert f._device_array().dtype == torch.float32


def test_unknown_device_rejected():
    with pytest.raises(InvalidArgument):
        configuration['device'] = 'tpu'
    assert configuration['device'] == 'cpu'
