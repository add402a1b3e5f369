"""devito_tpu_torch — the devito_tpu stencil DSL on PyTorch, with its hot
loop in hand-written CUDA kernels for NVIDIA Hopper.

The same sympy DSL as devito_tpu (Grid, Function, TimeFunction,
SparseTimeFunction, Eq, Inc, solve, Operator.apply) and the seismic
solvers of models/seismic. Every Function holds one torch.Tensor on
``configuration['device']`` ('cuda' by default, 'cpu' on request) and
computes in its declared dtype: fp32 in fp32, fp64 in fp64. Each dense
stencil update of an operator runs in a CUDA kernel generated from the
equation (kernels/stencil.py); on CPU tensors the kernel's plain PyTorch
version runs instead. This package imports neither jax nor devito_tpu.
"""

from .parameters import configuration, switchconfig  # noqa
from .logger import set_log_level, logger, info, perf, warning, error  # noqa
from .exceptions import (DevitoTpuError, CompilationError, InvalidOperator,  # noqa
                         InvalidArgument, ExecutionError)
from .types import (Grid, SubDomain, SubDomainSet, Border,  # noqa
                    Dimension, SpaceDimension,  # noqa
                    TimeDimension, SteppingDimension, SubDimension,
                    ConditionalDimension, DefaultDimension, Constant,
                    Function, TimeFunction, Eq, Inc, ReduceMax, ReduceMin,
                    dimensions, NODE, CELL)
from .types.relational import (Le, Lt, Ge, Gt, Ne,  # noqa
                               relational_min, relational_max)
from .types.sparse import (SparseFunction, SparseTimeFunction,  # noqa
                           PrecomputedSparseFunction,
                           PrecomputedSparseTimeFunction,
                           MatrixSparseTimeFunction)
from .types.tensor import (TensorFunction, VectorFunction,  # noqa
                           TensorTimeFunction, VectorTimeFunction)
from .finite_differences import (Derivative, Differentiable)  # noqa
from .finite_differences.coefficients import (Coefficient,  # noqa
                                              Substitutions)
from .types.dense import Buffer  # noqa
from .finite_differences.operators import (div, grad, curl, laplace, diag,  # noqa
                                            div45, grad45, curl45)  # noqa
from .finite_differences.elementary import (sin, cos, tan, sqrt, exp, log,  # noqa
                                            Abs, Min, Max, floor, ceiling,
                                            sign)
from .operations.solve import solve  # noqa
from .operator import Operator  # noqa
from .builtins import (norm, inner, mmin, mmax, sumall, assign,  # noqa
                       initialize_function, gaussian_smooth)

__version__ = '0.1.0'


def clear_cache():
    """Drop this package's global symbol cache (reference: CacheManager)."""
    from .types.basic import _symbol_cache
    _symbol_cache.clear()
