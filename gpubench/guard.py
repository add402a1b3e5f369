"""The import guard: the run fails when the JAX package under study or
JAX itself is loaded. Module names are compared by their top-level name
(the part before the first dot), whole: ``devito_tpu_torch``, the program
under test, begins with ``devito_tpu`` and is not one of them."""

import sys

__all__ = ['FORBIDDEN', 'loaded']

FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'devito_tpu'})


def loaded(modules=None):
    """The forbidden top-level names among ``modules`` (by default the
    modules loaded in this process), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names} & FORBIDDEN)
