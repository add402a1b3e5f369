"""Dense linear algebra via Inc contractions over free dimensions
(reference: examples/misc/linalg.py — mat_vec, transpose_mat_vec, mat_mat,
mat_mat_sum, chain_contractions).

These are not sequential accumulation loops: an ``Inc`` whose rhs
carries dimensions absent from the lhs lowers to one multiply-reduce over
the free dimensions. K1 declines it ("increment"); the torch translator
runs it as a broadcast product summed over those dimensions.
"""

from devito_tpu_torch import Function, Inc, Operator, dimensions

__all__ = ['mat_vec', 'transpose_mat_vec', 'mat_mat', 'mat_mat_sum',
           'chain_contractions', 'make_mat', 'make_vec']


def make_mat(name, shape, dims):
    return Function(name=name, shape=shape, dimensions=dims)


def make_vec(name, n, dim):
    return Function(name=name, shape=(n,), dimensions=(dim,))


def mat_vec(A, x, b):
    """``Ax = b`` (reference linalg.py:107)."""
    Operator(Inc(b, A * x), name='MatVec').apply()
    return b


def transpose_mat_vec(A, x, b):
    """``A^T x = b`` (reference linalg.py:114)."""
    i, j = A.dimensions
    Operator([Inc(b, A[j, i] * x)], name='TransposeMatVec').apply()
    return b


def mat_mat(A, B, C):
    """``AB = C`` (reference linalg.py:122)."""
    Operator(Inc(C, A * B), name='MatMat').apply()
    return C


def mat_mat_sum(A, B, C, D):
    """``AB + AC = D`` (reference linalg.py:129)."""
    Operator(Inc(D, A * B + A * C), name='MatMatSum').apply()
    return D


def chain_contractions(A, B, C, D, E, F):
    """``AB + AC = D, DE = F`` (reference linalg.py:136)."""
    Operator([Inc(D, A * B + A * C), Inc(F, D * E)],
             name='ChainContractions').apply()
    return F


def demo(n=8):
    """Build and run every kernel on small random-free integer data."""
    import numpy as np
    i, j, k, l = dimensions('i j k l')
    A = make_mat('A', (n, n), (i, j))
    B = make_mat('B', (n, n), (j, k))
    C = make_mat('C', (n, n), (j, k))
    D = make_mat('D', (n, n), (i, k))
    E = make_mat('E', (n, n), (k, l))
    F = make_mat('F', (n, n), (i, l))
    x = make_vec('x', n, j)
    b = make_vec('b', n, i)
    rng = np.random.default_rng(0)
    for f in (A, B, C, E):
        f.data[:] = rng.standard_normal(f.shape)
    x.data[:] = rng.standard_normal(n)
    mat_vec(A, x, b)
    chain_contractions(A, B, C, D, E, F)
    return A, B, C, D, E, F, x, b
