"""Superstepping: advance k timesteps in one stencil application.

Reference parity: devito/timestepping/superstep.py (superstep_generator:11
— binary decomposition A^k = prod a_j A^(2^j), Nemeth et al. 2025). The
one-step update (u_next, u) = (F(u, u_prev), u) is composed with itself by
substituting shifted accesses; the composed stencil advances k steps with a
single (wider) stencil application.
"""

import sympy

from .types import Eq, TimeFunction
from .types.basic import retrieve_functions
from .ir.lowering import time_access_of, space_offsets_of
from .finite_differences.differentiable import evaluate_expr

__all__ = ['superstep_generator', 'superstep_solution_transfer']


def _shift_expr(expr, dims, offsets):
    out = sympy.sympify(expr)
    for d, k in zip(dims, offsets):
        if k:
            out = out.subs(d, d + k)
    return out


def _compose(S2, S1, u, u_prev):
    """Apply S1 then S2: substitute S2's u/u_prev accesses with S1's
    components (spatially shifted)."""
    F1, G1 = S1
    F2, G2 = S2
    dims = u.function.space_dimensions

    def sub(expr):
        mapping = {}
        for a in retrieve_functions(expr):
            f = a.function
            offs = space_offsets_of(a)
            if f.name == u.function.name:
                base = F1
            elif f.name == u_prev.function.name:
                base = G1
            else:
                continue
            mapping[a] = _shift_expr(base, dims, offs)
        return sympy.expand(expr.xreplace(mapping)) if mapping else expr

    return (sub(F2), sub(G2))


def superstep_generator(field, stencil, k, nt=0):
    """Build the k-step superstep fields and update equations.

    ``stencil``: the one-step RHS for ``field.forward`` in terms of
    ``field`` and ``field.backward``. Returns
    (u_ss, u_ss_prev, Eq(u_ss.forward, ...), Eq(u_ss_prev.forward, ...)).
    """
    if field.time_order != 2:
        raise ValueError("superstepping currently supports time_order=2")
    name = field.name
    grid = field.grid
    so = field.space_order
    u = TimeFunction(name=f'{name}_ss', grid=grid, time_order=2,
                     space_order=k * so)
    u_prev = TimeFunction(name=f'{name}_ss_p', grid=grid, time_order=2,
                          space_order=k * so)

    superstep_solution_transfer(field, u, u_prev, nt)

    # substitute the new fields into the (evaluated) one-step stencil
    ev = evaluate_expr(stencil)
    dims = field.function.space_dimensions
    mapping = {}
    for a in retrieve_functions(ev):
        if a.function.name != field.function.name:
            continue
        tk, toff = time_access_of(a)
        offs = space_offsets_of(a)
        base = u if toff == 0 else u_prev
        acc = base
        for d, kk in zip(dims, offs):
            if kk:
                acc = acc.shift(d, kk)
        mapping[a] = acc
    F1 = sympy.expand(ev.xreplace(mapping))
    one = (F1, sympy.sympify(u))

    # binary decomposition: S^k
    q, r = divmod(k, 2)
    current = one
    accumulate = one if r else None
    while q:
        q, r = divmod(q, 2)
        current = _compose(current, current, u, u_prev)
        if r:
            accumulate = current if accumulate is None else \
                _compose(accumulate, current, u, u_prev)

    Fk, Gk = accumulate
    return u, u_prev, Eq(u.forward, Fk), Eq(u_prev.forward, Gk)


def superstep_solution_transfer(old, new, new_p, nt):
    """Transfer rolling-buffer state from a standard TimeFunction into the
    superstep pair so that at loop index ``nt``: new(nt) = old(nt) and
    new_p(nt) = old(nt-1) (reference: superstep.py:60; slot conventions
    adapted to this executor's modulo-row layout)."""
    m_old = old.time_order + 1
    m_new = new.time_order + 1
    if old.save is None:
        cur, prev = nt % m_old, (nt - 1) % m_old
    else:
        cur, prev = nt, nt - 1
    new.data[nt % m_new] = old.data[cur]
    new_p.data[nt % m_new] = old.data[prev]
