"""Compiler-internals tour: executable condensation of the reference's
``examples/compiler`` notebook series (00-04 — expression lowering,
IR inspection, generated-code introspection).

The reference inspects `op.ccode` / the IET; here the lowered schedule
and ``op.ccode``: each dense item's K1 design and CUDA translation unit,
or the reason K1 declines it, and each sparse item's path, built on the
host with no nvcc and no card. devito_tpu shows its jaxpr and HLO
instead; this package has neither.
"""

from devito_tpu_torch import Grid, TimeFunction, Eq, Operator, solve

__all__ = ['lowering_tour', 'introspection_tour']


def lowering_tour():
    """From user equation to schedule (reference: compiler/00-02):
    returns (evaluated equation string, schedule items)."""
    grid = Grid(shape=(16, 16), extent=(15., 15.))
    u = TimeFunction(name='u', grid=grid, space_order=2)
    eq = Eq(u.forward, solve(Eq(u.dt, 0.5 * u.laplace), u.forward))

    # stage 1: symbolic evaluation (Derivative -> weighted taps)
    evaluated = eq.evaluate

    # stage 2: the Operator's lowered schedule (the single thin IR that
    # replaces the reference's LoweredEq/Cluster/ScheduleTree/IET stack)
    op = Operator(eq)
    items = list(op._schedule.body)
    return str(evaluated), items


def introspection_tour():
    """Generated-computation introspection (reference: op.ccode):
    returns (str(op), op.ccode)."""
    grid = Grid(shape=(16, 16), extent=(15., 15.))
    u = TimeFunction(name='u', grid=grid, space_order=2)
    op = Operator(Eq(u.forward, solve(Eq(u.dt, 0.5 * u.laplace),
                                      u.forward)))
    return str(op), op.ccode
