"""Multi-chip walkthrough (reference: examples/mpi notebooks — MPI
overview, distributed data initialization; here: device meshes,
sharded runs, the global-indexing Data view, and halo modes).

One process owns the mesh (``configuration['mesh-devices']`` shards in
turn on the visible devices): on the CPU 8 shards stand in for the
reference's localhost mpiexec, on one H100 four shards share the card.
"""

import numpy as np

from devito_tpu_torch import (Grid, TimeFunction, Eq, Operator, solve,
                              switchconfig)

__all__ = ['sharded_diffusion', 'topologies_demo', 'halo_modes_demo']


def sharded_diffusion(shape=(64, 64), steps=40, topology=('*', '*')):
    """Shard the grid over the mesh; same user code as single-chip
    (reference: DEVITO_MPI=1 runs of unchanged scripts). ``topology=None``
    runs unsharded."""
    kw = {'topology': topology} if topology is not None else {}
    grid = Grid(shape=shape, extent=tuple(float(s - 1) for s in shape),
                dtype=np.float64, **kw)
    u = TimeFunction(name='u', grid=grid, space_order=2)
    u.data[0, shape[0] // 2, shape[1] // 2] = 1.
    op = Operator(Eq(u.forward, solve(Eq(u.dt, 0.2 * u.laplace),
                                      u.forward)), subs=grid.spacing_map)
    op.apply(time_M=steps - 1, dt=0.1)
    return u, grid


def topologies_demo():
    """CustomTopology shortcuts (reference: mpi/distributed.py
    CustomTopology '*' semantics)."""
    out = {}
    for topo in (('*', '*'), ('*', 1), (1, '*')):
        g = Grid(shape=(32, 32), extent=(31., 31.), topology=topo)
        dist = g.distributor
        out[topo] = dist.topology if dist is not None else None
    return out


def halo_modes_demo(steps=20):
    """The halo modes, numerically equal (reference: the 6 generated MPI
    exchange schemes): 'explicit', the halo exchange as copies between
    the shards' tensors, which raises for a schedule it cannot take, and
    'auto', which runs such a schedule gathered on the whole tensors
    instead. devito_tpu's third mode, 'gspmd' (XLA's partitioner), has no
    counterpart here and is refused. Returns {mode: u.data}."""
    results = {}
    for mode in ('auto', 'explicit'):
        with switchconfig(halo=mode):
            grid = Grid(shape=(64, 64), extent=(63., 63.),
                        dtype=np.float64, topology=('*', '*'))
            u = TimeFunction(name='u', grid=grid, space_order=2)
            u.data[0, 32, 32] = 1.
            op = Operator(Eq(u.forward, solve(Eq(u.dt, 0.2 * u.laplace),
                                              u.forward)),
                          subs=grid.spacing_map)
            op.apply(time_M=steps - 1, dt=0.1)
            results[mode] = np.asarray(u.data).copy()
    return results
