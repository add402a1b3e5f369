"""Distributor: a Grid's spatial domain decomposition over a mesh of shards.

Reference parity: devito_tpu/parallel/distributor.py (itself the TPU
analog of devito/mpi/distributed.py Distributor:316 and CustomTopology:905).
devito_tpu lays its mesh over JAX devices; here the mesh is an array of
``torch.device``s shaped like the topology, one entry a shard. One Python
process drives every shard (devito_tpu's single-controller design): the
shards' tensors are separate, and the halo exchange between them is copies
(parallel/halo.py). Several shards may share one device, as XLA's virtual
host devices share one CPU: ``configuration['mesh-devices']`` sets their
number, placed in turn on the visible devices of ``configuration['device']``.
"""

import numpy as np
import torch

from ..parameters import configuration, torch_device

__all__ = ['Distributor', 'compute_dims', 'mesh_devices']


def compute_dims(nprocs, ndim):
    """Factor ``nprocs`` into a balanced ``ndim``-tuple (reference:
    compute_dims, mpi/distributed.py:1011 — MPI_Dims_create-like)."""
    dims = [1] * ndim
    remaining = nprocs
    primes = []
    n = remaining
    f = 2
    while f * f <= n:
        while n % f == 0:
            primes.append(f)
            n //= f
        f += 1
    if n > 1:
        primes.append(n)
    for p in sorted(primes, reverse=True):
        i = int(np.argmin(dims))
        dims[i] *= p
    return tuple(sorted(dims, reverse=True))


def _visible():
    """The visible devices of ``configuration['device']``: every CUDA
    device, or the CPU."""
    dev = torch_device()
    if dev.type == 'cuda':
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [torch.device('cpu')]


def mesh_devices():
    """The devices of a default mesh, one entry a shard:
    ``configuration['mesh-devices']`` shards (None: one a visible device)
    placed in turn on the visible devices."""
    visible = _visible()
    n = configuration['mesh-devices']
    n = len(visible) if n is None else int(n)
    if n < 1:
        raise ValueError(f"mesh-devices={n}: a mesh needs a shard")
    return [visible[i % len(visible)] for i in range(n)]


def _mesh(devices, topology):
    mesh = np.empty(len(devices), dtype=object)
    mesh[:] = list(devices)
    return mesh.reshape(topology)


class Distributor:
    """Maps a Grid's space dimensions onto a mesh of shards.

    ``topology``: per-dim shard counts (``'*'`` entries derived, as in the
    reference's CustomTopology shortcuts), or None: the outermost (up to
    two) dimensions sharded and the innermost kept whole, which the
    stencil kernel's streaming design reads in contiguous TMA boxes.
    ``devices``: one ``torch.device`` a shard (default ``mesh_devices()``).
    """

    def __init__(self, grid, topology=None, devices=None, axis_names=None):
        self._grid = grid
        devices = list(devices) if devices is not None else mesh_devices()
        nd = grid.dim
        nprocs = len(devices)
        if topology is None:
            if nd == 1:
                topo = (nprocs,)
            else:
                t2 = compute_dims(nprocs, min(nd, 2))
                topo = t2 + (1,) * (nd - len(t2))
        else:
            topo = []
            known = 1
            stars = 0
            for t in topology:
                if t == '*':
                    stars += 1
                else:
                    known *= int(t)
            fill = compute_dims(nprocs // known, stars) if stars else ()
            fi = 0
            for t in topology:
                if t == '*':
                    topo.append(fill[fi])
                    fi += 1
                else:
                    topo.append(int(t))
            topo = tuple(topo)
        if int(np.prod(topo)) != nprocs:
            raise ValueError(f"Topology {topo} != {nprocs} devices")
        self._topology = topo
        self._axis_names = tuple(axis_names or
                                 (d.name for d in grid.dimensions))
        self._mesh = _mesh([torch.device(d) for d in devices], topo)

    # torch devices pickle, but the host that loads the pickle may hold
    # fewer cards: the mesh's device names are re-bound on load, and a
    # missing one raises (reference: devito_tpu re-binds jax.devices())
    def __getstate__(self):
        state = dict(self.__dict__)
        state['_mesh'] = [str(d) for d in self._mesh.flat]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        names = self._mesh
        ncuda = torch.cuda.device_count()
        missing = [n for n in names if n.startswith('cuda') and
                   (torch.device(n).index or 0) >= ncuda]
        if missing:
            raise RuntimeError(
                f"unpickling a Distributor over {len(names)} shards on "
                f"{sorted(set(names))} but only {ncuda} CUDA device(s) "
                f"available")
        self._mesh = _mesh([torch.device(n) for n in names], self._topology)

    @property
    def mesh(self):
        """The ``torch.device`` of each shard, shaped like the topology."""
        return self._mesh

    @property
    def devices(self):
        """The shards' devices in mesh (C) order."""
        return list(self._mesh.flat)

    @property
    def topology(self):
        return self._topology

    @property
    def nprocs(self):
        return int(np.prod(self._topology))

    @property
    def axis_names(self):
        return self._axis_names

    @property
    def shape_local(self):
        return tuple(s // t for s, t in zip(self._grid.shape,
                                            self._topology))

    def __repr__(self):
        return f"Distributor(topology={self._topology})"
