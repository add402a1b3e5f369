"""The general generator: a configuration's model and acquisition, and a
traffic mix's source positions, all from ``--seed`` and the parameters of
the configuration's and the mix's data files.

Every seed gives the same sizes and the same amount of work (the grid,
the time axis, the receivers, the number of positions drawn); the seed
moves only the layer velocities below the top layer, within the preset's
range, and the source positions.
"""

import math

import numpy as np

from .reference.common import critical_dt

__all__ = ['rng', 'model_fields', 'time_step', 'receivers', 'sources',
           'sample']

#: one independent stream of random numbers per purpose
LAYERS, JOBS, WARMUP, SAMPLE = range(4)


def rng(seed, purpose):
    return np.random.default_rng([int(seed) % 2 ** 64, purpose])


def model_fields(config, seed):
    """The physical parameter fields of ``config``'s layout (numpy, the
    physical shape, the configuration's dtype): ``vp`` in ``nlayers``
    layers over the last axis, from ``vp_top`` to ``vp_bottom``, every
    layer below the top scaled by ``1 - draw U``; with ``thomsen``, each
    Thomsen parameter its coefficient times ``vp - vp_top``."""
    lay = config['layout']
    shape = tuple(config['shape'])
    dtype = np.dtype(config['dtype'])
    n = lay['nlayers']
    speeds = np.linspace(lay['vp_top'], lay['vp_bottom'], n)
    draw = rng(seed, LAYERS).random(n)
    speeds[1:] *= 1.0 - lay['draw'] * draw[1:]
    vp = np.empty(shape, dtype=dtype)
    nz = shape[-1]
    for i in range(n):
        vp[..., i * int(nz / n):] = speeds[i]
    fields = {'vp': vp}
    for name, coeff in lay.get('thomsen', {}).items():
        fields[name] = (coeff * (vp - dtype.type(lay['vp_top']))).astype(
            dtype)
    return fields


def time_step(config):
    """The time step of the configuration: the CFL bound at the preset's
    largest velocity (and largest epsilon), whatever the seed drew."""
    lay = config['layout']
    scale = 1.0
    eps = lay.get('thomsen', {}).get('epsilon')
    if eps is not None:
        scale = math.sqrt(1 + 2 * eps * (lay['vp_bottom'] - lay['vp_top']))
    return critical_dt(config['space_order'], config['spacing'],
                       lay['vp_bottom'], scale)


def _span(config, axis):
    o = config['origin'][axis]
    return o, o + config['spacing'][axis] * (config['shape'][axis] - 1)


def _depth(config, spacings):
    return config['origin'][-1] + spacings * config['spacing'][-1]


def receivers(config):
    """(nrec, ndim) positions of the configuration's ``receivers``: a
    regular grid over the surface, ``counts[i]`` receivers along each
    horizontal axis ``i`` (evenly from one edge of the model to the other;
    one receiver on an axis lies at its centre), ``depth_spacings`` grid
    spacings deep. Counts ``[shape[0], 1]`` are Devito's default receiver
    line along x at the y centre; ``[n, n]`` a surface grid."""
    r = config['receivers']
    axes = []
    for i, n in enumerate(r['counts']):
        lo, hi = _span(config, i)
        axes.append(np.linspace(lo, hi, n) if n > 1
                    else np.array([(lo + hi) / 2]))
    grid = np.meshgrid(*axes, indexing='ij')
    horizontal = [g.ravel() for g in grid]
    depth = np.full(horizontal[0].size, _depth(config, r['depth_spacings']))
    return np.stack(horizontal + [depth], 1)


def sources(spec, config, seed, n, purpose=JOBS):
    """(n, 1, ndim) source positions, one a job: along each horizontal
    axis ``spec['axes'][i]`` is ``'uniform'`` (drawn uniformly over the
    model's extent, from the stream ``purpose`` of ``seed``) or
    ``'centre'``; ``spec['depth_spacings']`` grid spacings deep."""
    g = rng(seed, purpose)
    cols = []
    for i, how in enumerate(spec['axes']):
        lo, hi = _span(config, i)
        if how == 'uniform':
            cols.append(g.uniform(lo, hi, size=n))
        elif how == 'centre':
            cols.append(np.full(n, (lo + hi) / 2))
        else:
            raise ValueError(f"source axis {i}: {how!r} is neither "
                             f"'uniform' nor 'centre'")
    cols.append(np.full(n, _depth(config, spec['depth_spacings'])))
    return np.stack(cols, 1)[:, None, :]


def sample(seed, done, k):
    """The indices of the ``k`` jobs of ``done`` whose outputs the check
    compares: the last one and ``k - 1`` others drawn from the seed."""
    if done == 0:
        return []
    others = rng(seed, SAMPLE).permutation(done - 1)[:max(k - 1, 0)]
    return sorted(set(int(i) for i in others) | {done - 1})
