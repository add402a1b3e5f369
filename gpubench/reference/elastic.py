"""Plain reference of the elastic shot: the isotropic velocity-stress system
on a staggered grid (Virieux, Geophysics 51(4), 1986), as Devito's
``examples/seismic/elastic/operators.py`` ``ForwardOperator`` writes it
(3-D, first order in time):

    v.forward   = damp (v + dt b div(tau))
    tau.forward = damp (tau + dt (lam diag(div(v.forward))
                                  + mu (grad(v.forward) + grad(v.forward)^T)))

``v_d`` lives half a point along axis ``d``, the normal stresses on the
nodes, ``tau_de`` half a point along ``d`` and ``e``. Every first
derivative is of the space order, taken half a point after or before the
point from the grid points around it (``common.half_point_first_derivative``):
after where the target lies half a point along the axis and the field on
the node, before where the field does and the target not. The source,
times dt, is injected into the next levels of tau_xx, tau_yy and tau_zz;
``rec1`` samples tau_zz and ``rec2`` div(v) at the nodes, each by trilinear
weights.

Where it departs from Devito's text, it follows how the program under
test evaluates the same operator:

- a parameter read half a point away is the mean of the nodes around it:
  b, and damp, arithmetically; mu harmonically, ``1 / sum(1 / (4 mu))`` over
  the four nodes of a shear stress, which is 0 where one of them is 0
  (Devito's SAFEINV);
- damp is the mask profile (1 inside, ``1 - ramp / h`` summed over the axes
  in the absorbing layer) and 0 beyond the padded grid, where the program's
  damping field holds its halo of zeros; b, lam and mu copy their edge
  values outward (the program pads its parameters so);
- lam times div(v.forward) is the same product the program's schedule
  holds in a temporary; v and tau are updated in place, each level
  overwriting the last, as each point reads only its own previous value.

It works everything out from the benchmark's inputs (the padded velocity,
from which ``parameters`` derives vs and b as the ``layers-elastic`` preset
does, the mask profile, the weights, the wavelet), in plain PyTorch
slicing, and imports nothing of the program under test.

A survey's shots start near the surface, in the preset's top layer, which
is water (mu = 0): within the benchmark's 250 ms their waves never reach
the solid, so tau_xy, tau_xz and tau_yz stay 0 and no shear term is
exercised. So ``forward`` also runs the probe shot (``probe``): one source
``PROBE_BELOW`` grid points below the water-solid interface, whose final
wavefields carry shear stress, P and S waves and the interface between
them. The program side runs the same probe after its own shots.
"""

import numpy as np
import torch

from .common import (damping_profile, edge_pad, half_point_first_derivative,
                     linear_corners)

__all__ = ['parameters', 'probe', 'records', 'forward', 'COMPONENTS']

#: the nine wavefields, by the program's names: v_x at axis 0 and so on
VELOCITY = ('v_x', 'v_y', 'v_z')
STRESS = {(0, 0): 'tau_xx', (0, 1): 'tau_xy', (0, 2): 'tau_xz',
          (1, 1): 'tau_yy', (1, 2): 'tau_yz', (2, 2): 'tau_zz'}
COMPONENTS = VELOCITY + tuple(STRESS.values())

#: below this P velocity (km/s) the preset's layer is water: vs 0, b 1
WATER_VP = 1.51
#: the probe shot's source lies this many grid points below the water
PROBE_BELOW = 3
#: rec2's weight in a shot's compared record: the ratio of rec1's largest
#: value to rec2's, 23.33-23.40 in every run at the cell's own size
#: (rec1 0.163-0.184, rec2 0.0071-0.0078), rounded up
REC2_WEIGHT = 24.0


def parameters(vp):
    """(vs, b) of the ``layers-elastic`` preset (Devito's
    ``examples/seismic/preset_models.py``) from ``vp`` (km/s; a numpy array
    or a tensor, whose type and dtype they keep): vs = vp / 2 and Gardner's
    buoyancy b = 1 / (0.31 (1000 vp)^0.25), with vs = 0 and b = 1 in the
    water, where vp < 1.51."""
    vs = 0.5 * vp
    b = 1.0 / (0.31 * (1e3 * vp) ** 0.25)
    water = vp < WATER_VP
    vs[water] = 0.0
    b[water] = 1.0
    return vs, b


def _window(a, lo, shape, axis=None, k=0):
    """The ``shape``-sized block of ``a`` starting at ``lo`` on each axis,
    shifted by ``k`` points along ``axis``."""
    sl = [slice(lo, lo + n) for n in shape]
    if axis is not None:
        sl[axis] = slice(lo + k, lo + k + shape[axis])
    return a[tuple(sl)]


def _mean(p, axes, shape, harmonic=False):
    """``p`` (edge-padded by one point after the grid) averaged over the
    nodes at 0 and +1 along each of ``axes``: the point half a point
    along them."""
    n = 2 ** len(axes)
    out = torch.zeros(shape, dtype=p.dtype, device=p.device)
    for corner in range(n):
        sl = [slice(0, s) for s in shape]
        for j, axis in enumerate(axes):
            if (corner >> j) & 1:
                sl[axis] = slice(1, 1 + shape[axis])
        c = p[tuple(sl)]
        out.add_(1.0 / (n * c) if harmonic else c / n)
    return 1.0 / out if harmonic else out


def probe(vp, spacing):
    """The probe shot's source (1, 3), in metres from the physical grid's
    origin: x and y at the centre of the grid, z ``PROBE_BELOW`` points
    below the first solid point (vp >= ``WATER_VP``) of the centre column
    of ``vp`` (the physical shape; numpy or a tensor)."""
    nx, ny, nz = vp.shape
    col = vp[nx // 2, ny // 2]
    col = col.cpu().numpy() if torch.is_tensor(col) else np.asarray(col)
    solid = np.flatnonzero(col >= WATER_VP)
    if not len(solid) or solid[0] + PROBE_BELOW >= nz:
        raise ValueError("the model's centre column has no solid layer "
                         f"{PROBE_BELOW} points above its bottom")
    h = [float(s) for s in spacing]
    return np.array([[(nx - 1) * h[0] / 2, (ny - 1) * h[1] / 2,
                      (solid[0] + PROBE_BELOW) * h[2]]])


def records(rec1, rec2):
    """A shot's compared record (2, nt, nrec): rec1 and rec2 stacked, rec2
    times ``REC2_WEIGHT``, so that the stack's largest value is about each
    record's own and the check's error over the stack holds each record on
    about its own scale (numpy arrays or tensors)."""
    stack = torch.stack if torch.is_tensor(rec1) else np.stack
    return stack([rec1, REC2_WEIGHT * rec2])


def forward(model, shot, dt, nt, dtype=torch.float32):
    """The check's side of the last shot: the shot itself and the probe
    shot (``probe``). Returns the shot's record (``records``) and ``{name:
    array}``: the shot's nine final components (``COMPONENTS``) and the
    probe's (``'probe.<name>'``), each of which the check holds on its own
    scale.

    ``model``: ``vp`` (a tensor of the physical shape, on the device the
    reference runs on), ``spacing``, ``nbl``, ``space_order``. ``shot``:
    ``src`` (1, 3) and ``rec`` (nrec, 3) positions in metres and
    ``wavelet`` (nt,)."""
    rec, final = run_shot(model, shot, dt, nt, dtype)
    at = probe(model['vp'], model['spacing'])
    _, deep = run_shot(model, dict(shot, src=at), dt, nt, dtype)
    final.update((f'probe.{k}', a) for k, a in deep.items())
    return records(rec[0], rec[1]), final


def run_shot(model, shot, dt, nt, dtype=torch.float32):
    """One shot over the time steps 0 .. nt-2: first order in time, the
    step at t reads level t alone, so the loop starts at 0 (the program's
    default range, as Devito's). ``model`` and ``shot`` as ``forward``'s.
    Returns the records (2, nt, nrec), rec1 (tau_zz) then rec2 (div v),
    and ``{name: the last level, nt-1, over the padded grid}`` of the nine
    components (``COMPONENTS``)."""
    so, nbl = model['space_order'], model['nbl']
    h = [float(s) for s in model['spacing']]
    dev = model['vp'].device
    taps = {side: half_point_first_derivative(so, side) for side in (1, -1)}
    R = so // 2                         # the derivatives' reach

    # the parameters, one point wider after the grid: a staggered point
    # averages the nodes at 0 and +1
    vp = edge_pad(model['vp'].to(dtype), nbl + 1)[1:, 1:, 1:]
    vs, b = parameters(vp)
    lam = ((vp * vp - 2.0 * vs * vs) / b)[:-1, :-1, :-1].contiguous()
    mu = vs * vs / b
    del vp, vs
    shape = tuple(lam.shape)
    origin = [-nbl * s for s in h]
    mask = torch.zeros(tuple(n + 1 for n in shape), dtype=dtype, device=dev)
    mask[:-1, :-1, :-1] = 1.0 - torch.as_tensor(
        damping_profile(shape, nbl, h), dtype=dtype, device=dev)

    # velocity: v_d = mv[d] (v_d + dt b_d div(tau)_d), both at half a
    # point along d
    mv = [_mean(mask, (d,), shape) for d in range(3)]
    bv = [_mean(b, (d,), shape).mul_(dt) for d in range(3)]
    del b
    # shear stress tau_de: the means over the four nodes of (d, e)
    shear = sorted(k for k in STRESS if k[0] != k[1])
    mt = {k: _mean(mask, k, shape) for k in shear}
    mut = {k: _mean(mu, k, shape, harmonic=True).mul_(dt) for k in shear}
    mask = _window(mask, 0, shape).contiguous()
    mu2 = _window(mu, 0, shape).mul(2.0 * dt)
    lamdt = lam.mul_(dt)
    del mu

    def field():
        return torch.zeros(tuple(n + 2 * R for n in shape), dtype=dtype,
                           device=dev)

    v = [field() for _ in range(3)]
    tau = {k: field() for k in STRESS}

    def tensor(d, e):
        return tau[(min(d, e), max(d, e))]

    src_pos = torch.as_tensor(shot['src'], dtype=dtype, device=dev)
    rec_pos = torch.as_tensor(shot['rec'], dtype=dtype, device=dev)
    s_idx, s_w = linear_corners(src_pos, origin, h, shape)
    r_idx, r_w = linear_corners(rec_pos, origin, h, shape)
    s_idx = tuple(i + R for i in s_idx)
    s_w = s_w * dt
    wavelet = torch.as_tensor(shot['wavelet'], dtype=dtype, device=dev)
    rec = torch.zeros((2, nt, rec_pos.shape[0]), dtype=dtype, device=dev)

    acc = torch.empty(shape, dtype=dtype, device=dev)
    div = torch.empty(shape, dtype=dtype, device=dev)
    dvv = [torch.empty(shape, dtype=dtype, device=dev) for _ in range(3)]

    def deriv(f, axis, side, out, add=False):
        """The first derivative of ``f`` (zero-padded by ``R``) along
        ``axis``, half a point after (side 1) or before (-1) each point,
        into ``out`` or added to it."""
        offs, w = taps[side]
        for j, (k, wk) in enumerate(zip(offs, w)):
            tap = _window(f, R, shape, axis, k)
            if j == 0 and not add:
                torch.mul(tap, float(wk) / h[axis], out=out)
            else:
                out.add_(tap, alpha=float(wk) / h[axis])

    def rec_div():
        """div(v) at level t, sampled at the receivers' corners: each
        derivative taken before the node, from the corners' taps."""
        total = 0.0
        for d in range(3):
            offs, w = taps[-1]
            for k, wk in zip(offs, w):
                idx = [i + R for i in r_idx]
                idx[d] = idx[d] + k
                total = total + float(wk) / h[d] * v[d][tuple(idx)]
        return (r_w * total).sum(0)

    for t in range(nt - 1):
        # the records read level t, before the step overwrites it
        rec[0, t] = (r_w * tau[(2, 2)][tuple(i + R for i in r_idx)]).sum(0)
        rec[1, t] = rec_div()
        for d in range(3):
            for e in range(3):
                # tau_dd on the node: after; tau_de, half a point along e:
                # before
                deriv(tensor(d, e), e, 1 if d == e else -1, acc, add=e > 0)
            vd = _window(v[d], R, shape)
            vd.addcmul_(bv[d], acc)
            vd.mul_(mv[d])
        for d in range(3):
            # v_d lies half a point along d: taken before the node
            deriv(v[d], d, -1, dvv[d])
        torch.add(dvv[0], dvv[1], out=div)
        div.add_(dvv[2])
        div.mul_(lamdt)
        for d in range(3):
            td = _window(tau[(d, d)], R, shape)
            td.add_(div)
            td.addcmul_(mu2, dvv[d])
            td.mul_(mask)
        for d, e in shear:
            # on (d, e)'s half points: v_d's derivative along e and v_e's
            # along d, each taken after the node
            deriv(v[d], e, 1, acc)
            deriv(v[e], d, 1, acc, add=True)
            tde = _window(tau[(d, e)], R, shape)
            tde.addcmul_(mut[(d, e)], acc)
            tde.mul_(mt[(d, e)])
        q = s_w * wavelet[t]
        for d in range(3):
            tau[(d, d)].index_put_(s_idx, q, accumulate=True)
    out = {name: _window(v[d], R, shape) for d, name in enumerate(VELOCITY)}
    out.update({name: _window(tau[k], R, shape) for k, name in STRESS.items()})
    return rec, out
