"""Plain reference of the acoustic shot: the isotropic acoustic wave
equation with a damping layer, ``m u_tt - laplace(u) + damp u_t = q``
(``u_t`` the forward difference),
``m = 1 / vp^2``, second order in time, centred in space at the stated
order, solved for the next level, with the source injected and the
receivers sampled by trilinear interpolation (Devito's
``examples/seismic/acoustic/operators.py`` ``ForwardOperator``, kernel
OT2).

It works everything out from the inputs the benchmark made: the padded
velocity, the damping profile, the weights and the wavelet. Plain PyTorch
slicing on padded tensors, one step at a time; it imports nothing of the
program under test.
"""

import torch

from .common import (damping_profile, edge_pad, linear_corners,
                     second_derivative)

__all__ = ['forward']


def _interior(a, r):
    return a[r:-r, r:-r, r:-r]


def _shifted(a, r, axis, k):
    """The interior of the ``r``-padded tensor ``a`` shifted by ``k``
    points along ``axis``."""
    sl = [slice(r, a.shape[j] - r) for j in range(3)]
    sl[axis] = slice(r + k, a.shape[axis] - r + k)
    return a[tuple(sl)]


def forward(model, shot, dt, nt, dtype=torch.float32):
    """One shot over the time steps 1 .. nt-2.

    ``model``: ``vp`` (a tensor of the physical shape, on the device the
    reference runs on), ``spacing``, ``nbl``, ``space_order``. ``shot``:
    ``src`` (1, 3) and ``rec`` (nrec, 3) positions in metres and
    ``wavelet`` (nt,). Returns the record (nt, nrec) and ``{'u': the last
    level, nt-1, over the padded grid}``."""
    so, nbl = model['space_order'], model['nbl']
    h = [float(s) for s in model['spacing']]
    dev = model['vp'].device
    vp = edge_pad(model['vp'].to(dtype), nbl)
    shape = tuple(vp.shape)
    origin = [-nbl * s for s in h]
    m = 1.0 / (vp * vp)
    del vp
    damp = torch.as_tensor(damping_profile(shape, nbl, h), dtype=dtype,
                           device=dev)
    # damp u_t is the forward difference (u[t+1] - u[t]) / dt
    a = damp * dt
    del damp
    den = m + a
    c_lap = (dt * dt) / den
    c_cur = (2.0 * m + a) / den
    c_prev = -m / den
    del a, den

    r = so // 2
    offs, w = second_derivative(so)
    centre = sum(float(w[r]) / (s * s) for s in h)
    u = [torch.zeros(tuple(n + 2 * r for n in shape), dtype=dtype,
                     device=dev) for _ in range(3)]

    src_pos = torch.as_tensor(shot['src'], dtype=dtype, device=dev)
    rec_pos = torch.as_tensor(shot['rec'], dtype=dtype, device=dev)
    s_idx, s_w = linear_corners(src_pos, origin, h, shape)
    r_idx, r_w = linear_corners(rec_pos, origin, h, shape)
    s_idx = tuple(i + r for i in s_idx)
    r_idx = tuple(i + r for i in r_idx)
    # the injected term src * dt^2 / m, with m at each corner
    s_scale = s_w * (dt * dt) / m[tuple(i - r for i in s_idx)]
    wavelet = torch.as_tensor(shot['wavelet'], dtype=dtype, device=dev)
    rec = torch.zeros((nt, rec_pos.shape[0]), dtype=dtype, device=dev)

    lap = torch.empty(shape, dtype=dtype, device=dev)
    pair = torch.empty(shape, dtype=dtype, device=dev)
    for t in range(1, nt - 1):
        cur, prev, nxt = u[t % 3], u[(t - 1) % 3], u[(t + 1) % 3]
        rec[t] = (r_w * cur[r_idx]).sum(0)
        ci = _interior(cur, r)
        torch.mul(ci, centre, out=lap)
        for axis in range(3):
            for k in range(1, r + 1):
                torch.add(_shifted(cur, r, axis, k),
                          _shifted(cur, r, axis, -k), out=pair)
                lap.add_(pair, alpha=float(w[r + k]) / (h[axis] ** 2))
        ni = _interior(nxt, r)
        # the next level overwrites the oldest row, t - 2
        torch.mul(_interior(prev, r), c_prev, out=ni)
        ni.addcmul_(ci, c_cur)
        ni.addcmul_(lap, c_lap)
        nxt.index_put_(s_idx, s_scale * wavelet[t], accumulate=True)
    return rec, {'u': _interior(u[(nt - 1) % 3], r)}
