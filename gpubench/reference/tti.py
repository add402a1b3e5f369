"""Plain reference of the TTI shot: the rotated pseudo-acoustic system of
Zhang, Zhang and Zhang (Geophysics 76(3), 2011) in its self-adjoint,
centred form, as Devito's ``examples/seismic/tti/operators.py``
``kernel_centered`` writes it (3-D):

    m u_tt + damp u_t = (1 + 2 eps) Gh(u) + sqrt(1 + 2 delta) Gzz(v) + q
    m v_tt + damp v_t = sqrt(1 + 2 delta) Gh(u) + Gzz(v) + q
    Gzz(f) = sum_d D-_d[ n_d sum_e n_e D+_e f ],   Gh(f) = laplace(f) - Gzz(f)

with ``n = (sin theta cos phi, sin theta sin phi, cos theta)`` the
symmetry axis, ``D+`` and ``D-`` first derivatives of half the space
order taken half a point after and before the point, ``laplace`` of the
full space order, the source injected into both fields and the receivers
sampling ``u + v`` by trilinear interpolation; ``u_t`` is the forward
difference.

It works everything out from the inputs the benchmark made (the padded
parameters, the damping profile, the weights, the tilt's sines and
cosines, the wavelet), in plain PyTorch slicing, and imports nothing of
the program under test.
"""

import torch

from .common import (damping_profile, edge_pad, half_point_first_derivative,
                     linear_corners, second_derivative)

__all__ = ['forward']


def _window(a, lo, shape, axis=None, k=0):
    """The ``shape``-sized block of ``a`` starting at ``lo`` on each axis,
    shifted by ``k`` points along ``axis``."""
    sl = [slice(lo, lo + n) for n in shape]
    if axis is not None:
        sl[axis] = slice(lo + k, lo + k + shape[axis])
    return a[tuple(sl)]


def forward(model, shot, dt, nt, dtype=torch.float32):
    """One shot over the time steps 1 .. nt-2.

    ``model``: ``vp``, ``epsilon``, ``delta``, ``theta``, ``phi`` (tensors
    of the physical shape, on the device the reference runs on),
    ``spacing``, ``nbl``, ``space_order``. ``shot``: ``src`` (1, 3) and
    ``rec`` (nrec, 3) positions in metres and ``wavelet`` (nt,). Returns
    the record (nt, nrec) and ``{'u': ..., 'v': ...}``, the last level,
    nt-1, of each over the padded grid."""
    so, nbl = model['space_order'], model['nbl']
    h = [float(s) for s in model['spacing']]
    dev = model['vp'].device
    half = so // 2                      # the first derivatives' order
    dp_offs, dp_w = half_point_first_derivative(half, +1)
    dm_offs, dm_w = half_point_first_derivative(half, -1)
    ext = max(-min(dm_offs), max(dm_offs))      # Gzz's outer reach
    R = max(so // 2, ext + max(max(dp_offs), -min(dp_offs)))

    def param(name, pad):
        return edge_pad(model[name].to(dtype), nbl + pad)

    vp = param('vp', 0)
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
    c_rhs = (dt * dt) / den
    c_cur = (2.0 * m + a) / den
    c_prev = -m / den
    del a, den
    eps2 = 1.0 + 2.0 * param('epsilon', 0)
    delta2 = torch.sqrt(1.0 + 2.0 * param('delta', 0))
    theta, phi = param('theta', ext), param('phi', ext)
    # the symmetry axis on the grid widened by ``ext``: Gzz's outer
    # derivative reads n_d there
    normal = [torch.sin(theta) * torch.cos(phi),
              torch.sin(theta) * torch.sin(phi), torch.cos(theta)]
    del theta, phi
    eshape = tuple(n + 2 * ext for n in shape)

    u = [torch.zeros(tuple(n + 2 * R for n in shape), dtype=dtype,
                     device=dev) for _ in range(3)]
    v = [torch.zeros_like(u[0]) for _ in range(3)]

    src_pos = torch.as_tensor(shot['src'], dtype=dtype, device=dev)
    rec_pos = torch.as_tensor(shot['rec'], dtype=dtype, device=dev)
    s_idx, s_w = linear_corners(src_pos, origin, h, shape)
    r_idx, r_w = linear_corners(rec_pos, origin, h, shape)
    s_scale = s_w * (dt * dt) / m[tuple(s_idx)]
    s_idx = tuple(i + R for i in s_idx)
    r_idx = tuple(i + R for i in r_idx)
    wavelet = torch.as_tensor(shot['wavelet'], dtype=dtype, device=dev)
    rec = torch.zeros((nt, rec_pos.shape[0]), dtype=dtype, device=dev)

    lap_offs, lap_w = second_derivative(so)
    rl = so // 2
    centre = sum(float(lap_w[rl]) / (s * s) for s in h)
    deriv = torch.empty(eshape, dtype=dtype, device=dev)
    grad = torch.empty(eshape, dtype=dtype, device=dev)
    prod = torch.empty(eshape, dtype=dtype, device=dev)
    gzz_u = torch.empty(shape, dtype=dtype, device=dev)
    gzz_v = torch.empty(shape, dtype=dtype, device=dev)
    lap = torch.empty(shape, dtype=dtype, device=dev)
    pair = torch.empty(shape, dtype=dtype, device=dev)

    def gzz(f, out):
        """Gzz(f) over the grid, into ``out``."""
        grad.zero_()
        for e in range(3):
            torch.mul(_window(f, R - ext, eshape, e, dp_offs[0]),
                      float(dp_w[0]) / h[e], out=deriv)
            for k, wk in zip(dp_offs[1:], dp_w[1:]):
                deriv.add_(_window(f, R - ext, eshape, e, k),
                           alpha=float(wk) / h[e])
            grad.addcmul_(normal[e], deriv)
        out.zero_()
        for d in range(3):
            torch.mul(normal[d], grad, out=prod)
            for k, wk in zip(dm_offs, dm_w):
                out.add_(_window(prod, ext, shape, d, k),
                         alpha=float(wk) / h[d])

    def laplace(f, out):
        torch.mul(_window(f, R, shape), centre, out=out)
        for axis in range(3):
            for k in range(1, rl + 1):
                torch.add(_window(f, R, shape, axis, k),
                          _window(f, R, shape, axis, -k), out=pair)
                out.add_(pair, alpha=float(lap_w[rl + k]) / (h[axis] ** 2))

    for t in range(1, nt - 1):
        ucur, uprev, unext = u[t % 3], u[(t - 1) % 3], u[(t + 1) % 3]
        vcur, vprev, vnext = v[t % 3], v[(t - 1) % 3], v[(t + 1) % 3]
        rec[t] = (r_w * (ucur[r_idx] + vcur[r_idx])).sum(0)
        gzz(ucur, gzz_u)
        gzz(vcur, gzz_v)
        laplace(ucur, lap)
        lap.sub_(gzz_u)                 # Gh(u)
        # the next levels overwrite the oldest rows, t - 2
        un, vn = _window(unext, R, shape), _window(vnext, R, shape)
        torch.mul(_window(uprev, R, shape), c_prev, out=un)
        un.addcmul_(_window(ucur, R, shape), c_cur)
        torch.mul(eps2, lap, out=pair)
        pair.addcmul_(delta2, gzz_v)
        un.addcmul_(pair, c_rhs)
        torch.mul(_window(vprev, R, shape), c_prev, out=vn)
        vn.addcmul_(_window(vcur, R, shape), c_cur)
        torch.mul(delta2, lap, out=pair)
        pair.add_(gzz_v)
        vn.addcmul_(pair, c_rhs)
        q = s_scale * wavelet[t]
        unext.index_put_(s_idx, q, accumulate=True)
        vnext.index_put_(s_idx, q, accumulate=True)
    last = (nt - 1) % 3
    return rec, {'u': _window(u[last], R, shape),
                 'v': _window(v[last], R, shape)}
