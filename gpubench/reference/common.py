"""Pieces both plain references share, worked out from the inputs alone.

Finite-difference weights (Fornberg's recursion), the absorbing layer's
damping profile, the Ricker wavelet, the time axis, the critical time
step, edge padding of a parameter field, and the linear interpolation
weights of a point. Plain NumPy and PyTorch: nothing here imports the
program under test.
"""

import math

import numpy as np
import torch

__all__ = ['fd_weights', 'second_derivative', 'half_point_first_derivative',
           'critical_dt', 'time_axis', 'ricker', 'damping_profile',
           'edge_pad', 'linear_corners', 'no_tf32']


def fd_weights(order, points, x0=0.0):
    """Weights of the ``order``-th derivative at ``x0`` from samples at
    ``points`` (grid units), by Fornberg's recursion (Math. Comp. 51,
    1988), in float64."""
    n = len(points)
    c = np.zeros((n, order + 1))
    c1, c4 = 1.0, points[0] - x0
    c[0, 0] = 1.0
    for i in range(1, n):
        mn = min(i, order)
        c2, c5, c4 = 1.0, c4, points[i] - x0
        for j in range(i):
            c3 = points[i] - points[j]
            c2 *= c3
            if j == i - 1:
                for k in range(mn, 0, -1):
                    c[i, k] = c1 * (k * c[i - 1, k - 1] - c5 * c[i - 1, k]) / c2
                c[i, 0] = -c1 * c5 * c[i - 1, 0] / c2
            for k in range(mn, 0, -1):
                c[j, k] = (c4 * c[j, k] - k * c[j, k - 1]) / c3
            c[j, 0] = c4 * c[j, 0] / c3
        c1 = c2
    return c[:, order]


def second_derivative(space_order):
    """(offsets, weights) of the centred second derivative of accuracy
    ``space_order``: the points -so/2 .. so/2."""
    r = space_order // 2
    offs = list(range(-r, r + 1))
    return offs, fd_weights(2, [float(o) for o in offs])


def half_point_first_derivative(fd_order, side):
    """(offsets, weights) of the first derivative of accuracy ``fd_order``
    taken at the half point ``x + side/2`` (side +1 or -1) from the
    ``fd_order`` grid points around it. Offsets are whole grid steps from
    ``x``."""
    h = fd_order // 2
    offs = list(range(-h + 1, h + 1)) if side > 0 else list(range(-h, h))
    return offs, fd_weights(1, [o - side / 2 for o in offs])


def critical_dt(space_order, spacing, vp_max, thomsen_scale=1.0):
    """The time step of the model's CFL bound, rounded to four significant
    digits as the solver rounds it: ``sqrt(4 / (ndim * sum|w|)) *
    min(h) / (scale * vp_max)`` with ``w`` the second-derivative weights
    on the 2 so + 1 points -so .. so, as the solver of the program under
    test states it."""
    offs = [float(o) for o in range(-space_order, space_order + 1)]
    coeff = math.sqrt(4 / (len(spacing) * np.abs(fd_weights(2, offs)).sum()))
    dt = coeff * min(spacing) / (thomsen_scale * vp_max)
    return float(np.float32(f"{dt:.3e}"))


def time_axis(t0, tn, dt):
    """(number of samples, their times in ms) of a shot from ``t0`` to
    ``tn`` at step ``dt``: the last sample at or past ``tn``."""
    nt = int(np.ceil((tn - t0 + dt) / dt))
    return nt, np.linspace(t0, dt * (nt - 1) + t0, nt)


def ricker(times, f0, a=1.0):
    """The Ricker wavelet ``a (1 - 2 r^2) exp(-r^2)``, ``r = pi f0 (t -
    1/f0)``, at ``times`` (ms; f0 in kHz)."""
    r = np.pi * f0 * (times - 1.0 / f0)
    return a * (1 - 2. * r ** 2) * np.exp(-r ** 2)


def damping_profile(shape, nbl, spacing, dtype=np.float64):
    """The absorbing layer's damping field on the padded grid ``shape``:
    zero inside, and in the ``nbl`` points of each side the ramp
    ``1.5 ln(1000) / nbl * (p - sin(2 pi p) / (2 pi)) / h`` with ``p =
    (nbl - i + 1) / nbl`` at the i-th point from the outer edge."""
    damp = np.zeros(shape, dtype=dtype)
    if nbl == 0:
        return damp
    i = np.arange(nbl)
    pos = np.abs((nbl - i + 1) / float(nbl))
    val = 1.5 * np.log(1.0 / 0.001) / nbl * (pos - np.sin(2 * np.pi * pos)
                                             / (2 * np.pi))
    for j, h in enumerate(spacing):
        view = [1] * len(shape)
        view[j] = nbl
        left = [slice(None)] * len(shape)
        left[j] = slice(0, nbl)
        right = [slice(None)] * len(shape)
        right[j] = slice(shape[j] - nbl, shape[j])
        damp[tuple(left)] += (val / h).reshape(view)
        damp[tuple(right)] += (val[::-1] / h).reshape(view)
    return damp


def edge_pad(field, pad):
    """``field`` (a 3-D tensor) with ``pad`` points on every side, each
    copying the nearest edge value."""
    return torch.nn.functional.pad(field[None, None], (pad,) * 6,
                                   mode='replicate')[0, 0]


def linear_corners(positions, origin, spacing, shape):
    """The trilinear stencil of each point: (corner indices, a (C, P) long
    tensor per axis, clipped to the grid, and the (C, P) weights, zero
    for a point outside the grid). ``positions`` is (P, ndim) in metres,
    a tensor in the dtype the stencil is computed in."""
    per_axis = []
    valid = None
    for j in range(positions.shape[1]):
        px = (positions[:, j] - origin[j]) / spacing[j]
        fl = torch.floor(px)
        frac = px - fl
        inside = (px >= 0) & (px <= shape[j] - 1)
        valid = inside if valid is None else valid & inside
        per_axis.append((fl.long(), (1.0 - frac, frac)))
    idx = [[] for _ in per_axis]
    weights = []
    for corner in range(2 ** len(per_axis)):
        w = None
        for j, (base, ws) in enumerate(per_axis):
            bit = (corner >> (len(per_axis) - 1 - j)) & 1
            idx[j].append(torch.clamp(base + bit, 0, shape[j] - 1))
            w = ws[bit] if w is None else w * ws[bit]
        weights.append(w)
    W = torch.stack(weights) * valid.to(weights[0].dtype)
    return [torch.stack(i) for i in idx], W


def no_tf32():
    """Keep float32 products in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
