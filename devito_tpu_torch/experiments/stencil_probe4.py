"""Probe 4: the (x, y)-tiled acoustic SO=8 step with a double-buffered
window (K6).

Ports ``experiments/stencil_probe4.py``. The fields are (NP, NP, ZA) with
NP = N + 8 (halo 4) and ZA = NP rounded up to 128; m_i is (N, N, ZA), m in
the lanes [4, 4+N). One step takes uc, the interior columns of up,
``up_i = up[4:4+N, 4:4+N, :]``, and m_i, and gives the (N, N, ZA) columns
``2 uc - up + m lap(uc)`` on the lanes [4, 4+N), zero on the z halo and
pad; the loop writes them into up_i (the kernel does so in place) and the
pair rotates. up's x/y halo keeps its values.

- A: the interior update written into up (``run_A``, torch-DUS);
- E: the loop through K6 (``run_E``, ``csrc/probe4_tiles.cu``), whose
  CTAs each own a (TX, TY) tile of columns and stream z through it,
  double-buffering the halo'd window of uc.

    python -m devito_tpu_torch.experiments.stencil_probe4 [N] [STEPS] [TX] [TY] [--device cuda|cpu]

prints A's and E's milliseconds and GPts/s over STEPS steps, E's error
against A after 3 steps, and K6's against its plain version (one step and
3 steps, whole array); any error beyond 1e-5 max|plain| raises. TX and TY
need not divide N (the JAX kernel's grid of N // TX by N // TY tiles
leaves the rest of the columns unwritten; the port computes them).
"""

import argparse
import ctypes

import numpy as np
import torch

from . import device_for
from ._tiled import FLOPS, H, aligned, apart, check, close, \
    lap_interior, run_interior, stream, timed_run, z_chunk
from ..kernels import _nvcc

__all__ = ['tiles_step', 'tiles_step_reference', 'run_A', 'run_E', 'inputs',
           'main', 'FLOPS']

#: K6 kernel launches.
launches = 0

#: Variant A, the JAX script's ``run_A``.
run_A = run_interior


def _check(uc, up_i, m_i, out):
    check('tiles step', (uc,), (up_i, m_i, out))
    NP, ZA = uc.shape[0], uc.shape[2]
    n = NP - 2 * H
    if n < 1 or tuple(uc.shape) != (NP, NP, ZA) or ZA < NP or any(
            t is not None and tuple(t.shape) != (n, n, ZA)
            for t in (up_i, m_i, out)):
        raise ValueError(f"shapes {[tuple(t.shape) for t in (uc, up_i, m_i)]}"
                         f": expected uc (N+8, N+8, ZA) with ZA >= N+8 and "
                         f"up_i, m_i (N, N, ZA)")
    apart('tiles step', out, uc)
    return n


def tiles_step(uc, up_i, m_i, TX=16, TY=32, out=None):
    """One K6 step: the (N, N, ZA) columns, written into ``out`` (which may
    be up_i, or another view contiguous along z) or a new tensor, and
    returned. Each CTA owns a (TX, TY) tile of columns; TX and TY need not
    divide N. CUDA tensors go through the kernel; CPU tensors through
    ``tiles_step_reference``."""
    global launches
    n = _check(uc, up_i, m_i, out)
    if TX < 1 or TY < 1:
        raise ValueError(f"tile ({TX}, {TY}): expected positive sizes")
    if uc.device.type == 'cpu':
        return tiles_step_reference(uc, up_i, m_i, out)
    ZA = uc.shape[2]
    aligned('tiles step', uc)
    if ZA % 4:
        raise ValueError(f"the tiles kernel needs ZA % 4 == 0 (ZA={ZA})")
    zc = z_chunk('tiles step', TX, TY, 2)
    if out is None:
        out = torch.empty((n, n, ZA), dtype=torch.float32, device=uc.device)
    fn = _nvcc.entry('probe4_tiles', 'dtpu_tiles_launch',
                     [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(uc.device):
        rc = fn(uc.data_ptr(), up_i.data_ptr(), m_i.data_ptr(),
                out.data_ptr(), *up_i.stride()[:2], *m_i.stride()[:2],
                *out.stride()[:2], n, ZA, TX, TY, zc, stream(uc.device))
    _nvcc.check_launch(rc, "tiles kernel")
    launches += 1
    return out


def tiles_step_reference(uc, up_i, m_i, out=None):
    """The plain PyTorch version of ``tiles_step``: the JAX kernel's
    arithmetic (``stencil_probe4.py:96-114``) over every column."""
    n = uc.shape[0] - 2 * H
    c = slice(H, H + n)
    val = 2.0 * uc[c, c, c] - up_i[:, :, c] + m_i[:, :, c] * lap_interior(uc)
    if out is None:
        out = torch.zeros_like(m_i, memory_format=torch.contiguous_format)
    else:
        out[:, :, :H] = 0.0
        out[:, :, H + n:] = 0.0
    out[:, :, c] = val
    return out


def run_E(u0, u1, m_i, nsteps, TX=16, TY=32, plain=False):
    """Variant E, the JAX script's ``run_E``: ``nsteps`` K6 steps
    (``plain``: its plain version), each writing up's interior columns in
    place; returns the last pair. u0 and u1 are updated in place."""
    up, uc = u0, u1
    n = u0.shape[0] - 2 * H
    c = slice(H, H + n)
    for _ in range(nsteps):
        up_i = up[c, c, :]
        if plain:
            tiles_step_reference(uc, up_i, m_i, out=up_i)
        else:
            tiles_step(uc, up_i, m_i, TX, TY, out=up_i)
        up, uc = uc, up
    return up, uc


def inputs(N, device, seed=0):
    """The JAX script's inputs: u0 normal * 1e-3 in the interior and zero
    elsewhere (numpy's generator ``seed``), u1 zero, m 0.2 (N, N, N), and
    m_i, m in the lanes [4, 4+N) of (N, N, ZA) and zero elsewhere."""
    NP = N + 2 * H
    ZA = -(-NP // 128) * 128
    u0 = np.zeros((NP, NP, ZA), np.float32)
    u0[H:H + N, H:H + N, H:H + N] = \
        np.random.default_rng(seed).standard_normal((N,) * 3) * 1e-3
    m_i = torch.zeros((N, N, ZA), device=device)
    m_i[:, :, H:H + N] = 0.2
    return (torch.from_numpy(u0).to(device),
            torch.zeros((NP, NP, ZA), device=device),
            torch.full((N,) * 3, 0.2, device=device), m_i)


def main(N=240, STEPS=64, TX=16, TY=32, device='cuda'):
    """Time A and E over ``STEPS`` steps, then check E against A and K6
    against its plain version; returns the numbers it prints."""
    dev = device_for(device)
    u0, u1, m, m_i = inputs(N, dev)

    def fresh():
        return u0.clone(), u1.clone()

    a, e = fresh(), fresh()
    res = {
        'ms_a': timed_run('A torch-DUS', lambda: run_A(*a, m, STEPS), N,
                          STEPS, dev),
        'ms_e': timed_run(f'E v3 TX={TX} TY={TY}', lambda: run_E(
            *e, m_i, STEPS, TX, TY), N, STEPS, dev)}
    e3 = run_E(*fresh(), m_i, 3, TX, TY)[1]
    res['err_a'], res['tol'] = close('E against A after 3 steps', e3,
                                     run_A(*fresh(), m, 3)[1])
    print(f"E vs A err: {res['err_a']} (tolerance {res['tol']:.3e})")
    errs = [close('K6 against its plain version, 1 step',
                  run_E(*fresh(), m_i, 1, TX, TY)[1],
                  run_E(*fresh(), m_i, 1, plain=True)[1])[0],
            close('K6 against its plain version, 3 steps', e3,
                  run_E(*fresh(), m_i, 3, plain=True)[1])[0]]
    print(f"max |kernel - plain| over the whole array after 1 and 3 steps: "
          f"{errs[0]}, {errs[1]}")
    res['err'] = max(errs)
    return res


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('N', type=int, nargs='?', default=240)
    ap.add_argument('STEPS', type=int, nargs='?', default=64)
    ap.add_argument('TX', type=int, nargs='?', default=16)
    ap.add_argument('TY', type=int, nargs='?', default=32)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    a = ap.parse_args()
    main(a.N, a.STEPS, a.TX, a.TY, a.device)
