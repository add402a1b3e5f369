"""Probe 1: the (x, y)-tiled acoustic SO=8 step with both halo'd windows
staged (K3).

Ports ``experiments/stencil_probe.py``. up and uc are (N+8)^3 (halo 4), m
and damp (N, N, N). One step computes ``2 uc - up + m lap(uc) - damp uc``
over the interior, (N, N, N); the loop writes it into up's interior and
the pair rotates, (up, uc) -> (uc, up), as the JAX script's ``fori_loop``
does.

- A: the JAX script's raw-XLA loop, a plain torch loop here (``run_xla``);
- C: the loop through K3 (``run_pallas``, ``csrc/probe_halo_stream.cu``:
  a point of K1's streaming engine, uc staged, up, m and damp read at the
  point), which stores into up's interior in place.

    python -m devito_tpu_torch.experiments.stencil_probe [N] [STEPS] [TX] [TY] [--device cuda|cpu]

prints A's and C's milliseconds and GPts/s over STEPS steps, C's error
against A after 3 steps, and K3's against its plain version (one step and
3 steps of the loop, over the whole array); any error beyond 1e-5
max|plain| raises.
"""

import argparse

import numpy as np
import torch

from . import _stream, device_for
from ._tiled import H, apart, check, close, lap_interior, run_interior, \
    timed_run
from ._tiled import FLOPS as _TILED_FLOPS

__all__ = ['halo_tiles_step', 'halo_tiles_kernel',
           'halo_tiles_step_reference', 'run_xla',
           'run_pallas', 'inputs', 'main', 'FLOPS']

#: K3 kernel launches.
launches = 0
#: fp32 operations per point: those of 2 uc - up + m lap(uc), and the 2 of
#: ``- damp uc``.
FLOPS = _TILED_FLOPS + 2


def _check(up, uc, m, damp, out):
    check('halo-tiles step', (up, uc, m, damp), (out,))
    n = up.shape[0] - 2 * H
    if n < 1 or tuple(up.shape) != (n + 2 * H,) * 3 \
            or uc.shape != up.shape or any(
                tuple(t.shape) != (n, n, n) for t in (m, damp)):
        raise ValueError(f"shapes {[tuple(t.shape) for t in (up, uc, m, damp)]}"
                         f": expected up, uc (N+8)^3 and m, damp (N, N, N)")
    if out is not None and tuple(out.shape) != (n, n, n):
        raise ValueError(f"out {tuple(out.shape)}: expected ({n}, {n}, {n})")
    apart('halo-tiles step', out, uc)
    return n


def halo_tiles_step(up, uc, m, damp, TX=32, TY=32, out=None):
    """One K3 step: the (N, N, N) interior update, written into ``out``
    (a new tensor, or any box of a contiguous allocation, such as up's
    interior: ``_stream.allocation``) and returned. TX and TY, positive,
    were the TPU kernel's (x, y) tile; the result does not depend on them,
    and on the card the tile is the streaming engine's (``_stream.TILE``).
    CUDA tensors go through the kernel (``halo_tiles_kernel``); CPU tensors
    through ``halo_tiles_step_reference``."""
    n = _check(up, uc, m, damp, out)
    if TX < 1 or TY < 1:
        raise ValueError(f"tile ({TX}, {TY}): expected positive sizes")
    if up.device.type == 'cpu':
        return halo_tiles_step_reference(up, uc, m, damp, out)
    if out is None:
        out = torch.empty((n, n, n), dtype=torch.float32, device=up.device)
    return halo_tiles_kernel(up, uc, m, damp, out, _stream.X_CHUNK)


def halo_tiles_kernel(up, uc, m, damp, out, x_chunk):
    """K3's launch on CUDA tensors that ``halo_tiles_step`` has checked,
    each CTA walking ``x_chunk`` x-planes (``halo_tiles_step`` passes
    ``_stream.X_CHUNK``; chip_smoke.py sweeps it): uc is the engine's
    staged group at (4, 4, 4), up (at (4, 4, 4)), m and damp (at 0) its
    centre groups. Returns ``out``."""
    global launches
    n = m.shape[0]
    _stream.launch('halo-tiles step', 'probe_halo_stream',
                   _rows(up, uc, m, damp, out), (n, n, n), x_chunk, up.device)
    launches += 1
    return out


def _rows(up, uc, m, damp, out):
    """K3's rows for the engine (``_stream.rows``): ``out`` at its first
    element, uc staged and up at (4, 4, 4), m and damp at 0."""
    return _stream.rows('halo-tiles step', (out, (0, 0, 0)),
                        [(uc, (H, H, H))],
                        [(up, (H, H, H)), (m, (0, 0, 0)), (damp, (0, 0, 0))])


def halo_tiles_step_reference(up, uc, m, damp, out=None):
    """The plain PyTorch version of ``halo_tiles_step``: the JAX kernel's
    arithmetic (``stencil_probe.py:88-101``) over the whole interior."""
    c = slice(H, -H)
    ucc = uc[c, c, c]
    val = 2.0 * ucc - up[c, c, c] + m * lap_interior(uc) - damp * ucc
    if out is None:
        return val
    return out.copy_(val)


def run_xla(u0, u1, m, damp, nsteps):
    """Variant A, the JAX script's ``run_xla``: ``run_interior`` with
    damping."""
    return run_interior(u0, u1, m, nsteps, damp)


def run_pallas(u0, u1, m, damp, nsteps, TX=32, TY=32, plain=False):
    """Variant C, the JAX script's ``run_pallas``: as ``run_xla`` through
    K3, which stores into up's interior in place (``plain``: through its
    plain version)."""
    up, uc = u0, u1
    c = slice(H, -H)
    for _ in range(nsteps):
        if plain:
            halo_tiles_step_reference(up, uc, m, damp, out=up[c, c, c])
        else:
            halo_tiles_step(up, uc, m, damp, TX, TY, out=up[c, c, c])
        up, uc = uc, up
    return up, uc


def inputs(N, device, seed=0):
    """The JAX script's inputs: u0 normal * 1e-3 over the whole (N+8)^3
    array (numpy's generator ``seed``), u1 zero, m 0.2, damp zero."""
    NP = N + 2 * H
    u0 = np.random.default_rng(seed).standard_normal((NP,) * 3) * 1e-3
    return (torch.from_numpy(u0.astype(np.float32)).to(device),
            torch.zeros((NP,) * 3, device=device),
            torch.full((N,) * 3, 0.2, device=device),
            torch.zeros((N,) * 3, device=device))


def main(N=256, STEPS=64, TX=32, TY=32, device='cuda'):
    """Time A and C over ``STEPS`` steps, then check C against A and K3
    against its plain version; returns the numbers it prints."""
    dev = device_for(device)
    u0, u1, m, damp = inputs(N, dev)

    def fresh():
        return u0.clone(), u1.clone()

    a, c = fresh(), fresh()
    ms_a = timed_run('A torch-slices', lambda: run_xla(*a, m, damp, STEPS),
                     N, STEPS, dev)
    ms_c = timed_run(f'C kernel TX={TX} TY={TY}', lambda: run_pallas(
        *c, m, damp, STEPS, TX, TY), N, STEPS, dev)
    c3 = run_pallas(*fresh(), m, damp, 3, TX, TY)[1]
    err, tol = close('C against A after 3 steps', c3,
                     run_xla(*fresh(), m, damp, 3)[1])
    print(f"max |A - C| after 3 steps: {err} (tolerance {tol:.3e})")
    errs = [close('K3 against its plain version, 1 step',
                  run_pallas(*fresh(), m, damp, 1, TX, TY)[1],
                  run_pallas(*fresh(), m, damp, 1, plain=True)[1])[0],
            close('K3 against its plain version, 3 steps', c3,
                  run_pallas(*fresh(), m, damp, 3, plain=True)[1])[0]]
    print(f"max |kernel - plain| over the whole array after 1 and 3 steps: "
          f"{errs[0]}, {errs[1]}")
    return {'ms_a': ms_a, 'ms_c': ms_c, 'err_a': err, 'tol': tol,
            'err': max(errs)}


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('N', type=int, nargs='?', default=256)
    ap.add_argument('STEPS', type=int, nargs='?', default=64)
    ap.add_argument('TX', type=int, nargs='?', default=32)
    ap.add_argument('TY', type=int, nargs='?', default=32)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    a = ap.parse_args()
    main(a.N, a.STEPS, a.TX, a.TY, a.device)
