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
- E: the loop through K6 (``run_E``, ``csrc/probe_tiles_stream.cu``): a
  point of K1's streaming engine (uc staged, up and m read at the point),
  writing into up_i in place, and a kernel that zeroes the z halo and pad
  of the columns (``_tiled.stream_step``).

    python -m devito_tpu_torch.experiments.stencil_probe4 [N] [STEPS] [TX] [TY] [--device cuda|cpu]

prints A's and E's milliseconds and GPts/s over STEPS steps, E's error
against A after 3 steps, and K6's against its plain version (one step and
3 steps, whole array); any error beyond 1e-5 max|plain| raises. TX and TY
need not divide N (the JAX kernel's grid of N // TX by N // TY tiles
leaves the rest of the columns unwritten; the port computes them); on the
card the tile is the engine's (``_tiled.STREAM_TILE``).
"""

import argparse

import numpy as np
import torch

from . import _stream, device_for
from ._tiled import FLOPS, H, STREAM_TILE, apart, check, close, \
    frame, lap_interior, run_interior, stream_step, timed_run

__all__ = ['tiles_step', 'tiles_kernel', 'tiles_step_reference', 'run_A',
           'run_E', 'inputs', 'main', 'FLOPS']

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
    be up_i, or any box of a contiguous allocation) or a new tensor, and
    returned. TX and TY, positive, were the TPU kernel's (x, y) tile; the
    result does not depend on them, and on the card the tile is the
    streaming engine's. CUDA tensors go through the kernel
    (``tiles_kernel``); CPU tensors through ``tiles_step_reference``."""
    n = _check(uc, up_i, m_i, out)
    if TX < 1 or TY < 1:
        raise ValueError(f"tile ({TX}, {TY}): expected positive sizes")
    if uc.device.type == 'cpu':
        return tiles_step_reference(uc, up_i, m_i, out)
    if out is None:
        out = torch.empty(m_i.shape, dtype=torch.float32, device=uc.device)
    return tiles_kernel(uc, up_i, m_i, out, _stream.X_CHUNK)


def tiles_kernel(uc, up_i, m_i, out, x_chunk, tile=STREAM_TILE,
                 zeros=True):
    """K6's launch on CUDA tensors that ``tiles_step`` has checked, each
    CTA walking ``x_chunk`` x-planes on the engine compiled for ``tile``
    (``tiles_step`` passes ``_stream.X_CHUNK`` and
    ``_tiled.STREAM_TILE``; chip_smoke.py sweeps both), with the frame
    kernel's zeros first unless ``zeros`` is False (``_tiled.stream_step``).
    Returns ``out``."""
    global launches
    n = m_i.shape[0]
    stream_step('tiles step', _rows(uc, up_i, m_i, out), (n, n, n),
                _frame(out), x_chunk, tile, uc.device, zeros)
    launches += 1
    return out


def _rows(uc, up_i, m_i, out):
    """K6's rows for the engine (``_stream.rows``): out at (0, 0, 4) of its
    view, uc staged at (4, 4, 4), up_i's allocation at up_i's first
    element + (0, 0, 4) (up's at (4, 4, 4) for the loop's interior
    columns), m_i's likewise (at (0, 0, 4) for a tensor of its own)."""
    centre = [(t, (x, y, z + H)) for t, (x, y, z) in map(_stream.whole,
                                                          (up_i, m_i))]
    return _stream.rows('tiles step', (out, (0, 0, H)), [(uc, (H, H, H))],
                        centre)


def _frame(out):
    """K6's frame (``_tiled.frame``): out's (N, N, ZA) columns less the
    lanes [4, 4+N)."""
    n, _, za = out.shape
    return frame(out, ((0, 0, 0), (n, n, za)), ((0, 0, H), (n, n, n)))


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
