"""Probe 5: the x-tiled acoustic SO=8 step over a layout with an extra x
ring, written whole (K7).

Ports ``experiments/stencil_probe5.py``. Arrays are (XP, NP, ZA): NP =
N + 8 (halo 4), XP = N + 16 (a ring of 4 more rows in x, so that the TPU
kernel's windows never clamp), ZA = NP rounded up to 128; the interior is
[8, 8+N) x [4, 4+N) x [4, 4+N). One step returns a fresh array: ``2 uc -
up + m_pad lap(uc)`` on the interior and zero everywhere else. TX must
divide XP.

The JAX kernel computes wrong values on the interior rows of its first
and last x-tiles when TX > 8 (``stencil_probe5.py:108`` shifts their x
taps and the last tile's slice is clamped); it is right for TX <= 8. The
port computes the intended update, variant A's, for every TX.

- A: the interior update written into up (``run_A``, torch-DUS);
- E: the loop through K7 (``run_E``, ``csrc/probe_tiles_stream.cu``: a
  point of K1's streaming engine, uc staged, up and m_pad read at the
  point, and a kernel that zeroes everything outside the interior,
  ``_tiled.stream_step``), rotating three buffers.

    python -m devito_tpu_torch.experiments.stencil_probe5 [N] [STEPS] [TX] [--device cuda|cpu]

prints A's and E's milliseconds and GPts/s over STEPS steps, E's error
against A after 3 steps, and K7's against its plain version (one step and
3 steps, whole array); any error beyond 1e-5 max|plain| raises.
"""

import argparse

import numpy as np
import torch

from . import _stream, device_for
from ._tiled import FLOPS, H, STREAM_TILE, apart, check, close, \
    frame, lap_interior, run_interior, stream_step, timed_run

__all__ = ['xtiles_step', 'xtiles_kernel', 'xtiles_step_reference', 'run_A',
           'run_E', 'inputs', 'main', 'FLOPS']

X0 = 2 * H   # first interior x row

#: K7 kernel launches.
launches = 0


def _check(uc, up, m_pad, TX, out):
    check('x-tiles step', (uc, up, m_pad) + (() if out is None else (out,)))
    NP, ZA = uc.shape[1], uc.shape[2]
    n = NP - 2 * H
    if n < 1 or tuple(uc.shape) != (n + 4 * H, NP, ZA) or ZA < NP or any(
            t.shape != uc.shape for t in (up, m_pad)
            + (() if out is None else (out,))):
        raise ValueError(f"shapes {[tuple(t.shape) for t in (uc, up, m_pad)]}"
                         f": expected (N+16, N+8, ZA) with ZA >= N+8")
    if TX < 1 or uc.shape[0] % TX:
        raise ValueError(f"TX={TX} does not divide XP={uc.shape[0]}")
    apart('x-tiles step', out, uc)
    return n


def xtiles_step(uc, up, m_pad, TX=32, out=None):
    """One K7 step: the fresh (XP, NP, ZA) array, the interior update and
    zero everywhere else, written into ``out`` (not uc) or a new array, and
    returned. TX, which must divide XP, was the TPU kernel's x-tile; the
    result does not depend on it, and on the card the tile is the
    streaming engine's. CUDA tensors go through the kernel
    (``xtiles_kernel``); CPU tensors through ``xtiles_step_reference``."""
    _check(uc, up, m_pad, TX, out)
    if uc.device.type == 'cpu':
        return xtiles_step_reference(uc, up, m_pad, out)
    if out is None:
        out = torch.empty_like(uc)
    return xtiles_kernel(uc, up, m_pad, out, _stream.X_CHUNK)


def xtiles_kernel(uc, up, m_pad, out, x_chunk, tile=STREAM_TILE,
                  zeros=True):
    """K7's launch on CUDA tensors that ``xtiles_step`` has checked, each
    CTA walking ``x_chunk`` x-planes on the engine compiled for ``tile``
    (``xtiles_step`` passes ``_stream.X_CHUNK`` and
    ``_tiled.STREAM_TILE``; chip_smoke.py sweeps both), with the frame
    kernel's zeros first unless ``zeros`` is False (``_tiled.stream_step``).
    Returns ``out``."""
    global launches
    n = uc.shape[1] - 2 * H
    stream_step('x-tiles step', _rows(uc, up, m_pad, out), (n, n, n),
                _frame(out), x_chunk, tile, uc.device, zeros)
    launches += 1
    return out


def _rows(uc, up, m_pad, out):
    """K7's rows for the engine (``_stream.rows``): out, uc staged, up and
    m_pad, each at the interior's first point (8, 4, 4)."""
    org = (X0, H, H)
    return _stream.rows('x-tiles step', (out, org), [(uc, org)],
                        [(up, org), (m_pad, org)])


def _frame(out):
    """K7's frame (``_tiled.frame``): the whole (XP, NP, ZA) array less the
    interior [8, 8+N) x [4, 4+N) x [4, 4+N)."""
    n = out.shape[1] - 2 * H
    return frame(out, ((0, 0, 0), tuple(out.shape)), ((X0, H, H), (n, n, n)))


def xtiles_step_reference(uc, up, m_pad, out=None):
    """The plain PyTorch version of ``xtiles_step``: the update the JAX
    kernel (``stencil_probe5.py:105-125``) means, right for every TX."""
    n = uc.shape[1] - 2 * H
    x, c = slice(X0, X0 + n), slice(H, H + n)
    val = 2.0 * uc[x, c, c] - up[x, c, c] \
        + m_pad[x, c, c] * lap_interior(uc, X0)
    out = torch.zeros_like(uc) if out is None else out.zero_()
    out[x, c, c] = val
    return out


def run_A(u0, u1, m, nsteps):
    """Variant A, the JAX script's ``run_A``: ``run_interior`` over the
    interior that starts at x row 8."""
    return run_interior(u0, u1, m, nsteps, x0=X0)


def run_E(u0, u1, m_pad, nsteps, TX=32, plain=False):
    """Variant E, the JAX script's ``run_E``: ``nsteps`` K7 steps
    (``plain``: its plain version), each into the spare of three rotating
    buffers; returns the last pair. u0 and u1 are overwritten."""
    up, uc, spare = u0, u1, torch.empty_like(u0)
    for _ in range(nsteps):
        if plain:
            un = xtiles_step_reference(uc, up, m_pad, out=spare)
        else:
            un = xtiles_step(uc, up, m_pad, TX, out=spare)
        up, uc, spare = uc, un, up
    return up, uc


def inputs(N, device, seed=0):
    """The JAX script's inputs: u0 normal * 1e-3 in the interior and zero
    elsewhere (numpy's generator ``seed``), u1 zero, m 0.2 (N, N, N), and
    m_pad, m in the interior of (XP, NP, ZA) and zero elsewhere."""
    NP = N + 2 * H
    shape = (N + 4 * H, NP, -(-NP // 128) * 128)
    inner = (slice(X0, X0 + N), slice(H, H + N), slice(H, H + N))
    u0 = np.zeros(shape, np.float32)
    u0[inner] = np.random.default_rng(seed).standard_normal((N,) * 3) * 1e-3
    m_pad = torch.zeros(shape, device=device)
    m_pad[inner] = 0.2
    return (torch.from_numpy(u0).to(device), torch.zeros(shape, device=device),
            torch.full((N,) * 3, 0.2, device=device), m_pad)


def main(N=240, STEPS=64, TX=32, device='cuda'):
    """Time A and E over ``STEPS`` steps, then check E against A and K7
    against its plain version; returns the numbers it prints."""
    dev = device_for(device)
    u0, u1, m, m_pad = inputs(N, dev)

    def fresh():
        return u0.clone(), u1.clone()

    a, e = fresh(), fresh()
    res = {
        'ms_a': timed_run('A torch-DUS', lambda: run_A(*a, m, STEPS), N,
                          STEPS, dev),
        'ms_e': timed_run(f'E v4 TX={TX}', lambda: run_E(
            *e, m_pad, STEPS, TX), N, STEPS, dev)}
    e3 = run_E(*fresh(), m_pad, 3, TX)[1]
    res['err_a'], res['tol'] = close('E against A after 3 steps', e3,
                                     run_A(*fresh(), m, 3)[1])
    print(f"E vs A err: {res['err_a']} (tolerance {res['tol']:.3e})")
    errs = [close('K7 against its plain version, 1 step',
                  run_E(*fresh(), m_pad, 1, TX)[1],
                  run_E(*fresh(), m_pad, 1, plain=True)[1])[0],
            close('K7 against its plain version, 3 steps', e3,
                  run_E(*fresh(), m_pad, 3, plain=True)[1])[0]]
    print(f"max |kernel - plain| over the whole array after 1 and 3 steps: "
          f"{errs[0]}, {errs[1]}")
    res['err'] = max(errs)
    return res


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('N', type=int, nargs='?', default=240)
    ap.add_argument('STEPS', type=int, nargs='?', default=64)
    ap.add_argument('TX', type=int, nargs='?', default=32)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    a = ap.parse_args()
    main(a.N, a.STEPS, a.TX, a.device)
