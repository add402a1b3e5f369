"""Probe 3: the x-tiled neighbour-block acoustic SO=8 step with its x-halo
rows zeroed (K5).

Ports ``experiments/stencil_probe3.py``. Arrays are (NP, NP, ZP) with
NP = N + 8 (halo 4) and ZP = NP rounded up to 128. One step returns a
fresh array: ``2 uc - up + mfull lap(uc)`` on the interior and zero
everywhere else. The kernel is K4's (``stencil_probe2``) with its x-halo
rows written as zero; T >= 4 must divide NP.

- A: the interior update written into up (``run_A``, torch-DUS);
- D: the Laplacian as three 1-D convolutions (``run_D``, ``F.conv3d``,
  TF32 off);
- E: the loop through K5 (``run_E``, ``csrc/probe_tiles_stream.cu``: K4's
  point of K1's streaming engine over the interior, and the frame kernel
  zeroing everything else, ``stencil_probe2.nb_kernel``), rotating three
  buffers.

    python -m devito_tpu_torch.experiments.stencil_probe3 [N] [STEPS] [T] [--device cuda|cpu]

prints A's, D's and E's milliseconds and GPts/s over STEPS steps, D's and
E's errors against A after 3 steps, and K5's against its plain version
(one step and 3 steps, whole array); any error beyond 1e-5 max|plain|
raises.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from . import _stream, device_for
from ._tiled import FLOPS, H, STREAM_TILE, W, close, run_interior, timed_run
from .stencil_probe2 import nb_check, nb_kernel, nb_reference

__all__ = ['neighbour_blocks_zeroed_step', 'neighbour_blocks_zeroed_kernel',
           'neighbour_blocks_zeroed_step_reference', 'run_A', 'run_D',
           'run_E', 'inputs', 'main', 'FLOPS']

#: K5 kernel launches.
launches = 0


def neighbour_blocks_zeroed_step(up, uc, mfull, T=8, out=None):
    """One K5 step: the fresh (NP, NP, ZP) array, the interior update and
    zero everywhere else, written into ``out`` (not uc) or a new array, and
    returned. T, which must divide NP, was the TPU kernel's x-tile; the
    result does not depend on it, and on the card the tile is the
    streaming engine's. CUDA tensors go through the kernels
    (``neighbour_blocks_zeroed_kernel``); CPU tensors through
    ``neighbour_blocks_zeroed_step_reference``."""
    nb_check('zeroed neighbour-block step', up, uc, mfull, T, out)
    if uc.device.type == 'cpu':
        return neighbour_blocks_zeroed_step_reference(up, uc, mfull, T, out)
    if out is None:
        out = torch.empty_like(uc)
    return neighbour_blocks_zeroed_kernel(up, uc, mfull, out,
                                          _stream.X_CHUNK)


def neighbour_blocks_zeroed_kernel(up, uc, mfull, out, x_chunk,
                                   tile=STREAM_TILE, zeros=True):
    """K5's launches on CUDA tensors that ``neighbour_blocks_zeroed_step``
    has checked (``stencil_probe2.nb_kernel``): the frame unless ``zeros``
    is False, and the engine compiled for ``tile``, each CTA walking
    ``x_chunk`` x-planes (``neighbour_blocks_zeroed_step`` passes
    ``_stream.X_CHUNK`` and ``_tiled.STREAM_TILE``; chip_smoke.py sweeps
    both). Returns ``out``."""
    global launches
    nb_kernel('zeroed neighbour-block step', up, uc, mfull, None, out, True,
              x_chunk, tile, zeros)
    launches += 1
    return out


def neighbour_blocks_zeroed_step_reference(up, uc, mfull, T=8, out=None):
    """The plain PyTorch version of ``neighbour_blocks_zeroed_step``."""
    return nb_reference(up, uc, mfull, T, True, out)


#: Variant A, the JAX script's ``run_A``.
run_A = run_interior


def _conv1d(u, axis):
    """The valid 1-D convolution of ``u`` with the SO=8 weights along
    ``axis``."""
    shape = [1, 1, 1, 1, 1]
    shape[2 + axis] = len(W)
    k = torch.tensor(np.array(W, np.float32), device=u.device).reshape(shape)
    return F.conv3d(u[None, None], k)[0, 0]


def run_D(u0, u1, m, nsteps):
    """Variant D, the JAX script's ``run_D``: as ``run_A`` with the
    Laplacian taken as three 1-D convolutions, in fp32 (cuDNN's TF32 off).
    u0 and u1 are updated in place."""
    up, uc = u0, u1
    n = u0.shape[0] - 2 * H
    c = slice(H, H + n)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for _ in range(nsteps):
            lap = (_conv1d(uc, 0)[:, c, c] + _conv1d(uc, 1)[c, :, c]
                   + _conv1d(uc, 2)[c, c, :n])
            up[c, c, c] = 2.0 * uc[c, c, c] - up[c, c, c] + m * lap
            up, uc = uc, up
    return up, uc


def run_E(u0, u1, mfull, nsteps, T=8, plain=False):
    """Variant E, the JAX script's ``run_E``: ``nsteps`` K5 steps
    (``plain``: its plain version), each into the spare of three rotating
    buffers; returns the last pair. u0 and u1 are overwritten."""
    step = neighbour_blocks_zeroed_step_reference if plain \
        else neighbour_blocks_zeroed_step
    up, uc, spare = u0, u1, torch.empty_like(u0)
    for _ in range(nsteps):
        un = step(up, uc, mfull, T, out=spare)
        up, uc, spare = uc, un, up
    return up, uc


def inputs(N, device, seed=0):
    """The JAX script's inputs: u0 normal * 1e-3 in the interior and zero
    elsewhere (numpy's generator ``seed``), u1 zero, m 0.2 (N, N, N) and
    mfull 0.2 over the (NP, NP, ZP) array."""
    NP = N + 2 * H
    shape = (NP, NP, -(-NP // 128) * 128)
    u0 = np.zeros(shape, np.float32)
    u0[H:H + N, H:H + N, H:H + N] = \
        np.random.default_rng(seed).standard_normal((N,) * 3) * 1e-3
    return (torch.from_numpy(u0).to(device), torch.zeros(shape, device=device),
            torch.full((N,) * 3, 0.2, device=device),
            torch.full(shape, 0.2, device=device))


def main(N=128, STEPS=64, T=8, device='cuda'):
    """Time A, D and E over ``STEPS`` steps, then check D and E against A
    and K5 against its plain version; returns the numbers it prints."""
    dev = device_for(device)
    u0, u1, m, mfull = inputs(N, dev)

    def fresh():
        return u0.clone(), u1.clone()

    a, d, e = fresh(), fresh(), fresh()
    res = {
        'ms_a': timed_run('A torch-DUS', lambda: run_A(*a, m, STEPS), N,
                          STEPS, dev),
        'ms_d': timed_run('D torch-conv', lambda: run_D(*d, m, STEPS), N,
                          STEPS, dev)}
    a3 = run_A(*fresh(), m, 3)[1]
    res['err_d'], tol = close('D against A after 3 steps',
                              run_D(*fresh(), m, 3)[1], a3)
    print(f"D vs A err: {res['err_d']} (tolerance {tol:.3e})", flush=True)
    res['ms_e'] = timed_run(f'E kernel-nb T={T}', lambda: run_E(
        *e, mfull, STEPS, T), N, STEPS, dev)
    e3 = run_E(*fresh(), mfull, 3, T)[1]
    res['err_a'], res['tol'] = close('E against A after 3 steps', e3, a3)
    print(f"E vs A err: {res['err_a']} (tolerance {res['tol']:.3e})")
    errs = [close('K5 against its plain version, 1 step',
                  run_E(*fresh(), mfull, 1, T)[1],
                  run_E(*fresh(), mfull, 1, T, plain=True)[1])[0],
            close('K5 against its plain version, 3 steps', e3,
                  run_E(*fresh(), mfull, 3, T, plain=True)[1])[0]]
    print(f"max |kernel - plain| over the whole array after 1 and 3 steps: "
          f"{errs[0]}, {errs[1]}")
    res['err'] = max(errs)
    return res


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('N', type=int, nargs='?', default=128)
    ap.add_argument('STEPS', type=int, nargs='?', default=64)
    ap.add_argument('T', type=int, nargs='?', default=8)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    a = ap.parse_args()
    main(a.N, a.STEPS, a.T, a.device)
