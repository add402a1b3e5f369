"""Probe 9: the sliding-window (ring) step of the acoustic SO=8 update (K15).

Ports ``experiments/stencil_probe9.py``. The field u0 is stored
(N+16, N+16, N): x/y halo 8, z compact, z taps outside [0, N) reading
zero. u1, vp and dp are (N+16, N, N), halo'd in x only. One step writes
``2u - u1 + c*vp^2*acc - dp*u`` into a new (N, N, N) tensor. The kernel
(``csrc/probe9_ring.cu``) gives each CTA a (y, z) tile and marches it
along x through a TX-plane chunk, keeping a ring of x-planes of u0 in
shared memory, so that each plane of the tile is loaded once.

    python -m devito_tpu_torch.experiments.stencil_probe9 [N] [TX] [steps] [--device cuda|cpu]

prints the error against the plain version, then ms/step, GPts/s and the
effective GB/s (five N^3 fp32 arrays per step), as the JAX script does.
"""

import argparse
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import device_for, time_ms
from ..kernels import _nvcc

__all__ = ['ring_step', 'ring_step_reference', 'inputs', 'main', 'FLOPS']

H = 8  # SO=8 halo
R = 4  # stencil radius
#: SO=8 second-derivative weights, centre at index 4.
W = np.array([-1/560, 8/315, -1/5, 8/5, -205/72, 8/5, -1/5, 8/315, -1/560],
             np.float32)
TOL = 1e-5  # times max |plain|: fp32 sums in another order
#: fp32 operations per point of the update, each binary operation of
#: ``ring_step_reference`` one: 33 for the Laplacian, 8 for the rest.
FLOPS = 41

#: K15 kernel launches.
launches = 0


def _check(u0, u1, vp, dp, TX):
    N = u0.shape[-1]
    tensors = (u0, u1, vp, dp)
    if any(not isinstance(t, torch.Tensor) or t.dtype != torch.float32
           or not t.is_contiguous() for t in tensors):
        raise TypeError("the ring step takes contiguous fp32 tensors")
    if tuple(u0.shape) != (N + 2 * H, N + 2 * H, N) or any(
            tuple(t.shape) != (N + 2 * H, N, N) for t in tensors[1:]):
        raise ValueError(f"shapes {[tuple(t.shape) for t in tensors]}: "
                         f"expected u0 (N+16, N+16, N) and u1, vp, dp "
                         f"(N+16, N, N)")
    if any(t.device != u0.device for t in tensors):
        raise ValueError("the ring step's tensors lie on different devices")
    if TX < 1 or N % TX:
        raise ValueError(f"TX={TX} does not divide N={N}")
    return N


def ring_step(u0, u1, vp, dp, c, TX=32):
    """One K15 step: the (N, N, N) update from u0 (N+16, N+16, N) and u1,
    vp, dp (N+16, N, N), c a scalar; each CTA marches TX x-planes. CUDA
    tensors go through the kernel; CPU tensors through
    ``ring_step_reference``."""
    global launches
    N = _check(u0, u1, vp, dp, TX)
    if u0.device.type == 'cpu':
        return ring_step_reference(u0, u1, vp, dp, c)
    if u0.device.type != 'cuda':
        raise ValueError(f"no ring-step kernel for device {u0.device}")
    if N % 4 or any(t.data_ptr() % 16 for t in (u0, u1, vp, dp)):
        raise ValueError("the ring-step kernel needs N % 4 == 0 and "
                         "16-byte aligned tensors")
    out = torch.empty((N, N, N), dtype=torch.float32, device=u0.device)
    fn = _nvcc.entry('probe9_ring', 'dtpu_ring_launch',
                     [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(u0.device):
        rc = fn(u0.data_ptr(), u1.data_ptr(), vp.data_ptr(), dp.data_ptr(),
                out.data_ptr(), float(c), N, TX,
                torch.cuda.current_stream().cuda_stream)
    _nvcc.check_launch(rc, "ring-step kernel")
    launches += 1
    return out


def ring_step_reference(u0, u1, vp, dp, c):
    """The plain PyTorch version of ``ring_step``: the JAX script's inline
    reference (``stencil_probe9.py:173-186``)."""
    N = u0.shape[-1]
    u = u0[H:H + N, H:H + N, :]
    acc = float(W[4] * np.float32(3.0)) * u
    for k in range(1, R + 1):
        acc = acc + float(W[4 + k]) * (
            u0[H + k:H + N + k, H:H + N, :] + u0[H - k:H + N - k, H:H + N, :]
            + u0[H:H + N, H + k:H + N + k, :]
            + u0[H:H + N, H - k:H + N - k, :])
        zp = F.pad(u, (0, k))[:, :, k:]
        zm = F.pad(u, (k, 0))[:, :, :N]
        acc = acc + float(W[4 + k]) * (zp + zm)
    return (2.0 * u - u1[H:H + N] + c * vp[H:H + N] ** 2 * acc
            - dp[H:H + N] * u)


def inputs(N, device, seed=0):
    """The JAX script's inputs: u0 and u1 standard normal from numpy's
    generator ``seed``, vp 1.5, dp 0, c 1e-4; u1, vp, dp cut to the
    kernel's (N+16, N, N) slabs."""
    NXP = N + 2 * H
    rng = np.random.default_rng(seed)
    u0 = rng.standard_normal((NXP, NXP, N)).astype(np.float32)
    u1 = rng.standard_normal((NXP, NXP, N)).astype(np.float32)
    u1s = np.ascontiguousarray(u1[:, H:H + N, :])
    return (torch.from_numpy(u0).to(device), torch.from_numpy(u1s).to(device),
            torch.full((NXP, N, N), 1.5, device=device),
            torch.zeros((NXP, N, N), device=device), 1e-4)


def main(N=256, TX=32, steps=64, device='cuda'):
    """Run one step against the plain version (raises beyond TOL), then
    time ``steps`` steps; returns the numbers it prints."""
    dev = device_for(device)
    u0, u1, vp, dp, c = inputs(N, dev)
    out = ring_step(u0, u1, vp, dp, c, TX)
    ref = ring_step_reference(u0, u1, vp, dp, c)
    err = (out - ref).abs().max().item()
    tol = TOL * ref.abs().max().item()
    print(f'max abs err vs plain version: {err} (tolerance {tol:.3e})')
    if not err <= tol:
        raise AssertionError(f"ring step disagrees with its plain version: "
                             f"{err} > {tol}")
    ms = time_ms(lambda: ring_step(u0, u1, vp, dp, c, TX), steps, dev)
    gb = 5 * N ** 3 * 4 / 1e9
    gpts = N ** 3 / ms / 1e6
    print(f'N={N} TX={TX}: {ms:.3f} ms/step, {gpts:.2f} GPts/s, '
          f'{gb / ms * 1e3:.0f} GB/s effective on {_name(dev)}')
    return {'err': err, 'tol': tol, 'ms': ms, 'gpts': gpts,
            'gbs': gb / ms * 1e3}


def _name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('N', type=int, nargs='?', default=256)
    ap.add_argument('TX', type=int, nargs='?', default=32)
    ap.add_argument('steps', type=int, nargs='?', default=64)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    a = ap.parse_args()
    main(a.N, a.TX, a.steps, a.device)
