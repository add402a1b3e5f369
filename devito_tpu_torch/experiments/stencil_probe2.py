"""Probe 2: the x-tiled neighbour-block acoustic SO=8 step (K4).

Ports ``experiments/stencil_probe2.py``. Arrays are (NP, NP, ZP) with
NP = N + 8 (halo 4) and ZP = NP rounded up to 128. One step returns a
fresh array: ``2 uc - up + mfull lap(uc)`` on every row, zero where y or z
lies outside the interior. Rows are cut into x-tiles of T; the JAX kernel
reads each tile's x taps from its block and its two neighbour blocks, the
neighbours clamped to the array, and leaves its x-halo rows computed, not
zeroed: in tile 0 an x tap with l + k < 0, and in the last tile one with
l + k >= T, reads row i*T + ((l + k) mod T) of the tile itself. The port
keeps that rule (so T >= 4 must divide NP), since those rows feed the
interior from the second step on.

- A: the interior update written into up (``run_A``, torch-DUS);
- B: the update over the whole array with ``torch.roll`` taps, times a
  0/1 mask of the interior (``run_B``);
- C: the loop through K4 (``run_C``, ``csrc/probe_tiles_stream.cu``: a
  point of K1's streaming engine over the interior, uc staged, up and
  mfull read at the point; a kernel that zeroes everything outside the
  interior columns, ``_tiled.stream_step``; and one that computes the
  x-halo rows by the rule above, ``edge_rows``), rotating three buffers.

    python -m devito_tpu_torch.experiments.stencil_probe2 [N] [STEPS] [T] [--device cuda|cpu]

prints A's, B's and C's milliseconds and GPts/s over STEPS steps, C's
error against A after 3 steps away from the edges (points 16 or more
inside the interior on every axis, which the halo, kept by A and
recomputed by C, has not reached; N > 32), and K4's against its plain
version (one step and 3 steps, whole array); any error beyond 1e-5
max|plain| raises.
"""

import argparse
import ctypes

import numpy as np
import torch

from . import _stream, device_for
from ._tiled import FLOPS, H, W, STREAM_TILE, apart, check, close, frame, \
    lap, run_interior, stream, stream_step, timed_run
from ..kernels import _nvcc

__all__ = ['neighbour_blocks_step', 'neighbour_blocks_kernel',
           'neighbour_blocks_step_reference', 'lap_full', 'run_A', 'run_B',
           'run_C', 'inputs', 'main', 'FLOPS']

#: K4 kernel launches.
launches = 0


def lap_full(u):
    """The SO=8 Laplacian over the whole array with periodic
    (``torch.roll``) taps, as the JAX script's ``lap_full``."""
    out = None
    for axis in range(3):
        for i, w in enumerate(W):
            t = float(w) * torch.roll(u, H - i, axis)
            out = t if out is None else out + t
    return out


def nb_check(what, up, uc, mfull, T, out):
    """The checks of K4 and K5: (NP, NP, ZP) fp32 arrays with ZP >= NP,
    T >= 4 dividing NP, out apart from uc."""
    check(what, (up, uc, mfull) + (() if out is None else (out,)))
    NP, ZP = uc.shape[0], uc.shape[2]
    if NP <= 2 * H or tuple(uc.shape) != (NP, NP, ZP) or ZP < NP or any(
            t.shape != uc.shape for t in (up, mfull)
            + (() if out is None else (out,))):
        raise ValueError(f"shapes {[tuple(t.shape) for t in (up, uc, mfull)]}"
                         f": expected (NP, NP, ZP) with NP = N + 8, ZP >= NP")
    if T < 4 or NP % T:
        raise ValueError(f"T={T}: the neighbour-block rule needs T >= 4 "
                         f"dividing NP={NP}")
    apart(what, out, uc)


def nb_kernel(what, up, uc, mfull, T, out, zeroed, x_chunk, tile, zeros):
    """K4's (``zeroed`` False) or K5's launches on CUDA tensors that
    ``nb_check`` has checked: the engine over the interior
    (``_tiled.stream_step``, each CTA walking ``x_chunk`` x-planes on the
    engine compiled for ``tile``), with the frame kernel's zeros first
    unless ``zeros`` is False; then K4's x-halo rows (``edge_rows``), which
    touch no point of the others'. Returns ``out``."""
    n = uc.shape[0] - 2 * H
    stream_step(what, nb_rows(what, up, uc, mfull, out), (n, n, n),
                nb_frame(out, zeroed), x_chunk, tile, uc.device, zeros)
    if not zeroed:
        edge_rows(what, up, uc, mfull, T, out)
    return out


def nb_rows(what, up, uc, mfull, out):
    """K4's and K5's rows for the engine (``_stream.rows``): out, uc
    staged, up and mfull, each at the interior's first point (4, 4, 4)."""
    org = (H, H, H)
    return _stream.rows(what, (out, org), [(uc, org)],
                        [(up, org), (mfull, org)])


def nb_frame(out, zeroed):
    """K4's and K5's frame (``_tiled.frame``): the whole (NP, NP, ZP) array
    less the interior [4, 4+N)^3 (K5, ``zeroed``), or less the interior
    columns over every x row (K4)."""
    NP = out.shape[0]
    n = NP - 2 * H
    inner = ((H, H, H), (n, n, n)) if zeroed else ((0, H, H), (NP, n, n))
    return frame(out, ((0, 0, 0), tuple(out.shape)), inner)


def edge_rows(what, up, uc, mfull, T, out):
    """Launch ``csrc/probe_tiles_stream.cu``'s edge-row kernel on CUDA
    tensors: K4's x-halo rows over the interior columns, into ``out``
    (``edge_rows_reference`` is its plain version). Raises when the launch
    fails."""
    fn = _nvcc.entry('probe_tiles_stream', 'dtpu_probe_edge_rows_launch',
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    with torch.cuda.device(uc.device):
        rc = fn(uc.data_ptr(), up.data_ptr(), mfull.data_ptr(),
                out.data_ptr(), uc.shape[0] - 2 * H, uc.shape[2], T,
                stream(uc.device))
    _nvcc.check_launch(rc, f"{what} edge-row kernel")


def edge_rows_reference(up, uc, mfull, T, out):
    """The plain version of the edge-row kernel: K4's x-halo rows 0-3 and
    NP-4..NP-1 over the interior columns, the x taps from ``x_sources``'
    rows, then the y and z taps; written into ``out``, which is
    returned."""
    NP = uc.shape[0]
    n = NP - 2 * H
    srcs = x_sources(NP, T, uc.device)
    c = slice(H, H + n)
    for x0 in (0, NP - H):
        acc = None
        for w, rows in zip(W, srcs):
            t = float(w) * uc.index_select(0, rows[x0:x0 + H])[:, c, c]
            acc = t if acc is None else acc + t
        acc = lap(uc, (x0, H, H), (H, n, n), axes=(1, 2), out=acc)
        b = (slice(x0, x0 + H), c, c)
        out[b] = 2.0 * uc[b] - up[b] + mfull[b] * acc
    return out


def interior_reference(up, uc, mfull, out):
    """The plain version of the engine on K4's and K5's rows: the update
    over the interior [4, 4+N)^3, written into ``out``, which is
    returned."""
    n = uc.shape[0] - 2 * H
    b = (slice(H, H + n),) * 3
    out[b] = 2.0 * uc[b] - up[b] + mfull[b] * lap(uc, (H, H, H), (n, n, n))
    return out


def x_sources(NP, T, device):
    """For each x tap k = -4..4, the row each of the NP output rows reads:
    r + k, except in the edge tiles, where a tap past the tile's clamped
    neighbour block reads row i*T + ((l + k) mod T) of the tile itself."""
    r = torch.arange(NP)
    i, l = r // T, r % T
    rows = []
    for k in range(-H, H + 1):
        wrap = ((i == 0) & (l + k < 0)) | ((i == NP // T - 1) & (l + k >= T))
        rows.append(torch.where(wrap, i * T + (l + k) % T, r + k).to(device))
    return rows


def nb_reference(up, uc, mfull, T, zero_x_halo, out=None):
    """The plain version of K4 (``zero_x_halo`` False) and K5 (True): the
    JAX kernels' arithmetic (``stencil_probe2.py:94-107``,
    ``stencil_probe3.py:107-125``) over every row."""
    n = uc.shape[0] - 2 * H
    c = slice(H, H + n)
    ucc = uc[:, c, c]
    acc = None
    for w, rows in zip(W, x_sources(uc.shape[0], T, uc.device)):
        t = float(w) * ucc.index_select(0, rows)
        acc = t if acc is None else acc + t
    acc = lap(uc, (0, H, H), (uc.shape[0], n, n), axes=(1, 2), out=acc)
    val = 2.0 * ucc - up[:, c, c] + mfull[:, c, c] * acc
    if zero_x_halo:
        val[:H] = 0.0
        val[H + n:] = 0.0
    out = torch.zeros_like(uc) if out is None else out.zero_()
    out[:, c, c] = val
    return out


def neighbour_blocks_step(up, uc, mfull, T=8, out=None):
    """One K4 step: the fresh (NP, NP, ZP) array of the JAX kernel, x-halo
    rows computed by the neighbour-block rule, written into ``out`` (not
    uc) or a new array, and returned. CUDA tensors go through the kernels
    (``neighbour_blocks_kernel``); CPU tensors through
    ``neighbour_blocks_step_reference``."""
    nb_check('neighbour-block step', up, uc, mfull, T, out)
    if uc.device.type == 'cpu':
        return neighbour_blocks_step_reference(up, uc, mfull, T, out)
    if out is None:
        out = torch.empty_like(uc)
    return neighbour_blocks_kernel(up, uc, mfull, T, out, _stream.X_CHUNK)


def neighbour_blocks_kernel(up, uc, mfull, T, out, x_chunk,
                            tile=STREAM_TILE, zeros=True):
    """K4's launches on CUDA tensors that ``neighbour_blocks_step`` has
    checked (``nb_kernel``): the frame unless ``zeros`` is False, the
    engine compiled for ``tile``, each CTA walking ``x_chunk`` x-planes,
    and the x-halo rows (``neighbour_blocks_step`` passes
    ``_stream.X_CHUNK`` and ``_tiled.STREAM_TILE``; chip_smoke.py sweeps
    both). Returns ``out``."""
    global launches
    nb_kernel('neighbour-block step', up, uc, mfull, T, out, False, x_chunk,
              tile, zeros)
    launches += 1
    return out


def neighbour_blocks_step_reference(up, uc, mfull, T=8, out=None):
    """The plain PyTorch version of ``neighbour_blocks_step``."""
    return nb_reference(up, uc, mfull, T, False, out)


def run_A(u0, u1, m, damp, nsteps):
    """Variant A, the JAX script's ``run_A``: ``run_interior``, with damp
    unused, as there."""
    return run_interior(u0, u1, m, nsteps)


def run_B(u0, u1, mfull, mask, nsteps):
    """Variant B, the JAX script's ``run_B``: ``nsteps`` updates of the
    whole array with periodic taps, times ``mask``; returns the last
    pair."""
    up, uc = u0, u1
    for _ in range(nsteps):
        up, uc = uc, mask * (2.0 * uc - up + mfull * lap_full(uc))
    return up, uc


def run_C(u0, u1, mfull, nsteps, T=8, plain=False):
    """Variant C, the JAX script's ``run_C``: ``nsteps`` K4 steps (``plain``:
    its plain version), each into the spare of three rotating buffers;
    returns the last pair. u0 and u1 are overwritten."""
    step = neighbour_blocks_step_reference if plain else neighbour_blocks_step
    up, uc, spare = u0, u1, torch.empty_like(u0)
    for _ in range(nsteps):
        un = step(up, uc, mfull, T, out=spare)
        up, uc, spare = uc, un, up
    return up, uc


def inputs(N, device, seed=0):
    """The JAX script's inputs: u0 normal * 1e-3 over the whole (NP, NP,
    ZP) array (numpy's generator ``seed``), u1 zero, m 0.2 (N, N, N),
    mfull 0.2, the interior mask, damp zero (N, N, N)."""
    NP = N + 2 * H
    shape = (NP, NP, -(-NP // 128) * 128)
    u0 = np.random.default_rng(seed).standard_normal(shape) * 1e-3
    mask = torch.zeros(shape, device=device)
    mask[H:H + N, H:H + N, H:H + N] = 1.0
    return (torch.from_numpy(u0.astype(np.float32)).to(device),
            torch.zeros(shape, device=device),
            torch.full((N,) * 3, 0.2, device=device),
            torch.full(shape, 0.2, device=device), mask,
            torch.zeros((N,) * 3, device=device))


def main(N=128, STEPS=64, T=8, device='cuda'):
    """Time A, B and C over ``STEPS`` steps, then check C against A away
    from the x edges and K4 against its plain version; returns the numbers
    it prints."""
    dev = device_for(device)
    u0, u1, m, mfull, mask, damp = inputs(N, dev)

    def fresh():
        return u0.clone(), u1.clone()

    a, c = fresh(), fresh()
    res = {
        'ms_a': timed_run('A torch-DUS', lambda: run_A(*a, m, damp, STEPS),
                          N, STEPS, dev),
        'ms_b': timed_run('B torch-mask', lambda: run_B(
            u0, u1, mfull, mask, STEPS), N, STEPS, dev),
        'ms_c': timed_run(f'C kernel-nb T={T}', lambda: run_C(
            *c, mfull, STEPS, T), N, STEPS, dev)}
    c3 = run_C(*fresh(), mfull, 3, T)[1]
    if N > 32:
        s = (slice(H + 16, H + N - 16),) * 3
        err, tol = close('C against A away from the edges', c3[s],
                         run_A(*fresh(), m, damp, 3)[1][s])
        print(f"C vs A central err: {err} (tolerance {tol:.3e})")
        res.update(err_a=err, tol=tol)
    errs = [close('K4 against its plain version, 1 step',
                  run_C(*fresh(), mfull, 1, T)[1],
                  run_C(*fresh(), mfull, 1, T, plain=True)[1])[0],
            close('K4 against its plain version, 3 steps', c3,
                  run_C(*fresh(), mfull, 3, T, plain=True)[1])[0]]
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
