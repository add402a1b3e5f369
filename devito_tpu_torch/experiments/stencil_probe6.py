"""Probe 6: the card's copy bandwidth (P1), window copies at aligned and
unaligned start offsets (P2, kernel K8) and the in-place x-tiled acoustic
SO=8 step (P3, kernel K9).

Ports ``experiments/stencil_probe6.py``. Buffers are (NY, NY, ZA) fp32
with NY = N + 16 (halo H = 8 per side) and, on the card, ZA = NY: the
JAX script's 384-lane z allocation is a TPU layout. The functions take
any ZA >= NY, so that the same arrays can go through both packages.

- P1 times ``a + 1.0`` over a padded buffer, read and write: the card's
  measured copy bandwidth, a ceiling for the stencil kernels.
- P2 copies the window ``src[0:64, 8:8+N, zoff:zoff+zlen]`` through
  shared memory into the same window of a new buffer, for (zoff, zlen) =
  (0, N), (8, N) and (0, N+16) (K8, ``csrc/probe6_window_copy.cu``):
  what a start offset of 32 bytes, not 128-byte aligned, costs.
- P3 runs the damped update of the interior in place into a target buffer
  (K9, ``csrc/probe6_stream.cu``: a point of K1's streaming engine), for
  t0 and 2*t0 (the TPU kernel's x-rows per tile) and each tap ablation,
  against ``ref_step``, and times 32-step loops.

    python -m devito_tpu_torch.experiments.stencil_probe6 [t0] [--device cuda|cpu] [--n N]
"""

import argparse
import ctypes

import numpy as np
import torch

from . import _stream, device_for, time_ms
from ..kernels import _nvcc

__all__ = ['window_copy', 'window_copy_reference', 'p2_windows',
           'inplace_step', 'inplace_kernel', 'inplace_step_reference',
           'ref_step',
           'p1_copy_roofline', 'p2_misaligned_dma', 'p3_kernel', 'main']

N = 256
H = 8          # allocated halo per side
R = 4          # stencil radius (SO=8 second derivative)
DT = 0.1
HSP = 10.0
W = [-205.0 / 72, 8.0 / 5, -1.0 / 5, 8.0 / 315, -1.0 / 560]
TAPS = ('none', 'z', 'full')
OUT_MODES = ('fullz', 'interior')
TOL = 1e-5  # times max |plain|: fp32 sums in another order
#: fp32 operations per point of ``ref_step``, by taps: the Laplacian's 1,
#: plus 3 ('z') or 7 ('full') for each k = 1..4, and 13 for the rest.
FLOPS = {'none': 14, 'z': 26, 'full': 42}

#: K9 (in-place step) kernel launches.
inplace_launches = 0
#: K8 (window copy) kernel launches.
window_copy_launches = 0

_SMEM = 232448  # bytes of shared memory a block may use on Hopper
_K8_ROWS = 16                           # y-rows K8 stages per block


def _fp32(what, *tensors):
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.dim() != 3:
            raise TypeError("the probe kernels take contiguous 3-D fp32 "
                            "tensors")
        if t.device != tensors[0].device:
            raise ValueError("the probe's tensors lie on different devices")
    if tensors[0].device.type not in ('cpu', 'cuda'):
        raise ValueError(f"no {what} kernel for device {tensors[0].device}")


def _aligned(what, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the {what} kernel needs 16-byte aligned tensors")


def _cuda_stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# -- K8: window copies ---------------------------------------------------------

def _window_slices(window):
    return tuple(slice(a, a + n) for a, n in window)


def window_copy(src, window):
    """A new buffer shaped like ``src`` whose ``window`` (one (start,
    length) pair per axis) holds ``src``'s; the rest is left unset, as in
    the TPU probe. CUDA tensors go through K8 (global -> shared -> global
    with cp.async); CPU tensors through ``window_copy_reference``."""
    global window_copy_launches
    _fp32('window-copy', src)
    if any(a < 0 or n < 0 or a + n > s for (a, n), s in zip(window, src.shape)):
        raise ValueError(f"window {window} outside shape {tuple(src.shape)}")
    if src.device.type == 'cpu':
        return window_copy_reference(src, window)
    _aligned('window-copy', src)
    (x0, nx), (y0, ny), (z0, nz) = window
    Y, Z = src.shape[1:]
    if Z % 4 or z0 % 4 or nz % 4 or _K8_ROWS * nz * 4 > _SMEM:
        raise ValueError("the window-copy kernel needs z start, z length and "
                         "row length in multiples of 4 floats, z length "
                         f"at most {_SMEM // (4 * _K8_ROWS)}")
    out = torch.empty_like(src)
    fn = _nvcc.entry('probe6_window_copy', 'dtpu_window_copy_launch',
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p])
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), out.data_ptr(), Y, Z, x0, nx, y0, ny, z0, nz,
                _cuda_stream(src.device))
    _nvcc.check_launch(rc, "window-copy kernel")
    window_copy_launches += 1
    return out


def window_copy_reference(src, window):
    """The plain PyTorch version of ``window_copy``."""
    out = torch.empty_like(src)
    sl = _window_slices(window)
    out[sl] = src[sl]
    return out


def p2_windows(n=N):
    """The three windows of P2 for interior size ``n``, with their labels:
    z from 0 and from 8 (32 bytes, not 128-byte aligned) of length n, and
    z from 0 of length n + 16."""
    rows = min(64, n + 2 * H)
    return [(f"aligned   z[0:{n})", ((0, rows), (H, n), (0, n))),
            (f"misaligned z[8:{n + 8})", ((0, rows), (H, n), (8, n))),
            (f"aligned   z[0:{n + 16}) partial-tile len",
             ((0, rows), (H, n), (0, n + 16)))]


# -- K9: the in-place step -----------------------------------------------------

def _interior(ut):
    NY, ZA = ut.shape[0], ut.shape[2]
    n = NY - 2 * H
    if n < 1 or tuple(ut.shape) != (NY, NY, ZA) or ZA < NY:
        raise ValueError(f"buffer shape {tuple(ut.shape)}: expected "
                         f"(N+16, N+16, ZA) with ZA >= N+16")
    return n


def inplace_step(ut, utm1, vp, damp, tgt, t0, out_mode='fullz',
                 taps='full', zin_full=True):
    """One damped acoustic SO=8 update of the interior [H, H+N)^3 of the
    (N+16, N+16, ZA) buffers, written into ``tgt`` in place (and
    returned): ``out_mode`` 'fullz' writes the rows x in [H, H+N) whole,
    y/z halo zeroed, 'interior' only the interior; x-halo rows keep their
    content. ``taps`` is 'none', 'z' or 'full'. ``t0`` was the TPU
    kernel's x-rows a tile and must divide N, as there; the result does
    not depend on it, nor on ``zin_full``, which chose the TPU kernel's
    read window. On the card each CTA walks ``_stream.X_CHUNK`` x-planes
    whatever t0 is (``inplace_kernel``). CUDA tensors go through K9; CPU
    tensors through ``inplace_step_reference``. ``tgt`` must not be
    ``ut``."""
    _fp32('in-place step', ut, utm1, vp, damp, tgt)
    n = _interior(ut)
    if any(t.shape != ut.shape for t in (utm1, vp, damp, tgt)):
        raise ValueError("the step's buffers differ in shape")
    if out_mode not in OUT_MODES or taps not in TAPS:
        raise ValueError(f"out_mode {out_mode!r}, taps {taps!r}: expected "
                         f"one of {OUT_MODES} and of {TAPS}")
    if t0 < 1 or n % t0:
        raise ValueError(f"t0={t0} does not divide N={n}")
    if tgt.data_ptr() == ut.data_ptr():
        raise ValueError("the target of the in-place step is u[t] itself")
    if ut.device.type == 'cpu':
        return inplace_step_reference(ut, utm1, vp, damp, tgt, out_mode,
                                      taps)
    return inplace_kernel(ut, utm1, vp, damp, tgt, out_mode, taps,
                          _stream.X_CHUNK)


def inplace_kernel(ut, utm1, vp, damp, tgt, out_mode, taps, x_chunk):
    """K9's launch on CUDA tensors that ``inplace_step`` has checked, each
    CTA walking ``x_chunk`` x-planes (``inplace_step`` passes
    ``_stream.X_CHUNK``; chip_smoke.py sweeps it): u[t] is the engine's
    staged group, u[t-1], vp and damp its centre groups, all at (H, H, H);
    with 'fullz' the unit's frame kernel writes the zeros in the same
    call. Returns ``tgt``."""
    global inplace_launches
    n = _interior(ut)
    params = (3.0 * W[0], *W[1:], 1.0 / (HSP * HSP), 1.0 / (DT * DT),
              0.5 / DT)
    _stream.launch('in-place step', 'probe6_stream',
                   _rows(ut, utm1, vp, damp, tgt), (n, n, n),
                   x_chunk, ut.device, params,
                   TAPS.index(taps) + 4 * (out_mode == 'fullz'))
    inplace_launches += 1
    return tgt


def _rows(ut, utm1, vp, damp, tgt):
    """K9's rows for the engine (``_stream.rows``): the target, then u[t]
    staged, then u[t-1], vp and damp, all with the region at (H, H, H)."""
    org = (H, H, H)
    return _stream.rows('in-place step', (tgt, org), [(ut, org)],
                        [(utm1, org), (vp, org), (damp, org)])


def ref_step(ut, utm1, vp, damp, taps='full'):
    """The interior's new values, (N, N, N): a port of the JAX script's
    ``ref_step`` (``stencil_probe6.py:254-267``), with the tap ablations
    of its kernel ('full' is ``ref_step`` itself)."""
    n = _interior(ut)
    sl = slice(H, H + n)
    u = ut[sl, sl, sl]
    lap = (3.0 * W[0]) * u
    if taps != 'none':
        for k in range(1, R + 1):
            zp, zm = ut[sl, sl, H + k:H + k + n], ut[sl, sl, H - k:H - k + n]
            if taps == 'full':
                t = (ut[H + k:H + k + n, sl, sl] + ut[H - k:H - k + n, sl, sl]
                     + ut[sl, H + k:H + k + n, sl]
                     + ut[sl, H - k:H - k + n, sl] + zp + zm)
            else:
                t = zp + zm
            lap = lap + W[k] * t
    lap = lap / (HSP * HSP)
    m = 1.0 / (vp[sl, sl, sl] ** 2)
    a = m / (DT * DT)
    b = damp[sl, sl, sl] * 0.5 / DT
    return ((2.0 * a) * u - (a - b) * utm1[sl, sl, sl] + lap) / (a + b)


def inplace_step_reference(ut, utm1, vp, damp, tgt, out_mode='fullz',
                           taps='full'):
    """The plain PyTorch version of ``inplace_step``: ``ref_step`` written
    into ``tgt`` as ``out_mode`` says."""
    n = _interior(ut)
    val = ref_step(ut, utm1, vp, damp, taps)
    sl = slice(H, H + n)
    if out_mode == 'fullz':
        tgt[sl] = 0.0
    tgt[sl, sl, sl] = val
    return tgt


# -- the probes ----------------------------------------------------------------

def p1_copy_roofline(n=N, device='cuda'):
    """P1: ``a + 1.0`` over an (n+16)^3 buffer; ms and GB/s read + write."""
    dev = device_for(device)
    NY = n + 2 * H
    x = torch.ones((NY, NY, NY), dtype=torch.float32, device=dev)
    ms = time_ms(lambda: x + 1.0, 10, dev)
    gbs = x.numel() * 4 * 2 / ms / 1e6
    print(f"P1 read+write full padded buffer: {ms:.3f} ms -> {gbs:.1f} GB/s")
    return {'ms': ms, 'gbs': gbs}


def p2_misaligned_dma(n=N, device='cuda'):
    """P2: K8 on the three windows of ``p2_windows(n)``; prints ms, the
    bytes through both copies per second as the JAX script counts them
    (global read, shared write, shared read, global write) and whether the
    window came back. Returns one record per window."""
    dev = device_for(device)
    NY = n + 2 * H
    src = torch.arange(NY * NY * NY, dtype=torch.float32,
                       device=dev).reshape(NY, NY, NY)
    res = []
    for label, window in p2_windows(n):
        out = window_copy(src, window)
        ms = time_ms(lambda: window_copy(src, window), 10, dev)
        sl = _window_slices(window)
        ok = bool(torch.equal(out[sl], src[sl]))
        nb = np.prod([k for _, k in window]) * 4 * 4
        print(f"P2 {label}: {ms:.3f} ms ({nb / ms / 1e6:.1f} GB/s) "
              f"correct={ok}")
        res.append({'label': label, 'ms': ms, 'gbs': nb / ms / 1e6,
                    'correct': ok})
    return res


def p3_inputs(n, device, seed=0):
    """P3's state: u[t] normal * 0.01 in the interior (numpy's generator
    ``seed``), u[t-1] = 0.95 u[t], vp 1.5, damping 0, a zero target."""
    NY = n + 2 * H
    ut = np.zeros((NY, NY, NY), np.float32)
    ut[H:H + n, H:H + n, H:H + n] = (
        np.random.default_rng(seed).standard_normal((n, n, n)) * 0.01)
    ut = torch.from_numpy(ut).to(device)
    return (ut, ut * 0.95, torch.full_like(ut, 1.5), torch.zeros_like(ut),
            torch.zeros_like(ut))


def p3_kernel(t0, n=N, device='cuda'):
    """P3: K9 for t0 and 2*t0 rows per tile and each tap ablation: one
    step against ``ref_step`` with the same taps (raises beyond TOL), then
    a 32-step loop with the buffers rotating as the TPU probe's does."""
    dev = device_for(device)
    ut, utm1, vp, damp, tgt = p3_inputs(n, dev)
    res = []
    for tt0 in (t0, 2 * t0):
        for taps in TAPS:
            label = f"t0={tt0} taps={taps}"
            want = ref_step(ut, utm1, vp, damp, taps)
            out = inplace_step(ut, utm1, vp, damp, tgt.clone(), tt0,
                               'fullz', taps)
            sl = slice(H, H + n)
            err = (out[sl, sl, sl] - want).abs().max().item()
            tol = TOL * want.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"P3 {label}: max|err| {err} > {tol}")
            bufs = [ut.clone(), utm1.clone(), tgt.clone()]

            def loop():
                a, b, t = bufs
                for _ in range(32):
                    t = inplace_step(a, b, vp, damp, t, tt0, 'fullz', taps)
                    a, b, t = t, a, b
                bufs[:] = a, b, t

            ms = time_ms(loop, 3, dev)
            gpts = n ** 3 * 32 / ms / 1e6
            print(f"P3 {label}: max|err|={err:.2e}  {gpts:.2f} GPts/s")
            res.append({'label': label, 'err': err, 'tol': tol,
                        'ms_step': ms / 32, 'gpts': gpts})
    return res


def main(t0=16, device='cuda', n=N):
    """P1, P2 and P3 at interior size ``n`` on ``device``."""
    dev = device_for(device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == 'cuda'
          else 'cpu')
    p1 = p1_copy_roofline(n, device)
    p2 = p2_misaligned_dma(n, device)
    p3 = p3_kernel(t0, n, device)
    return {'p1': p1, 'p2': p2, 'p3': p3}


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('t0', type=int, nargs='?', default=16)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--n', type=int, default=N,
                    help='interior size N (default 256)')
    a = ap.parse_args()
    main(a.t0, a.device, a.n)
