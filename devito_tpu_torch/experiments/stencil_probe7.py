"""Probe 7: the parts of an x-tiled step's cost on the card -- streamed
window copies (A, K10), arithmetic on resident windows (B, K11), an empty
launch (C, K12), and copy pipelines of depth 2 (D, K13) and d (E, K14)
inside one launch.

Ports ``experiments/stencil_probe7.py``. Buffers are (NY, NY, ZA) fp32
with NY = N + 16 (x-halo H = 8 rows per side) and, on the card, ZA = NY:
the JAX script's 384-lane z is a TPU layout. The functions take any
ZA >= NY, so that the same arrays can go through both packages.

- A: ``copy_windows`` walks the x-chunks of t0 rows of src[H:H+N] in
  order with nwin windows of each in flight and, with write-back, stores
  ``out[H:H+N] = src[H:H+N] + 1`` (``csrc/probe7_copy.cu``).
- B: ``resident_step`` computes probe_B's damped SO=8 update reps times
  over t0 x-rows of the N x N interior from constant windows held in
  shared memory (``csrc/probe7_resident.cu``); u may instead vary with
  position, so that the check sees the Laplacian. Its (8, 128) output
  holds the first x-row's update at the interior corner; the JAX kernel's
  output reads scratch rows it never writes.
- C: ``empty_grid`` launches reps CTAs, the last of which fills an
  (8, 128) output with reps - 1 (``csrc/probe7_empty.cu``).
- D, E: ``stream_windows`` streams the same chunks through a ring of
  ``depth`` slots in one launch and returns the sum, in x order, of row 0,
  y 0:8, z 0:128 of every chunk (``csrc/probe7_stream.cu``: one TMA box a
  window, fed by a producer warp through full and empty barriers, on the
  tile of ``stream_tile``); D is E at depth 2.

Each probe holds its kernel against the plain version (raising on a
difference), times REPS calls and prints the JAX script's line -- for A,
D and E the GB/s of the script's byte count, which counts every window --
beside the rate of the unique bytes (src read once, out written once), the
share of the bound on the card, the tile and the CTAs per SM.

    python -m devito_tpu_torch.experiments.stencil_probe7 A [t0 nwin wb|nowb [nsplit]]
    python -m devito_tpu_torch.experiments.stencil_probe7 B [none|z|full]
    python -m devito_tpu_torch.experiments.stencil_probe7 C
    python -m devito_tpu_torch.experiments.stencil_probe7 D [t0 nwin]
    python -m devito_tpu_torch.experiments.stencil_probe7 E [t0 nwin depth]

each with ``[--device cuda|cpu] [--n N] [--za ZA]``.
"""

import argparse
import ctypes

import numpy as np
import torch

from . import bound_ms, device_for, time_ms
from ..kernels import _nvcc

__all__ = ['copy_windows', 'copy_windows_reference', 'resident_step',
           'resident_step_reference', 'resident_update', 'u_window',
           'empty_grid', 'empty_launcher',
           'empty_grid_reference', 'stream_windows',
           'stream_windows_reference', 'stream_needs', 'window_tile',
           'stream_tiles', 'stream_tile', 'stream_occupancy', 'resident_tile',
           'inputs', 'probe_A', 'probe_B', 'probe_C', 'probe_D', 'probe_E',
           'main']

N = 256
H = 8          # x-halo rows per side
R = 4          # stencil radius (SO=8 second derivative)
NY = N + 2 * H
W = [-205.0 / 72, 8.0 / 5, -1.0 / 5, 8.0 / 315, -1.0 / 560]
TAPS = ('none', 'z', 'full')
#: probe_B's window fills: u, u1, vp, damp.
FILLS = (0.01, 0.01, 1.5, 0.0)
#: Fills and u's variation with position (``resident_step``'s ``vary``)
#: under which the Laplacian outweighs the other terms: a = 100 / vp^2 is
#: small, so the update is 2 u - u1 + 9 lap.
VARIED = ((1.0, 0.5, 30.0, 0.0), 1.0)
#: fp32 operations of probe_B's update per point, by taps: the Laplacian's
#: 1, plus 3 ('z') or 7 ('full') for each k = 1..4, and 13 for the rest.
FLOPS = {'none': 14, 'z': 26, 'full': 42}
OUT = (8, 128)  # the output tile of B, C, D and E
REPS = 24       # timed calls of A, B, D, E: the JAX script's 3 loops of 8
LOOP = 64       # calls in one of C's timed loops, as in the JAX script
TOL = 1e-5      # times max |plain|: K11's fp32 update in another order
DEPTHS = range(1, 9)

#: K10 (window copy) kernel launches.
copy_launches = 0
#: K11 (resident step) kernel launches.
resident_launches = 0
#: K12 (empty grid) kernel launches.
empty_launches = 0
#: K13 and K14 (window stream) kernel launches, by pipeline depth.
stream_launches = {}

_SMEM = 232448     # bytes of shared memory a block may use on Hopper
_SM_SMEM = 233472  # bytes of shared memory of one SM
_CTA_SMEM = 1024   # bytes the runtime keeps for each resident CTA
_THREADS = 256     # threads of a K10 CTA
_TZ = 64           # z extent of its tiles
#: Threads of a K13/K14 CTA: four consumer warps, one output column a
#: thread, and the producer warp.
_STREAM_THREADS = 160
#: Shared bytes of a K13/K14 CTA besides its ring: alignment slack and the
#: full and empty barriers (``smem_bytes`` in csrc/probe7_stream.cu).
_STREAM_FIXED = 256
#: The (TY, TZ) tiles K13/K14 may take.
STREAM_TYS = (1, 2, 4, 8)
STREAM_TZS = (64, 128, 256)
_K11_TZ = 32       # z extent of a K11 tile


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'


def _ctas_per_sm(smem, threads):
    """CTAs of ``threads`` threads using ``smem`` bytes of shared memory
    that fit on one SM (registers not counted)."""
    return min(_SM_SMEM // (smem + _CTA_SMEM), 2048 // threads)


def _pick(what, fits, threads):
    fits = [(ty, b) for ty, b in fits if b <= _SMEM]
    if not fits:
        raise ValueError(f"the {what} kernel's windows do not fit in "
                         f"{_SMEM} bytes of shared memory")
    ty, b = next(((ty, b) for ty, b in fits
                  if _ctas_per_sm(b, threads(ty)) >= 2), fits[0])
    return ty, b, _ctas_per_sm(b, threads(ty))


def window_tile(slots, nwin, t0):
    """The (TY, 64) tile of K10, K13 and K14 for a ring of ``slots`` slots
    of nwin windows of t0 rows: the largest TY of 4, 2 and 1 that lets two
    CTAs share an SM, else the largest that fits one. Returns (TY, shared
    bytes, CTAs per SM); raises when no tile fits."""
    return _pick('window', [(ty, 4 * slots * nwin * t0 * ty * _TZ)
                            for ty in (4, 2, 1)], lambda ty: _THREADS)


def stream_tiles(depth, nwin, t0):
    """Every (TY, TZ) tile of K13/K14 whose ring of ``depth`` slots of nwin
    windows of (t0, TY, TZ) fp32 fits a block's shared memory, as
    ((TY, TZ), shared bytes, CTAs per SM (registers not counted)), fewest
    bytes a CTA first, then the wider TZ."""
    tiles = [((ty, tz), _STREAM_FIXED + 4 * depth * nwin * t0 * ty * tz)
             for ty in STREAM_TYS for tz in STREAM_TZS]
    return [(tile, b, _ctas_per_sm(b, _STREAM_THREADS)) for tile, b in
            sorted(tiles, key=lambda t: (t[1], -t[0][1])) if b <= _SMEM]


def stream_tile(depth, nwin, t0):
    """The (TY, TZ) tile of K13/K14 for a ring of ``depth`` slots of nwin
    windows of t0 rows: the first of ``stream_tiles``, (1, 64), which lets
    the most CTAs share an SM: in chip_smoke.py's sweep of every tile at
    N=512, t0 16, nwin 1 and 4, depths 2-4, it was the fastest or within
    4 % of it (PERF.md §6). Returns ((TY, TZ), shared bytes, CTAs per SM);
    raises when no tile fits."""
    fits = stream_tiles(depth, nwin, t0)
    if not fits:
        raise ValueError(f"the window-stream kernel's windows do not fit in "
                         f"{_SMEM} bytes of shared memory")
    return fits[0]


def _stream_fit(depth, nwin, t0, tile):
    """``stream_tile``'s record of the given tile; raises when it is not
    one of K13/K14's tiles or does not fit."""
    if tile is None:
        return stream_tile(depth, nwin, t0)
    fit = next((f for f in stream_tiles(depth, nwin, t0) if f[0] == tile),
               None)
    if fit is None:
        raise ValueError(f"tile {tile}: expected (TY, TZ) with TY in "
                         f"{STREAM_TYS} and TZ in {STREAM_TZS} whose ring "
                         f"fits in {_SMEM} bytes of shared memory")
    return fit


def resident_tile(t0):
    """The (TY, 32) tile of K11 for t0 x-rows: windows u (t0+8, TY+8, 40)
    and u1, vp, damp (t0, TY, 32); the largest TY of 8, 4, 2 and 1 that
    lets two CTAs share an SM, else the largest that fits one. Returns
    (TY, shared bytes, CTAs per SM); raises when no tile fits."""
    zp = _K11_TZ + 2 * R
    return _pick('resident-step',
                 [(ty, 4 * ((t0 + 2 * R) * (ty + 2 * R) * zp
                            + 3 * t0 * ty * _K11_TZ)) for ty in (8, 4, 2, 1)],
                 lambda ty: ty * _K11_TZ)


def _buffer(what, src):
    """N of the (N+16, N+16, ZA) fp32 buffer ``src``; raises on another."""
    if not isinstance(src, torch.Tensor) or src.dtype != torch.float32 \
            or src.dim() != 3 or not src.is_contiguous():
        raise TypeError(f"the {what} takes a contiguous 3-D fp32 tensor")
    ny, za = src.shape[0], src.shape[2]
    n = ny - 2 * H
    if n < 1 or src.shape[1] != ny or za < ny:
        raise ValueError(f"buffer shape {tuple(src.shape)}: expected "
                         f"(N+16, N+16, ZA) with ZA >= N+16")
    if src.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"no {what} kernel for device {src.device}")
    return n


def _chunks(n, t0, nwin):
    if t0 < 1 or n % t0:
        raise ValueError(f"t0={t0} does not divide N={n}")
    if nwin < 1:
        raise ValueError(f"nwin={nwin}: expected at least one window")


def _on_card(what, src):
    if src.shape[2] % 4 or src.data_ptr() % 16:
        raise ValueError(f"the {what} kernel needs ZA % 4 == 0 and a 16-byte "
                         f"aligned tensor")


# -- K10: streamed window copies -------------------------------------------------

def copy_windows(src, t0=16, nwin=4, writeback=True, nsplit=1):
    """K10: a new buffer shaped like ``src`` whose rows [H, H+N) hold
    src + 1 when ``writeback``; its x-halo rows, and without write-back all
    of it, are left unset, as in the TPU probe. The kernel walks the
    x-chunks of t0 rows in order, the next chunk's nwin windows in flight,
    each window's copy issued in nsplit row blocks. CUDA tensors go through
    the kernel; CPU tensors through ``copy_windows_reference``."""
    global copy_launches
    n = _buffer('window-copy', src)
    _chunks(n, t0, nwin)
    if nsplit < 1 or t0 % nsplit:
        raise ValueError(f"nsplit={nsplit} does not divide t0={t0}")
    if src.device.type == 'cpu':
        return copy_windows_reference(src, t0, nwin, writeback, nsplit)
    _on_card('window-copy', src)
    ty, _, _ = window_tile(2, nwin, t0)
    out = torch.empty_like(src)
    fn = _nvcc.entry('probe7_copy', 'dtpu_probe7_copy_launch',
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p])
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), out.data_ptr(), src.shape[0], src.shape[2],
                n, t0, nwin, nsplit, int(bool(writeback)),
                ty.bit_length() - 1, _stream(src.device))
    _nvcc.check_launch(rc, "window-copy kernel")
    copy_launches += 1
    return out


def copy_windows_reference(src, t0=16, nwin=4, writeback=True, nsplit=1):
    """The plain PyTorch version of ``copy_windows`` (its result does not
    depend on t0, nwin or nsplit)."""
    n = _buffer('window-copy', src)
    out = torch.empty_like(src)
    if writeback:
        out[H:H + n] = src[H:H + n] + 1.0
    return out


# -- K11: the update on resident windows -----------------------------------------

def _resident_args(t0, reps, taps, fills, n):
    """Checks the arguments of K11; returns its fills as floats."""
    if taps not in TAPS:
        raise ValueError(f"taps {taps!r}: expected one of {TAPS}")
    if t0 < 1 or reps < 1 or n < 1:
        raise ValueError(f"t0={t0}, reps={reps}, n={n}: expected positive")
    if len(fills) != 4:
        raise ValueError("fills: expected the four values u, u1, vp, damp")
    return [float(f) for f in fills]


def resident_step(t0=16, reps=16, taps='full', fills=FILLS, n=N,
                  device='cuda', vary=0.0):
    """K11: probe_B's update computed ``reps`` times over t0 x-rows of the
    n x n interior, from windows holding the constant ``fills`` (u, u1, vp,
    damp) -- u times ``1 + vary * pattern`` (``u_window``) when vary is
    not 0. Returns an (8, 128) fp32 tensor of zeros whose [:min(8, n),
    :min(128, n)] holds the first x-row's update at the interior corner (y
    and z from H). On a CUDA device the kernel computes it from shared
    memory, reading nothing from device memory; on the CPU
    ``resident_step_reference`` does."""
    global resident_launches
    fills = _resident_args(t0, reps, taps, fills, n)
    dev = torch.device(device)
    if dev.type == 'cpu':
        return resident_step_reference(t0, reps, taps, fills, n, vary=vary)
    if dev.type != 'cuda':
        raise ValueError(f"no resident-step kernel for device {dev}")
    ty, _, _ = resident_tile(t0)
    ctas = -(-n // _K11_TZ) * -(-n // ty)
    out = torch.empty(OUT, dtype=torch.float32, device=dev)
    sink = torch.empty(ctas * ty * _K11_TZ, dtype=torch.float32, device=dev)
    f = (ctypes.c_float * 4)(*fills)
    fn = _nvcc.entry('probe7_resident', 'dtpu_probe7_resident_launch',
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(out.data_ptr(), sink.data_ptr(), n, t0, reps,
                TAPS.index(taps), ty, f, float(vary), _stream(out.device))
    _nvcc.check_launch(rc, "resident-step kernel")
    resident_launches += 1
    return out


def resident_update(ut, u1, vp, dp, taps='full'):
    """probe_B's update (``stencil_probe7.py:136-156``, DT = 0.1, h = 10)
    at the points of ``ut`` at least R from its edges: ut (X+8, Y+8, Z+8);
    u1, vp, dp (X, Y, Z). Returns (X, Y, Z)."""
    X, Y, Z = u1.shape

    def at(dx, dy, dz):
        return ut[R + dx:R + dx + X, R + dy:R + dy + Y, R + dz:R + dz + Z]

    u = at(0, 0, 0)
    lap = (3.0 * W[0]) * u
    if taps != 'none':
        for k in range(1, R + 1):
            terms = at(0, 0, k) + at(0, 0, -k)
            if taps == 'full':
                terms = (terms + at(k, 0, 0) + at(-k, 0, 0) + at(0, k, 0)
                         + at(0, -k, 0))
            lap = lap + W[k] * terms
    lap = lap * (1.0 / 100.0)
    m = 1.0 / (vp * vp)
    a = m * 100.0
    b = dp * 5.0
    return ((2.0 * a) * u - (a - b) * u1 + lap) / (a + b)


def u_window(shape, fu, vary=0.0, device='cpu'):
    """K11's u window of ``shape`` (x, y, z): fu * (1 + vary * ((7 x +
    13 y + 29 z) mod 17)) in fp32, each operation rounded on its own as the
    kernel rounds it; fu everywhere when vary is 0."""
    x, y, z = (torch.arange(s, device=device).view(
        [-1 if a == i else 1 for a in range(3)]) for i, s in enumerate(shape))
    p = ((7 * x + 13 * y + 29 * z) % 17).to(torch.float32)
    return (torch.tensor(fu, dtype=torch.float32, device=device)
            * (1.0 + torch.tensor(vary, dtype=torch.float32, device=device)
               * p))


def resident_step_reference(t0=16, reps=16, taps='full', fills=FILLS, n=N,
                            device='cpu', vary=0.0):
    """The plain PyTorch version of ``resident_step``: the update of t0
    x-rows of the n x n interior from its windows, ``reps`` times as the
    TPU grid computes it, the output taken from the last."""
    fu, f1, fv, fd = _resident_args(t0, reps, taps, fills, n)
    ut = u_window((t0 + 2 * R, n + 2 * R, n + 2 * R), fu, vary, device)
    rest = [torch.full((t0, n, n), f, dtype=torch.float32, device=device)
            for f in (f1, fv, fd)]
    for _ in range(reps):
        val = resident_update(ut, *rest, taps)
    out = torch.zeros(OUT, dtype=torch.float32, device=device)
    ny, nz = min(OUT[0], n), min(OUT[1], n)
    out[:ny, :nz] = val[0, :ny, :nz]
    return out


# -- K12: the empty grid ---------------------------------------------------------

def empty_grid(reps=16, device='cuda'):
    """K12: one launch of ``reps`` CTAs, the last of which fills an (8, 128)
    fp32 tensor with reps - 1: what the TPU grid's in-order steps leave. On
    the CPU ``empty_grid_reference``."""
    global empty_launches
    if reps < 1:
        raise ValueError(f"reps={reps}: expected at least one step")
    dev = torch.device(device)
    if dev.type == 'cpu':
        return empty_grid_reference(reps)
    if dev.type != 'cuda':
        raise ValueError(f"no empty-grid kernel for device {dev}")
    out = torch.empty(OUT, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = empty_launcher()(out.data_ptr(), reps, _stream(out.device))
    _nvcc.check_launch(rc, "empty-grid kernel")
    empty_launches += 1
    return out


def empty_launcher():
    """K12's C entry point, ``(out pointer, reps, stream) -> cudaError_t``,
    built on first use: what ``empty_grid`` calls, without its Python."""
    return _nvcc.entry('probe7_empty', 'dtpu_probe7_empty_launch',
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def empty_grid_reference(reps=16, device='cpu'):
    """The plain PyTorch version of ``empty_grid``."""
    return torch.full(OUT, float(reps - 1), dtype=torch.float32,
                      device=device)


# -- K13, K14: read pipelines in one launch --------------------------------------

def stream_windows(src, t0=16, nwin=4, depth=3, tile=None):
    """K13 (depth 2) and K14: the (8, 128) sum, in x order, of
    src[H + i t0, 0:8, 0:128] over the x-chunks i of src[H:H+N]. The kernel
    streams every chunk's nwin windows, one TMA box each, through a ring of
    ``depth`` slots, depth - 1 chunks in flight beyond the one waited for,
    on ``tile`` (TY, TZ) or, by default, ``stream_tile``'s. CUDA tensors go
    through the kernel; CPU tensors through ``stream_windows_reference``."""
    n = _buffer('window-stream', src)
    _chunks(n, t0, nwin)
    if depth not in DEPTHS:
        raise ValueError(f"depth={depth}: expected {DEPTHS.start} to "
                         f"{DEPTHS.stop - 1}")
    if src.shape[2] < OUT[1]:
        raise ValueError(f"ZA={src.shape[2]}: the output tile is z 0:128")
    if src.device.type == 'cpu':
        if tile is not None:
            _stream_fit(depth, nwin, t0, tile)
        return stream_windows_reference(src, t0, nwin, depth)
    _on_card('window-stream', src)
    (ty, tz), _, _ = _stream_fit(depth, nwin, t0, tile)
    out = torch.empty(OUT, dtype=torch.float32, device=src.device)
    fn = _nvcc.entry('probe7_stream', 'dtpu_probe7_stream_launch',
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p])
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), out.data_ptr(), src.shape[0], src.shape[2],
                n, t0, nwin, depth, ty, tz, _stream(src.device))
    _nvcc.check_launch(rc, "window-stream kernel")
    stream_launches[depth] = stream_launches.get(depth, 0) + 1
    return out


def stream_occupancy(t0=16, nwin=4, depth=3, tile=None, device='cuda'):
    """The CTAs of K13/K14 on ``tile`` (default ``stream_tile``'s) that fit
    on one SM of ``device``, as the CUDA runtime counts them from the
    kernel's registers, shared memory and threads."""
    (ty, tz), _, _ = _stream_fit(depth, nwin, t0, tile)
    fn = _nvcc.entry('probe7_stream', 'dtpu_probe7_stream_occupancy',
                     [ctypes.c_int] * 5 + [ctypes.c_void_p])
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(nwin, t0, depth, ty, tz, ctypes.addressof(ctas))
    _nvcc.check_launch(rc, "window-stream occupancy query")
    return ctas.value


def stream_needs(n, t0):
    """The bytes and fp32 additions ``stream_windows``'s result needs: the
    (8, 128) tile of each of the n / t0 chunks read once, the sum written
    once -- not the n (n+16) ZA floats the kernel streams."""
    tile, chunks = OUT[0] * OUT[1], n // t0
    return 4 * tile * (chunks + 1), tile * chunks


def stream_windows_reference(src, t0=16, nwin=4, depth=3):
    """The plain PyTorch version of ``stream_windows``: the reference's
    accumulator loop, in the same order."""
    n = _buffer('window-stream', src)
    acc = torch.zeros(OUT, dtype=torch.float32, device=src.device)
    for i in range(n // t0):
        acc = acc + src[H + i * t0, :OUT[0], :OUT[1]]
    return acc


# -- the probes ------------------------------------------------------------------

def inputs(n=N, za=None, seed=0, device='cuda'):
    """An (n+16, n+16, za) fp32 buffer, standard normal from numpy's
    generator ``seed``; za defaults to n + 16."""
    ny = n + 2 * H
    a = np.random.default_rng(seed).standard_normal(
        (ny, ny, za or ny)).astype(np.float32)
    return torch.from_numpy(a).to(device)


def _rates(dev, ms, agg, uniq, need, flops, tile, ctas):
    """The record of a copy probe and the text after its script line: the
    rates of the script's byte count ``agg`` and of the ``uniq`` bytes the
    kernel streams from device memory once, the bound of those bytes
    (``stream_*``), and the bound of the ``need`` bytes and ``flops`` that
    the probe's result needs (``bound_ms``, ``share``)."""
    on_card = dev.type == 'cuda'
    bms, by = bound_ms(need, flops)
    sms = bound_ms(uniq, 0)[0]
    rec = {'ms': ms, 'gbs_agg': agg / ms / 1e6, 'gbs_unique': uniq / ms / 1e6,
           'bytes_agg': agg, 'bytes_unique': uniq, 'stream_bound_ms': sms,
           'stream_share': sms / ms if on_card else None,
           'bytes_needed': need, 'bound_ms': bms, 'bound_by': by,
           'share': bms / ms if on_card else None, 'tile': tile,
           'ctas_per_sm': ctas, 'device': _name(dev)}
    text = f"{rec['gbs_unique']:.0f} GB/s unique of {uniq / 1e6:.1f} MB"
    if on_card:
        text += (f", {100 * rec['stream_share']:.1f} % of the bound of the "
                 f"streamed bytes ({sms:.4f} ms)")
        if need != uniq:
            text += (f"; the result's own bound {bms:.6f} ms ({by}) = "
                     f"{100 * rec['share']:.3f} %")
    return rec, text + f"; tile {tile}, {ctas} CTAs/SM on {rec['device']}"


def probe_A(t0=16, nwin=4, writeback=True, nsplit=1, n=N, za=None,
            device='cuda'):
    """The JAX script's probe A on K10: the kernel against its plain
    version (interior rows equal to the bit), then REPS calls, each fed
    the last one's output, timed."""
    dev = device_for(device)
    src = inputs(n, za, device=dev)
    ny, za = src.shape[0], src.shape[2]
    got = copy_windows(src, t0, nwin, writeback, nsplit)
    if writeback and not torch.equal(
            got[H:H + n], copy_windows_reference(src)[H:H + n]):
        raise AssertionError("K10 wrote other interior rows than its plain "
                             "version")
    x = [src]

    def step():
        x[0] = copy_windows(x[0], t0, nwin, writeback, nsplit)

    ms = time_ms(step, REPS, dev)
    S = n * ny * za * 4
    ty, _, ctas = window_tile(2, nwin, t0)
    uniq = (1 + bool(writeback)) * S
    rec, text = _rates(dev, ms, (nwin + 2 * bool(writeback)) * S, uniq, uniq,
                       bool(writeback) * S // 4, (ty, _TZ), ctas)
    print(f"A t0={t0} nwin={nwin} wb={bool(writeback)} nsplit={nsplit}: "
          f"{ms:.4f} ms/step -> {rec['gbs_agg']:.0f} GB/s agg DMA; {text}",
          flush=True)
    return dict(rec, probe='A', t0=t0, nwin=nwin, writeback=bool(writeback),
                nsplit=nsplit, n=n, za=za)


def probe_B(t0=16, reps=16, taps='full', n=N, device='cuda'):
    """The JAX script's probe B on K11: the kernel against its plain
    version (within TOL), then REPS calls timed; reps x t0 x n x n points
    a call (one virtual step of n^3 when reps = n / t0)."""
    dev = device_for(device)
    got = resident_step(t0, reps, taps, FILLS, n, dev)
    want = resident_step_reference(t0, reps, taps, FILLS, n, dev)
    err = (got - want).abs().max().item()
    tol = TOL * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"K11 taps={taps}: max|kernel - plain| {err} > "
                             f"{tol}")
    ms = time_ms(lambda: resident_step(t0, reps, taps, FILLS, n, dev), REPS,
                 dev)
    pts = t0 * n * n * reps
    flops = FLOPS[taps] * pts
    bms, by = bound_ms(4 * OUT[0] * OUT[1], flops)
    ty, _, ctas = resident_tile(t0)
    share = bms / ms if dev.type == 'cuda' else None
    print(f"B t0={t0} taps={taps}: {ms:.4f} ms/virtual-step -> "
          f"{pts / ms / 1e6:.1f} GPts/s compute-only; "
          f"{flops / ms / 1e9:.2f} TFLOP/s"
          + (f", {100 * share:.1f} % of the bound ({bms:.4f} ms, {by})"
             if share is not None else '')
          + f"; max|kernel - plain| {err:.2e}; tile ({ty}, {_K11_TZ}), "
          f"{ctas} CTAs/SM on {_name(dev)}", flush=True)
    return {'probe': 'B', 't0': t0, 'reps': reps, 'taps': taps, 'n': n,
            'ms': ms, 'gpts': pts / ms / 1e6, 'tflops': flops / ms / 1e9,
            'bound_ms': bms, 'bound_by': by, 'share': share, 'err': err,
            'tol': tol, 'tile': (ty, _K11_TZ), 'ctas_per_sm': ctas,
            'device': _name(dev)}


def probe_C(reps=16, device='cuda'):
    """The JAX script's probe C on K12: the kernel against its plain
    version, then LOOP calls each added to a carry, as the JAX loop does,
    and LOOP bare launches, each loop timed 3 times; microseconds per
    call."""
    dev = device_for(device)
    if not torch.equal(empty_grid(reps, dev), empty_grid_reference(reps,
                                                                    dev)):
        raise AssertionError(f"K12 did not leave {reps - 1}")
    carry = torch.zeros(OUT, dtype=torch.float32, device=dev)

    def added():
        acc = carry
        for _ in range(LOOP):
            acc = empty_grid(reps, dev) + acc

    def bare():
        for _ in range(LOOP):
            empty_grid(reps, dev)

    us = time_ms(added, 3, dev) / LOOP * 1e3
    bare_us = time_ms(bare, 3, dev) / LOOP * 1e3
    print(f"C: {us:.1f} us per {reps}-CTA launch and add, {bare_us:.1f} us "
          f"per bare launch on {_name(dev)}", flush=True)
    return {'probe': 'C', 'reps': reps, 'us': us, 'us_bare': bare_us,
            'device': _name(dev)}


def _stream_probe(head, t0, nwin, depth, n, za, device):
    dev = device_for(device)
    src = inputs(n, za, device=dev)
    ny, za = src.shape[0], src.shape[2]
    if not torch.equal(stream_windows(src, t0, nwin, depth),
                       stream_windows_reference(src, t0, nwin, depth)):
        raise AssertionError(f"K13/K14 at depth {depth} differs from its "
                             f"plain version")
    ms = time_ms(lambda: stream_windows(src, t0, nwin, depth), REPS, dev)
    S = n * ny * za * 4
    tile, _, ctas = stream_tile(depth, nwin, t0)
    rec, text = _rates(dev, ms, nwin * S, S + 4 * OUT[0] * OUT[1],
                       *stream_needs(n, t0), tile, ctas)
    print(f"{head}: {ms:.4f} ms/step -> {rec['gbs_agg']:.0f} GB/s agg DMA; "
          f"{text}", flush=True)
    return dict(rec, probe=head[0], t0=t0, nwin=nwin, depth=depth, n=n,
                za=za)


def probe_D(t0=16, nwin=4, n=N, za=None, device='cuda'):
    """The JAX script's probe D on K13: E at depth 2."""
    return _stream_probe(f"D t0={t0} nwin={nwin}", t0, nwin, 2, n, za,
                         device)


def probe_E(t0=16, nwin=4, depth=3, n=N, za=None, device='cuda'):
    """The JAX script's probe E on K14: the kernel against its plain
    version (equal to the bit), then REPS calls timed."""
    return _stream_probe(f"E t0={t0} nwin={nwin} depth={depth}", t0, nwin,
                         depth, n, za, device)


def _probe_args(which, args):
    """The keyword arguments of probe ``which`` from the JAX script's
    positional form (every argument optional here)."""
    forms = {'A': ('t0', 'nwin', 'writeback', 'nsplit'), 'B': ('taps',),
             'C': (), 'D': ('t0', 'nwin'), 'E': ('t0', 'nwin', 'depth')}
    if which not in forms:
        raise ValueError(f"probe {which!r}: expected one of A, B, C, D, E")
    if len(args) > len(forms[which]):
        raise ValueError(f"probe {which} takes at most "
                         f"{len(forms[which])} arguments: "
                         f"{' '.join(forms[which])}")
    kw = {}
    for name, a in zip(forms[which], args):
        if name == 'writeback':
            if a not in ('wb', 'nowb'):
                raise ValueError(f"{a!r}: expected wb or nowb")
            kw[name] = a == 'wb'
        elif name == 'taps':
            if a not in TAPS:
                raise ValueError(f"taps {a!r}: expected one of {TAPS}")
            kw[name] = a
        else:
            kw[name] = int(a)
    return kw


def main(which='C', *args, device='cuda', n=N, za=None):
    """Probe ``which`` with the JAX script's positional ``args`` (strings)
    at interior size ``n`` (and ZA ``za``, default n + 16) on ``device``;
    returns its record."""
    kw = _probe_args(which, args)
    if which in 'ADE':
        kw.update(n=n, za=za)
    elif which == 'B':
        kw.update(n=n)
    probe = {'A': probe_A, 'B': probe_B, 'C': probe_C, 'D': probe_D,
             'E': probe_E}[which]
    return probe(device=device, **kw)


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('which', nargs='?', default='C', choices=list('ABCDE'))
    ap.add_argument('args', nargs='*',
                    help="A: t0 nwin wb|nowb [nsplit]; B: taps; D: t0 nwin; "
                         "E: t0 nwin depth")
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--n', type=int, default=N,
                    help='interior size N (default 256)')
    ap.add_argument('--za', type=int, default=None,
                    help='z allocation ZA >= N + 16 (default N + 16)')
    a = ap.parse_args()
    main(a.which, *a.args, device=a.device, n=a.n, za=a.za)
