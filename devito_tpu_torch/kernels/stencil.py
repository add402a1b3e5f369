"""K1: the dense-stencil update, as a CUDA C++ kernel for Hopper.

Ports ``experiments/pallas_backend.py`` (``plan_for``/``_plan_for``,
``_TileCtxV2``, ``execute_plan``). ``plan_for`` decides at build time,
from the equation's shape alone, whether a lowered dense equation can run
in the kernel; ``stencil_update`` runs one update of the target's time row
in place; ``stencil_update_reference`` is its plain PyTorch version.

The kernel's source is ``csrc/stencil.cuh`` (the hand-written template:
indexing, bounds mask, 64-bit offsets, store) plus one point expression
printed from the equation's right-hand side by ``compiler.translate.
cuda_expr``. At its first CUDA launch the combined source is written to
``devito_tpu_torch/_build/`` under the hash of its text and the nvcc
flags, compiled with nvcc into a shared library and loaded with ctypes
(``kernels/_nvcc.py``). Parameters (dt, spacings, Constants), row
pointers, strides and region extents are runtime arguments, so no value
and no grid size is baked into a build: ``apply(dt=...)`` never rebuilds,
and offsets follow each function's actual halo at every launch.

K2, the self-test (``validate_backend``, kernel ``csrc/selftest.cu``),
ports ``experiments/pallas_backend.py`` ``validate_backend``: before the
first K1 launch of a process on a device it runs a miniature kernel of
the same data movement and raises on a wrong answer.
"""

import ctypes
import re
from collections import OrderedDict

import numpy as np
import sympy
import torch

from . import _nvcc
from ._nvcc import build_seconds, build_log, check_launch  # noqa: F401
from ..compiler.translate import translate, cuda_expr
from ..exceptions import CompilationError, InvalidOperator
from ..ir.lowering import time_access_of, space_offsets_of
from ..logger import debug
from ..types.basic import AbstractFunction, retrieve_functions
from ..types.dense import torch_dtype
from ..types.dimension import Dimension

__all__ = ['StencilPlan', 'plan_for', 'build', 'point_flops',
           'stencil_update', 'stencil_update_reference', 'validate_backend',
           'selftest_window_sum', 'selftest_window_sum_reference']

#: Kernel launches since import (or since the caller last reset it).
launches = 0
#: Equations ``plan_for`` declined since import.
declines = 0
#: Self-test kernel (K2) launches.
selftest_launches = 0
#: Self-tests run (``validate_backend``), passed or not.
selftests = 0
#: Devices whose self-test passed in this process; a device taken out
#: is self-tested again before its next kernel launch.
validated = set()

_CTYPE = {np.dtype(np.float32): 'float', np.dtype(np.float64): 'double'}


class StencilPlan:
    """What the kernel needs to know about one dense equation.

    ``groups``: one entry per (function, time access) read by the
    right-hand side, in first-read order: ``{'fn', 'tk', 'toff', 'key'}``.
    ``source``: the generated CUDA translation unit.
    """

    def __init__(self, eq, groups, param_names, source):
        self.eq = eq
        self.groups = groups
        self.param_names = param_names
        self.source = source
        self.dtype = np.dtype(eq.target.dtype)
        self.ndim = len(eq.region)
        self.extents = tuple(b - a for a, b in eq.region)
        # element offset, per axis, of the region's first point in each
        # row: the target's, then each group's
        self.origins = [_origin(eq, eq.target)] + [
            _origin(eq, g['fn']) for g in groups]
        self.key = _nvcc.source_key(
            (_nvcc._CSRC / 'stencil.cuh').read_text(), source)
        n = len(groups) + 1
        self._ptrs = (ctypes.c_void_p * n)()
        self._strides = (ctypes.c_longlong * (2 * n))()
        self._n = (ctypes.c_int * 3)(*(self.extents + (1,) * (3 - self.ndim)))
        self._params = (ctypes.c_double * max(len(param_names), 1))()


def _access_key(e):
    """The access group of a function access: (name, time kind, time
    offset)."""
    tk, toff = time_access_of(e)
    return (e.function.name, tk, str(toff))


def _origin(eq, fn):
    return tuple(hl + a - oo for (a, _), (hl, _), oo
                 in zip(eq.region, fn.halo, fn.origin_offset))


def _decline(eq, reason):
    global declines
    declines += 1
    debug(f"stencil kernel: {eq} runs in the torch translator ({reason})")
    return None


def plan_for(eq):
    """A StencilPlan for a lowered dense equation, or None (logged and
    counted in ``declines``) when the kernel cannot take it. The decision
    rests on the equation's shape only, as the TPU backend's did."""
    fn = eq.target
    if fn.grid is None:
        return _decline(eq, "target has no grid")
    if any(a < 0 for a, _ in eq.region):
        return _decline(eq, "halo-extended region")
    ndim = len(eq.region)
    if ndim not in (2, 3):
        return _decline(eq, f"{ndim}-D region")
    if eq.condition is not None or eq.reduction is not None or \
            eq.increment:
        return _decline(eq, "condition, reduction or increment")
    if np.dtype(fn.dtype) not in _CTYPE:
        return _decline(eq, f"dtype {np.dtype(fn.dtype)}")

    own = [d.root.name if d.is_Derived else d.name
           for d in fn.space_dimensions]
    groups = OrderedDict()
    for a in retrieve_functions(eq.rhs):
        f = a.function
        if f.is_SparseFunction:
            return _decline(eq, "sparse read")
        if np.dtype(f.dtype) != np.dtype(fn.dtype):
            return _decline(eq, f"mixed dtypes ({f.name})")
        dims = [d.root.name if d.is_Derived else d.name
                for d in f.space_dimensions]
        if dims != own:
            return _decline(eq, f"{f.name} is not indexed like the target")
        try:
            offs = space_offsets_of(a)
        except InvalidOperator:
            return _decline(eq, "absolute or non-affine index")
        tk, toff = time_access_of(a)
        if f.name == fn.name and not _distinct_rows(eq, tk, toff):
            # the kernel writes in place: a read of the written row
            # would see other threads' new values
            return _decline(eq, "reads its own written row")
        for (s, e), (hl, hr), oo, o, n in zip(
                eq.region, f.halo, f.origin_offset, offs,
                f._allocated_space()):
            if hl + s - oo + o < 0 or hl + e - oo + o > n:
                return _decline(eq, f"{a} reads outside its allocation")
        groups.setdefault(_access_key(a), {'fn': f, 'tk': tk, 'toff': toff,
                                           'key': _access_key(a)})

    params, coords = [], []

    def _scan(e):
        if isinstance(e, AbstractFunction):
            return
        if isinstance(e, Dimension) or (isinstance(e, sympy.Symbol)
                                        and e.name == '__loop_time__'):
            coords.append(e)
        elif isinstance(e, sympy.Symbol):
            params.append(e.name)
        for x in getattr(e, 'args', ()):
            _scan(x)

    _scan(sympy.sympify(eq.rhs))
    if coords:
        return _decline(eq, "coordinate-dependent right-hand side")
    groups = list(groups.values())
    param_names = sorted(set(params))
    try:
        source = _generate(eq, groups, param_names)
    except CompilationError as e:
        return _decline(eq, str(e))
    return StencilPlan(eq, groups, param_names, source)


def _distinct_rows(eq, tk, toff):
    """True when a read of the target at time access (tk, toff) provably
    touches another row than the one ``eq`` writes."""
    if tk != eq.time_kind or tk not in ('stepping', 'save', 'cond'):
        return False
    if tk == 'stepping':
        return (int(toff) - int(eq.time_off)) % eq.target._time_size != 0
    return int(toff) != int(eq.time_off)


class _CudaCtx:
    """cuda_expr context: accesses -> loads off the group's row pointer
    ``g[k]``; symbols -> kernel parameters ``a.p[i]``."""

    def __init__(self, groups, param_names, ctype):
        self.index = {g['key']: k for k, g in enumerate(groups)}
        self.params = {n: i for i, n in enumerate(param_names)}
        self.ctype = ctype

    def literal(self, v):
        s = repr(float(v))
        return s + 'f' if self.ctype == 'float' else s

    def symbol(self, sym):
        return f'a.p[{self.params[sym.name]}]'

    def access(self, e):
        k = self.index[_access_key(e)]
        offs = space_offsets_of(e)
        terms = [f'{o}LL * a.stride[{k}][{j}]'
                 for j, o in enumerate(offs[:-1]) if o]
        if offs[-1] or not terms:
            terms.append(f'{offs[-1]}')
        return f'DTPU_LD(g[{k}], {" + ".join(terms)})'


def _generate(eq, groups, param_names):
    """The CUDA translation unit of one equation: the template plus its
    point expression and a C entry point for ctypes."""
    ctype = _CTYPE[np.dtype(eq.target.dtype)]
    expr = cuda_expr(eq.rhs, _CudaCtx(groups, param_names, ctype))
    return f"""// Generated from: {eq!r}
#include "stencil.cuh"

using T = {ctype};
constexpr int NDIM = {len(eq.region)};
constexpr int NG = {len(groups)};
constexpr int NP = {len(param_names)};
using Args = dtpu::StencilArgs<T, NG, NP>;

struct Point {{
  static __device__ __forceinline__ T eval(const T* const* g, const Args& a) {{
    return {expr};
  }}
}};

extern "C" int dtpu_stencil_launch(void* const* ptrs, const long long* strides,
                                   const int* n, const double* params,
                                   void* stream) {{
  return dtpu::launch<T, NDIM, NG, NP, Point>(ptrs, strides, n, params,
                                              stream);
}}
"""


def build(plan):
    """The ctypes entry point of ``plan``'s kernel: compiled with nvcc
    into ``_build/`` and loaded at the first call, cached after."""
    fn = _nvcc.build(plan.key, 'stencil', plan.source).dtpu_stencil_launch
    # every pointer and the stream as c_void_p: a default int would cut
    # them to 32 bits
    fn.argtypes = [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def point_flops(plan):
    """Operations per point of ``plan``'s kernel: the binary +, -, * and /
    of its generated point expression, outside the loads' index
    arithmetic."""
    body = plan.source.split('return', 1)[1].split(';', 1)[0]
    body = re.sub(r'DTPU_LD\([^()]*\)', 'v', body)
    return sum(body.count(f' {op} ') for op in '+-*/')


def _check_rows(plan, rows):
    out, ins = rows
    if len(ins) != len(plan.groups):
        raise ValueError(f"{len(ins)} input rows for {len(plan.groups)} "
                         f"access groups")
    want = torch_dtype(plan.dtype)
    fns = [plan.eq.target] + [g['fn'] for g in plan.groups]
    for r, f in zip([out] + list(ins), fns):
        if not isinstance(r, torch.Tensor):
            raise TypeError(f"row of {f.name} is a {type(r).__name__}")
        if r.dtype != want:
            raise TypeError(f"row of {f.name} is {r.dtype}, the kernel "
                            f"was planned for {want}")
        if r.device != out.device:
            raise ValueError(f"row of {f.name} is on {r.device}, the "
                             f"target on {out.device}")
        if tuple(r.shape) != tuple(f._allocated_space()):
            raise ValueError(f"row of {f.name} has shape {tuple(r.shape)}; "
                             f"expected {f._allocated_space()}")
        if not r.is_contiguous():
            raise ValueError(f"row of {f.name} is not contiguous")


def stencil_update(plan, rows, params):
    """Write ``plan.eq``'s right-hand side over its region into the target
    row, in place. ``rows`` is ``(target row, [one row per group])``,
    each a halo'd row tensor of its function; ``params`` maps symbol names
    to values. CUDA tensors go through the kernel; CPU tensors through
    ``stencil_update_reference``."""
    global launches
    _check_rows(plan, rows)
    out, ins = rows
    if out.device.type == 'cpu':
        return stencil_update_reference(plan, rows, params)
    if out.device.type != 'cuda':
        raise ValueError(f"no stencil kernel for device {out.device}")
    if out.device not in validated:
        validate_backend(out.device)
    entry = build(plan)
    for i, (r, org) in enumerate(zip([out] + list(ins), plan.origins)):
        st = r.stride()
        plan._ptrs[i] = r.data_ptr() + r.element_size() * sum(
            o * s for o, s in zip(org, st))
        plan._strides[2 * i] = st[0]
        plan._strides[2 * i + 1] = st[1] if plan.ndim == 3 else 0
    for i, name in enumerate(plan.param_names):
        plan._params[i] = float(params[name])
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(ctypes.addressof(plan._ptrs),
                   ctypes.addressof(plan._strides),
                   ctypes.addressof(plan._n),
                   ctypes.addressof(plan._params), stream)
    check_launch(rc, f"stencil kernel for {plan.eq!r}")
    launches += 1


class _RowsCtx:
    """translate context over the plan's rows: an access is the group
    row's region window shifted by the access's offsets."""

    def __init__(self, plan, ins, params):
        self.plan = plan
        self.rows = {g['key']: (r, org) for g, r, org
                     in zip(plan.groups, ins, plan.origins[1:])}
        self.params = params

    def symbol(self, sym):
        if sym.name in self.params:
            return self.params[sym.name]
        raise CompilationError(f"Unbound symbol {sym.name}")

    def access(self, e):
        row, org = self.rows[_access_key(e)]
        return row[tuple(slice(s + o, s + o + n) for s, o, n in zip(
            org, space_offsets_of(e), self.plan.extents))]


def stencil_update_reference(plan, rows, params):
    """The plain PyTorch version of ``stencil_update``: the same
    right-hand side through the torch translator, over the same region,
    written into the same row."""
    out, ins = rows
    val = translate(plan.eq.rhs, _RowsCtx(plan, ins, params))
    dst = out[tuple(slice(s, s + n)
                    for s, n in zip(plan.origins[0], plan.extents))]
    dst.copy_(torch.as_tensor(val, dtype=out.dtype,
                              device=out.device).expand(dst.shape))


# -- K2: the self-test ------------------------------------------------------

_H, _T, _NZ, _ZP = 2, 4, 16, 128
#: The self-test's input shape; its output is (2T, T, ZP).
SELFTEST_SHAPE = (2 * _T + 2 * _H, _T + 2 * _H, _ZP)


def selftest_window_sum(x):
    """K2's computation on ``x`` of shape ``SELFTEST_SHAPE`` (fp32): for
    each of the 2 tiles i, the window ``w = x[i*T : i*T+T+2H, :T+2H]``
    gives ``w[H:-H, H:-H, H:H+NZ] + w[H+1:H+1+T, H:-H, H+1:H+1+NZ]``,
    zero-padded from NZ to ZP lanes; the tiles stack along axis 0 into a
    (2T, T, ZP) tensor. CUDA tensors go through the kernel
    (``csrc/selftest.cu``); CPU tensors through
    ``selftest_window_sum_reference``."""
    global selftest_launches
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or \
            tuple(x.shape) != SELFTEST_SHAPE or not x.is_contiguous():
        raise ValueError(f"the self-test takes a contiguous fp32 tensor of "
                         f"shape {SELFTEST_SHAPE}")
    if x.device.type == 'cpu':
        return selftest_window_sum_reference(x)
    if x.device.type != 'cuda':
        raise ValueError(f"no self-test kernel for device {x.device}")
    out = torch.empty((2 * _T, _T, _ZP), dtype=x.dtype, device=x.device)
    entry = _nvcc.entry('selftest', 'dtpu_selftest_launch',
                        [ctypes.c_void_p] * 3)
    with torch.cuda.device(x.device):
        rc = entry(x.data_ptr(), out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "self-test kernel")
    selftest_launches += 1
    return out


def selftest_window_sum_reference(x):
    """The plain PyTorch version of ``selftest_window_sum``."""
    out = x.new_zeros((2 * _T, _T, _ZP))
    for i in range(2):
        w = x[i * _T:i * _T + _T + 2 * _H, :_T + 2 * _H]
        out[i * _T:(i + 1) * _T, :, :_NZ] = (
            w[_H:-_H, _H:-_H, _H:_H + _NZ]
            + w[_H + 1:_H + 1 + _T, _H:-_H, _H + 1:_H + 1 + _NZ])
    return out


def validate_backend(device='cuda'):
    """Run the self-test on ``device`` and check its whole output: 2.0 on
    lanes [0, NZ) and 0 beyond, for ones in. Raises CompilationError on
    any other answer; returns True. ``stencil_update`` runs it once per
    process and device, before its first kernel launch there; each run
    adds one to ``selftests``."""
    global selftests
    x = torch.ones(SELFTEST_SHAPE, dtype=torch.float32,
                   device=torch.device(device))
    out = selftest_window_sum(x)
    selftests += 1
    want = torch.zeros((2 * _T, _T, _ZP), dtype=torch.float32)
    want[..., :_NZ] = 2.0
    got = out.cpu()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise CompilationError(
            f"the self-test kernel gave a wrong answer on {out.device}: "
            f"{bad} of {want.numel()} values differ from 2.0 on lanes "
            f"[0, {_NZ}) and 0 beyond (max |diff| "
            f"{(got - want).abs().max().item():.3e})")
    validated.add(out.device)
    return True
