"""Builds the port's CUDA translation units with nvcc and loads them.

A translation unit is compiled for ``sm_90a`` into a shared library with a
plain C interface under ``devito_tpu_torch/_build/``, named by a key that
hashes its text, the headers it depends on and ``_NVCC_FLAGS``, and loaded
with ctypes. A library that is already in ``_build/`` under its key is
loaded without compiling. ``build_seconds`` and ``build_log`` record, by
key, the seconds nvcc took and its ptxas resource report (registers,
spills), for every kernel of the package; while a profiler records, each
compile is the span ``dtpu::nvcc``.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..exceptions import CompilationError
from ..utils import span

__all__ = ['source_key', 'unit_key', 'headers', 'build', 'fixed',
           'fixed_key', 'entry', 'check_launch']

#: Seconds spent in nvcc, by build key.
build_seconds = {}
#: ptxas resource report (registers, spills), by build key.
build_log = {}

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / 'csrc'
_BUILD = _PKG / '_build'
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
_libs = {}
_locks = {}
_fixed = {}


def source_key(*texts):
    """The build key of a translation unit made of ``texts``."""
    return hashlib.sha256(
        (''.join(texts) + ' '.join(_NVCC_FLAGS)).encode()).hexdigest()[:20]


def headers(text):
    """The ``csrc/`` headers the translation unit ``text`` includes,
    directly or through another header, in include order."""
    seen = []

    def scan(t):
        for h in re.findall(r'#include "([^"]+)"', t):
            if h not in seen:
                seen.append(h)
                scan((_CSRC / h).read_text())

    scan(text)
    return seen


def unit_key(source):
    """The build key of the translation unit ``source``: every ``csrc/``
    header it includes, then its text, so that an edited header never
    reuses a stale library."""
    return source_key(*[(_CSRC / h).read_text() for h in headers(source)],
                      source)


def _nvcc():
    cands = [shutil.which('nvcc')]
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cands.append(os.path.join(home, 'bin', 'nvcc'))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise CompilationError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit's nvcc")


def build(key, stem, source):
    """The ctypes library of the translation unit ``source`` (its text,
    which may include headers of ``csrc/``), compiled with nvcc into
    ``_build/{stem}_{key}.so`` at the first call and cached after. Safe
    to call from several threads, for one key or many."""
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _locks.setdefault(key, threading.Lock()):
        lib = _libs.get(key)
        if lib is None:
            lib = _libs[key] = _compile(key, stem, source)
    return lib


def _compile(key, stem, source):
    so = _BUILD / f'{stem}_{key}.so'
    if not so.exists():
        nvcc = _nvcc()
        _BUILD.mkdir(parents=True, exist_ok=True)
        cu = _BUILD / f'{stem}_{key}.cu'
        cu.write_text(source)
        tmp = _BUILD / f'{stem}_{key}.{os.getpid()}.so'
        tic = time.perf_counter()
        with span('dtpu::nvcc'):
            res = subprocess.run(
                [nvcc, *_NVCC_FLAGS, '-I', str(_CSRC), '-o', str(tmp),
                 str(cu)], capture_output=True, text=True)
        if res.returncode != 0:
            raise CompilationError(
                f"nvcc failed on {cu}:\n{res.stderr[-4000:]}")
        os.replace(tmp, so)
        build_seconds[key] = time.perf_counter() - tic
        build_log[key] = res.stderr
    return ctypes.CDLL(str(so))


def fixed(name):
    """The ctypes library of ``csrc/{name}.cu``, keyed on its text and the
    ``csrc/`` headers it includes (``unit_key``)."""
    hit = _fixed.get(name)
    if hit is None:
        source = (_CSRC / f'{name}.cu').read_text()
        key = unit_key(source)
        hit = _fixed[name] = (key, build(key, name, source))
    return hit[1]


def fixed_key(name):
    """The build key of ``csrc/{name}.cu`` (after ``fixed(name)``)."""
    return _fixed[name][0]


def entry(name, symbol, argtypes):
    """The C entry point ``symbol`` of ``csrc/{name}.cu`` (built at the
    first call), taking ``argtypes`` and returning a cudaError_t."""
    fn = getattr(fixed(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_launch(rc, what):
    """Raise when a launch entry returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
