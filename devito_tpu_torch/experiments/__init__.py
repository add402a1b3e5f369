"""Design probes of the acoustic SO=8 stencil on the card, ported from the
JAX package's ``experiments/`` scripts, each with its hand-written CUDA
kernel and that kernel's plain PyTorch version:

- ``stencil_probe9``: K15, the sliding-ring step
  (``python -m devito_tpu_torch.experiments.stencil_probe9 [N] [TX] [steps]``);
- ``stencil_probe6``: P1 copy bandwidth, K8 window copies and K9 the
  in-place step, a point of K1's streaming engine
  (``python -m devito_tpu_torch.experiments.stencil_probe6 [t0]``);
- ``stencil_probe``: K3, the step of the JAX script's halo'd (x, y)
  tiles, a point of K1's streaming engine
  (``python -m devito_tpu_torch.experiments.stencil_probe [N] [STEPS] [TX] [TY]``);
- ``stencil_probe2``: K4, the step of the JAX script's x-tiles assembled
  from neighbour blocks, x-halo rows computed: a point of K1's streaming
  engine over the interior, a frame of zeros and a kernel for the x-halo
  rows (``python -m devito_tpu_torch.experiments.stencil_probe2 [N] [STEPS] [T]``);
- ``stencil_probe3``: K5, as K4 with the x-halo rows zeroed: the same
  point and frame kernel
  (``python -m devito_tpu_torch.experiments.stencil_probe3 [N] [STEPS] [T]``);
- ``stencil_probe4``: K6, the step of the JAX script's (x, y) tiles with
  a double-buffered window, a point of K1's streaming engine and a frame
  of zeros
  (``python -m devito_tpu_torch.experiments.stencil_probe4 [N] [STEPS] [TX] [TY]``);
- ``stencil_probe5``: K7, the step of the JAX script's x-tiles writing the
  whole padded array, the same point and frame kernel as K4 to K6
  (``python -m devito_tpu_torch.experiments.stencil_probe5 [N] [STEPS] [TX]``);
- ``stencil_probe7``: the parts of an x-tiled step's cost -- K10 streamed
  window copies, K11 arithmetic on resident windows, K12 an empty launch,
  K13 and K14 copy pipelines of depth 2 and d in one launch
  (``python -m devito_tpu_torch.experiments.stencil_probe7 A|B|C|D|E ...``);
- ``compare_trees``: K2 and K11 of another checkout (the parent commit)
  beside this one's on one card, in turns
  (``python -m devito_tpu_torch.experiments.compare_trees OTHER``).

All take ``--device cuda`` (the default) or ``--device cpu``; on the CPU
the plain versions run. Asking for ``cuda`` without CUDA raises.
"""

import time

import torch

from ..arch import platform_registry
from ..parameters import switchconfig, torch_device

__all__ = ['device_for', 'time_ms', 'bound_ms', 'HBM_BYTES_S', 'FP32_FLOP_S']

#: Data-sheet peaks of one H100 SXM at its 700 W limit (arch.py's
#: 'nvidia-h100-sxm' row): device memory bytes per second, and fp32
#: operations per second outside the tensor cores.
HBM_BYTES_S = platform_registry['nvidia-h100-sxm'].hbm_bw
FP32_FLOP_S = platform_registry['nvidia-h100-sxm'].fp32_flops


def bound_ms(nbytes, flops):
    """The least milliseconds the card could take to move ``nbytes`` to or
    from device memory and do ``flops`` fp32 operations, at the data-sheet
    peaks, and which of the two binds: ('bytes' or 'operations')."""
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def device_for(name):
    """The torch device named ``name`` ('cuda' or 'cpu'); raises when CUDA
    is asked for and absent."""
    with switchconfig(device=name):
        return torch_device()


def time_ms(fn, reps, device):
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm-up
    call: CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    tic = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - tic) * 1e3 / reps
