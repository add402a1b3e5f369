"""One run of one cell: set-up, warm-up, the measured window, the traced
jobs, the check against the plain reference, and the result line.

What a job is, and how it is checked, is the traffic mix's job driver's
(``traffic/<driver>.py``, which the mix's file names: see
``manifest.py``). Its module
gives ``Jobs(config, traffic, seed, control)``, which makes the inputs and
the program, with ``build()`` (the lowering), ``plans`` (the K1 plans to
build before the first job), ``warm_up()``, ``run(i)`` (job ``i``: its
loop seconds and time steps), ``finish()`` (the outputs the check needs
kept, the program dropped) and ``check(torch, limits, done, device,
log)`` (``{name: {'value', 'limit'}}``); and ``FAULTS``, by name, each
breaking a ``Jobs`` underneath for the check's own tests.

The window is a closed loop with one caller: jobs back to back until
``--seconds`` have passed; the job that crosses the deadline finishes and
counts. With ``--trace 1`` torch.profiler records the window's first whole
jobs, until ``trace_seconds`` of the traffic file have passed, and the
per-layer readers take their numbers from that trace and from the window's
untraced jobs.

Once the window has closed and the peak memory has been read, the
program's state is freed and the driver holds the compared outputs against
the plain reference; the run is correct when every job ran and each
compared number is within its limit (``limits/<config>.json``).
"""

import gc
import os
import subprocess
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np

from . import guard
from .manifest import ROOT, Manifest
from .roofline import bound_ms_per_step
from .tracefile import JOB_SPAN, Trace

__all__ = ['run_cell', 'NoResult']


class NoResult(Exception):
    """The run cannot give a result (the message says why)."""


def log(*args):
    print('[gpubench]', *args, file=sys.stderr, flush=True)


def _power_limit():
    """The card's name and power limit as nvidia-smi reads them, or
    None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _prebuild(plans, device):
    """Build the K1 units of ``plans`` (eight nvcc processes at a time) and
    the program's self-test before the first shot: (units, units nvcc
    compiled, nvcc seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    from devito_tpu_torch.kernels import stencil as K, _nvcc
    before = dict(_nvcc.build_seconds)
    K.validate_backend(device)
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(K.build, plans))
    new = {k: v for k, v in _nvcc.build_seconds.items() if k not in before}
    return len(plans), len(new), sum(new.values())


def _release(torch, dtt, on_cuda):
    """Free what the program held: its symbol cache and sympy's keep every
    function they have seen, and with it the function's tensor."""
    from sympy.core.cache import clear_cache
    clear_cache()
    dtt.clear_cache()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()


def run_cell(workload, seed, seconds, trace, clock, control=False,
             fault=None, device='cuda', chips=1, root=None, overrides=None,
             stamps=None):
    """Run ``workload`` once and return its result line (a dict).

    ``clock()`` gives the seconds since the process started. ``overrides``
    may replace the cell's ``config``, ``traffic`` and ``limits`` (tests run
    small sizes on the CPU so); ``fault`` names one of the job driver's
    ``FAULTS``, planted before the warm-up. ``stamps`` ({what: clock()
    reading}) are set-up's earlier moments, for its log line."""
    stamps = dict(stamps or {})
    stamps['cuda checked'] = clock()
    import torch
    import devito_tpu_torch as dtt
    from torch.profiler import ProfilerActivity, profile, record_function
    stamps['program imported'] = clock()

    man = Manifest(root or ROOT)
    cell = man.cell(workload)
    ov = overrides or {}
    cfg = ov.get('config') or man.config(cell['config'])
    traffic = ov.get('traffic') or man.traffic(cell['traffic'])
    limits = ov.get('limits') or man.limits(cfg['name'])
    driver = man.driver(traffic)
    dev = torch.device(device)
    on_cuda = dev.type == 'cuda'
    dtt.configuration['device'] = dev.type
    if on_cuda:
        torch.cuda.set_device(dev)
    power = _power_limit() if on_cuda else None
    if power:
        log(f"card: {power}")
    stamps['card ready'] = clock()
    log("set-up so far: " + ", ".join(f"{k} at {v:.3f} s"
                                      for k, v in stamps.items()))

    # set-up: inputs, the program, the lowering, the kernels, the warm-up
    tic = time.perf_counter()
    jobs = driver.Jobs(cfg, traffic, seed, control=control)
    inputs_s = time.perf_counter() - tic
    tic = time.perf_counter()
    jobs.build()
    build_s = time.perf_counter() - tic
    compile_s = 0.0
    if on_cuda:
        tic = time.perf_counter()
        units, compiled, nvcc_s = _prebuild(jobs.plans, dev)
        compile_s = time.perf_counter() - tic
        log(f"compile: {units} K1 units, {compiled} built by nvcc now "
            f"({nvcc_s:.1f} s of nvcc), {compile_s:.2f} s with the "
            f"self-test" + (" (a cold build)" if compiled else
                            " (every unit already built)"))
    if fault is not None:
        driver.FAULTS[fault](jobs)
        log(f"fault planted: {fault}")
    tic = time.perf_counter()
    jobs.warm_up()
    if on_cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    warmup_s = time.perf_counter() - tic
    bad = guard.loaded()
    if bad:
        raise NoResult(f"loaded before the window: {bad}")
    setup_s = clock()
    log(f"set-up {setup_s:.3f} s: start, imports and the card "
        f"{stamps['card ready']:.3f} s, inputs and model {inputs_s:.3f} s, "
        f"lowering {build_s:.3f} s, kernels {compile_s:.3f} s, "
        f"warm-up {warmup_s:.3f} s")

    # the measured window
    prof = None
    if trace:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_cuda else [])
        prof = profile(activities=acts)
        prof.start()
    traced = prof
    done, failed = [], 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t0 = time.perf_counter()
        loop_s, steps = None, 0
        try:
            with record_function(JOB_SPAN):
                loop_s, steps = jobs.run(len(done))
        except Exception:
            failed += 1
            traceback.print_exc(file=sys.stderr)
        t1 = time.perf_counter()
        done.append({'wall': t1 - t0, 'loop': loop_s, 'steps': steps,
                     'traced': prof is not None})
        if prof is not None and t1 - start >= traffic['trace_seconds']:
            prof.stop()
            prof = None
        if t1 >= deadline:
            break
    window_s = t1 - start
    if prof is not None:
        prof.stop()
    peak_window = memory_peak = None
    if on_cuda:
        peak_window = torch.cuda.max_memory_allocated()
        memory_peak = max(setup_peak, peak_window)
    walls = [j['wall'] for j in done]
    log(f"window {window_s:.3f} s: {len(done)} jobs ({failed} failed); job "
        f"seconds: the first {walls[0]:.4f}, median "
        f"{float(np.median(walls)):.4f}, p90 over {len(walls)} jobs "
        f"{float(np.percentile(walls, 90)):.4f}, the largest "
        f"{max(walls):.4f}; peak memory {peak_window} B in the window, "
        f"{memory_peak} B in the run")

    # the program's outputs to the host; its state freed
    jobs.finish()
    points = int(np.prod([n + 2 * cfg['nbl'] for n in cfg['shape']]))
    _release(torch, dtt, on_cuda)

    tr = None
    if traced is not None:
        fd, path = tempfile.mkstemp(suffix='.pt.trace.json')
        os.close(fd)
        try:
            traced.export_chrome_trace(path)
            tr = Trace.load(path)
        finally:
            os.remove(path)
        del traced

    checks = jobs.check(torch, limits, len(done), dev, log)
    correct = (failed == 0 and len(done) > 0 and
               all(c['value'] is not None and c['limit'] is not None and
                   c['value'] <= c['limit'] for c in checks.values()))

    traced_jobs = [j for j in done if j['traced']]
    ctx = SimpleNamespace(
        jobs=done, window_s=window_s, points=points, setup_s=setup_s,
        peak_window_bytes=peak_window, build_s=build_s, trace=tr,
        traced_steps=sum(j['steps'] for j in traced_jobs),
        bound=bound_ms_per_step(cfg['name'], points), config=cfg)
    kind = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for m in man.metrics(kind, workload):
        value = man.reader(kind, m['name'])(ctx)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    result = {
        'correct': bool(correct), 'attempted': len(done), 'failed': failed,
        'metrics': metrics,
        'device': {'platform': 'gpu' if on_cuda else dev.type,
                   'kind': (torch.cuda.get_device_name(dev) if on_cuda
                            else 'cpu'),
                   'count': chips, 'memory_peak_bytes': memory_peak}}
    if tr is not None and tr.jobs:
        result['device'].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result['breakdown'] = {'device_ops': tr.device_ops(),
                               'idle_gaps': tr.idle_gaps()}
    if power:
        result['power_limit'] = power
    for name, m in metrics.items():
        log(f"{name} {m['value']!r} {m['unit']}")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    result['checks'] = checks
    return result
