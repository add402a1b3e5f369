"""K2 (the self-test) and K11 (the resident step) of two checkouts of this
repository on one card, in turns: the other tree, this tree, this tree,
the other tree.

    python3 -m devito_tpu_torch.experiments.compare_trees OTHER [--n 512]

OTHER is the root of another checkout, e.g. ``git archive`` of the parent
commit unpacked into a git-ignored directory. Each turn is a fresh process
with only its tree on the path; it measures, through the entry points both
trees have: ``validate_backend``'s wall ms as the first call of the
process (after its CUDA context and a first torch kernel; the kernels
built by an earlier process);
K2's host microseconds a call and device microseconds a launch (torch
profiler), beside K12's empty grid of 2 CTAs into an (8, 128) tensor; and
K11 at n, t0 16, n / 16 reps: ms for 'full' (held against its plain
version first), at twice the reps and by taps. Each turn prints one JSON
line, the table by tree follows.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

__all__ = ['turn', 'main']

HERE = Path(__file__).resolve().parents[2]

_TURN = r"""
import inspect, json, sys, time
import torch
root, n, build = sys.argv[1], int(sys.argv[2]), sys.argv[3] == '1'
sys.path.insert(0, root)
dev = torch.device('cuda', 0)
torch.ones(1, device=dev)
torch.cuda.synchronize()
from devito_tpu_torch.kernels import stencil as K, _nvcc
from devito_tpu_torch.experiments import stencil_probe7 as P7
if build:
    for unit in ('selftest', 'probe7_resident', 'probe7_empty'):
        _nvcc.fixed(unit)
    print(json.dumps({'built': root}))
    sys.exit()
tic = time.perf_counter()
K.validate_backend(dev)
torch.cuda.synchronize()
rec = {'tree': root, 'first_call_ms': (time.perf_counter() - tic) * 1e3}
x = torch.randn(K.SELFTEST_SHAPE, device=dev)
out = torch.empty((8, 4, 128), device=dev)
rec['k2_into_out'] = 'out' in inspect.signature(
    K.selftest_window_sum).parameters
if rec['k2_into_out']:
    k2 = lambda: K.selftest_window_sum(x, out)
else:
    k2 = lambda: K.selftest_window_sum(x)
e = torch.empty((8, 128), device=dev)
k12 = lambda: P7.empty_grid(2, dev, e)


def host_us(fn, calls=500):
    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - tic) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_us(fn, calls=20):
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(ev, 'self_device_time_total', 0)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / calls


def ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


rec.update(k2_host_us=host_us(k2), k12_host_us=host_us(k12),
           k2_device_us=device_us(k2), k12_device_us=device_us(k12))
r = n // 16
got = P7.resident_step(16, r, 'full', P7.FILLS, n, dev)
want = P7.resident_step_reference(16, r, 'full', P7.FILLS, n, dev)
err = (got - want).abs().max().item()
assert err <= P7.TOL * want.abs().max().item(), err
rec.update(k11_err=err, k11_ms={t: ms(lambda t=t: P7.resident_step(
    16, r, t, P7.FILLS, n, dev)) for t in P7.TAPS},
    k11_ms_2x_reps=ms(lambda: P7.resident_step(16, 2 * r, 'full', P7.FILLS,
                                               n, dev)))
print(json.dumps(rec))
"""


def turn(root, n=512, build=False):
    """One turn on the tree at ``root``, in a fresh process: its record,
    or (``build``) only the build of its K2, K11 and K12 libraries."""
    res = subprocess.run(
        [sys.executable, '-c', _TURN, str(root), str(n), str(int(build))],
        capture_output=True, text=True, timeout=900, cwd=str(root))
    if res.returncode:
        raise RuntimeError(f"turn on {root} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.splitlines()[-1])


def main(other, n=512):
    trees = [Path(other).resolve(), HERE]
    for t in trees:
        turn(t, n, build=True)
    recs = []
    for t in (trees[0], trees[1], trees[1], trees[0]):
        recs.append(turn(t, n))
        print(json.dumps(recs[-1]), flush=True)
    keys = ('first_call_ms', 'k2_host_us', 'k12_host_us', 'k2_device_us',
            'k12_device_us', 'k11_ms_2x_reps')
    for t in trees:
        mine = [r for r in recs if r['tree'] == str(t)]
        print(f"{t}: " + '; '.join(
            f"{k} " + ' '.join(f"{r[k]:.4f}" for r in mine) for k in keys)
            + '; k11 ms by taps ' + '; '.join(
                f"{tp} " + ' '.join(f"{r['k11_ms'][tp]:.4f}" for r in mine)
                for tp in mine[0]['k11_ms']), flush=True)
    return recs


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('other', help='root of the other checkout')
    ap.add_argument('--n', type=int, default=512)
    a = ap.parse_args()
    main(a.other, a.n)
