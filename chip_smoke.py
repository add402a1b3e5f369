#!/usr/bin/env python3
"""Drives devito_tpu_torch on one NVIDIA GPU and checks it, phase by phase.

    python3 chip_smoke.py

The speed of the paths that the benchmark's cells run (gpubench/; PERF.md)
is the benchmark's to measure: here those paths are held correct on the
card, and only the paths that no cell runs are timed. Every profile taken
here is read back through operator/trace_profile.py (``trace_of``).

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. Build: nvcc builds every stencil kernel the phases below need.
3. K2, the self-test (TMA boxes through a two-slot mbarrier ring), bit-
   equal to its plain version on random input and on ones, new and into
   an out tensor, one launch counted a call; its host microseconds a call
   and device microseconds a launch (torch.profiler) beside K12's empty
   grid of 2 CTAs into out, and validate_backend's wall time as the first
   call of a fresh process. Then
   K1, the stencil kernel, against its plain PyTorch version on the card:
   one update per case (2-D diffusion on the point design; 3-D damped
   acoustic at SO=2/4/8, a ragged grid and an x not divisible by the
   tile's x-chunk on the streaming design, each also against the point
   design; fp32 and fp64), then the streaming design, the point design
   and the plain version timed at 512^3 SO=8 fp32, with a sweep of the
   streaming design's tiles and stages there.
4. The headline operator (bench.py's damped acoustic, 512^3 SO=8 fp32):
   4 steps against the same operator on the plain version, then 100 steps
   through Operator.apply, which must launch the streaming kernel once per
   step and the point kernel never.
5. The seismic forward model, AcousticWaveSolver.forward, on a 512^3
   layered model: a finite, non-zero shot record and one streaming launch
   per step, no kernel built and no probe kernel launched; then the same
   forward at 96^3 through the kernel and, on the CPU, through the plain
   version, compared. Phases 4 and 5 start as a new process would, with
   no device self-tested: the first K1 launch runs K2, the self-test,
   once for both. The benchmark's acoustic.shots cell times this path.
6. The probe entry points (devito_tpu_torch/experiments): stencil_probe9's
   main (K15, the sliding-ring step) at N=256, TX=32, and stencil_probe6's
   main (P1 copy bandwidth, K8 window copies, K9 the in-place step) at
   N=256, t0=16, each with its launches counted; K9 in both output modes
   and every tap ablation against its plain version, its x-halo rows
   untouched; then K15 and K9 timed at 512^3 beside K1, and P1 at 512^3
   as the card's copy ceiling; K9's CTAs per SM, registers and spills, its
   time without the fullz frame ('interior'), and a sweep of the x-planes
   its CTAs walk, each bit-equal to the pick.
7. The tiled-design probe entry points: stencil_probe (K3), stencil_probe2
   (K4), stencil_probe3 (K5), stencil_probe4 (K6) and stencil_probe5 (K7),
   each main at its JAX script's TPU defaults with its kernel's launches
   counted (K7 at TX=32, where the JAX kernel itself is wrong); then each
   kernel against its plain version at 512^3, one step and 3 steps of its
   loop over the whole array, and timed beside K1 and K15 against P1; K3
   also into up's own interior, bit-equal to K3 into a new tensor, with
   its CTAs per SM, registers and spills, and a sweep of its x-planes; K6
   likewise into up's interior columns, bit-equal to K6 into a new tensor,
   up's x/y halo untouched; and K4, K5, K6 and K7 each with its CTAs per
   SM, registers and spills, its time without its frame of zeros, the
   device time of the frame kernel, of K4's edge-row kernel and of the
   engine (torch.profiler) beside PyTorch's zero_ of the same frame and of
   as many bytes in one run, and a sweep of its tiles and x-planes, each
   bit-equal to the pick; K4 and K5 also into up itself, bit-equal to a
   new tensor.
8. The copy, compute and launch probes of stencil_probe7: A (K10) with and
   without write-back at nsplit 1 and 2, B (K11) for every tap ablation,
   C (K12), D (K13) and E (K14) at depths 2, 3 and 4, each at the JAX
   script's defaults (N=256, ZA=NY) with its kernel's launches counted;
   then each kernel against its plain version on seeded inputs at N=256
   and N=512, and timed beside its bound, its plain version, its library
   call and P1; at N=512 K13/K14 on every tile of stream_tiles at depths
   2, 3 and 4 and nwin 1 and 4, each equal to its plain version to the
   bit: the tile sweep, and the nwin 1 / nwin 4 ablation that tells the
   HBM stream from the L2 re-reads; and K10 on every tile of copy_tiles
   at depths 2, 3 and 4, nwin 1 and 4, with and without write-back, the
   written rows equal to the plain version's to the bit, beside
   torch.add. K12 is timed a call into an out tensor beside out.fill_,
   allocating beside torch.full, through its bare ctypes entry, and
   replayed from a CUDA graph beside fill_ replayed. K11 at N=512, t0 16,
   32 reps: every tile (TY, ROWS) of resident_tiles held against its
   plain version on the varied field, then timed ([resident-sweep]); the
   pick at twice the reps (fill and launch) and by taps; __fdividef
   against IEEE division for every taps x fill set
   ([resident-division]); and the pick's issue floor from the SASS of its
   repetition loop and its shared-memory floor ([resident-floor]).
9. The inverse problem on phase 5's solver (512^3 + nbl 10, SO=8, fp32,
   412 steps), each entry point with K1's counts at 0 just before it and
   read just after: (a) AcousticWaveSolver.adjoint of the forward shot's
   record, one streaming launch a step; (b) builtins.smooth of vp, then
   Born (jacobian) of a seeded dm about the smoothed model, with each
   update's design and the launches its plan implies; the adjoint and
   Born each with their loop ms a step and a short run under
   profiling='measured' (each item's device ms, the device's wait for the
   host, the kernels); (c) the checkpointed gradient (jacobian_adjoint,
   checkpointing=True) of Born's record, with the Revolver's snapshots
   and forward steps (the optimal count + 1), the peak device memory, the
   time of its two sweeps, and the device time of the gradient's
   increment (torch translator) and of a reverse step under
   torch.profiler; (d) at 64^3 + nbl 10 in fp64: the F
   and J dot tests, the checkpointed gradient against the full-save one,
   and the adjoint and the gradient against the plain versions on the
   CPU.
10. The TTI path (models/seismic/tti.py, with CIRE and the hoisting of
   invariants under the default opt): every operator of the phase is
   lowered first and all its K1 units built at once, each unit's nvcc
   seconds, registers and spills logged; (1) K1's point design on the
   halo-extended items -- CIRE's temporaries and the hoisted prologue
   items -- of a 2-D TTI forward (600x500 SO=8, trig taps on) in fp32 and
   fp64 and of the 3-D forwards of (3) and (5), each against its plain
   version on seeded rows within TOL x max; (2) the centered forward at
   the canonical shape, 512x402x890 + nbl 10, SO=12, fp32, through
   tti_setup's model and AnisotropicWaveSolver.forward with a Ricker and
   a line of 512 receivers, every count at 0 just before it and read just
   after: every dense equation on K1, CIRE's temporaries included, each
   unit's design and why logged, each body unit launched once a step and
   each hoisted item once, no equation in the translator; each unit's
   launch at that shape held against its plain version on seeded rows
   (TOL x max) and timed alone, a streaming unit also on the point
   design; the same forward with hoist-trig-taps forced the other way,
   with the same record, its units held likewise and the receivers'
   gather both ways agreeing; and the two settings timed warm in turns
   (ir/optimize.py's 'auto' rule). The benchmark's tti.shots cell times
   the forward;
   (3) the same forward at 96^3 (+nbl 10) SO=8 through the kernels against
   the plain version on the CPU (RUN_TOL); (4) the staggered kernel's
   forward at 256^3 (+nbl 10) SO=8, finite and non-zero, each plan's
   launches counted; (5) the fp64 dot tests F (atol 1e-11) and J (atol
   1e-12) through the kernels on tests/test_adjoint.py's 24x26x28 model
   at SO=8.
11. The other solvers (models/seismic elastic, viscoelastic,
   viscoacoustic, self_adjoint) and the geometry's sinc and precomputed
   interpolation: every operator of the phase is lowered first and all
   its K1 units built at once, each dense equation's design, reason and
   group count and each unit's nvcc seconds, registers and spills logged,
   no equation in the translator; (2) the elastic and viscoelastic
   forwards, viscoacoustic sls (time order 2) forward and adjoint at SO=4
   and self-adjoint forward and adjoint at SO=8, each at 512^3 + nbl 10
   through its *_setup's layered model with setup_geometry's receivers
   (512 x 512 at the surface) over 100 steps or more, every count at 0
   just before and read just after, each plan launched once a step: peak
   device memory, finite non-zero records, each equation's launch at that
   shape held against its plain version on seeded rows (TOL x max) and
   timed alone; but for the elastic forward, which the benchmark's
   elastic.shots cell times, the warm loop ms a step and a run under
   profiling='measured': each body item's device ms a step, the union of
   the device's events, the time the device waited for the host and the
   kernels; (3) each of them and the other five viscoacoustic kernels,
   forward and adjoint, and the elastic forward with sinc and with
   precomputed receivers, at 48^3 + nbl 10 through the kernels against
   the plain versions on the CPU (RUN_TOL); (4) the fp64 dot tests of
   tests/test_viscoacoustic.py (six kernels, 21x25) and
   tests/test_self_adjoint.py (41x41, SO=8) through the kernels, atol
   1e-11; (5) the elastic forward at full width
   with sinc (r=4) and with precomputed receivers, driven as (2), each
   sparse operation timed alone beside linear's, and a run of each under
   profiling='measured' as in (2).
12. Narrow storage, separable interpolation and the Operator's options:
   (1) the phase's new K1 units built at once, each with its nvcc
   seconds, registers and spills; (2) K1 on narrow rows, bench.py's
   headline equation at 512^3 SO=8 with bf16 rows under scope 'fields'
   and 'all' and fp16 under 'fields', on the point design, each against
   its plain version (every value within one narrow ulp, or 1e-5 x max)
   and timed beside the fp32 point and streaming designs and its bound;
   (3) bench.py's second row through Operator.apply: 4 steps against the
   plain version, 100 with one narrow launch a step, its peak memory and
   its drift from the fp32 operator; (4) the elastic forward at 512^3 +
   nbl 10 with 262,144 surface receivers, linear and sinc (r=4), with the
   separable path and with it off: the records within 1e-5 x max, each
   way's separable set-up ms and, under profiling='measured', its sparse
   and loop ms; (5) the superstep wave equation at
   512^3 SO=4, k = 2 and 4, against k single steps (RUN_TOL); (6) spatial
   bounds on the headline operator (an interior box as x_m/x_M, y_m/y_M,
   z_m/z_M and as the bare x=) against the plain version, the outside
   untouched, then the whole domain; (7) the errctl scan on the 412-step
   forward shot beside the same shot without it, and a run with a zero
   velocity raising ExecutionError at the first check after the blow-up;
   (8) the headline operator pickled and rerun here and in a new process,
   bit-equal, with no nvcc build; (9) autotune='basic' launching what the
   untuned run launches. Every part is driven with K1's counts at 0 just
   before and read just after, and its launches add to K1's main path.

13. Host streaming, measured profiling and the platform row on the
   forward shot's model (512^3 + nbl 10, SO=8, fp32): (1) a 40-row save
   (31 GB) resident and streamed (save-streaming 'on', K = 8): the rows,
   the record and the full-save gradient bit-equal both ways, one K1
   launch a step and no new unit, each run's loop ms a step and peak
   device memory beside estimate_memory(layers=True), and each chunk's
   host-to-staging, staging-to-device, compute, device-to-staging and
   staging-to-host ms and GB/s beside the host link's data-sheet rate;
   (2) the smallest save above 1.2 x the card's memory, or, where 60 % of
   the host's MemAvailable holds less, the largest it holds (the reason
   logged), forward and gradient under the default 'auto' and budget,
   the record against the save=False forward's and the gradient against
   the checkpointed one (TOL x max), host RSS; (3) 50 steps of the shot
   under profiling='measured' with a profile-dir: the Chrome trace parsed,
   every body section's device time > 0, the busy time within 1.02 x the
   loop's CUDA-event time, the unattributed events;
   (4) get_platform's row for the card's name, the apply's roofline
   line, and the bounds read from the nvidia-h100-sxm row. Every drive
   has K1's counts at 0 just before it and read just after, its
   launches added to K1's main path.

14. Multi-device through the port, on one card: ``mesh-devices`` 4 puts
   four shards on it. (1) The forward shot at 512^3 + nbl 10 (532^3),
   SO=8, fp32, 100 steps, unsharded, then on topologies (2, 2, 1) and
   (4, 1, 1): each run's wavefield against the unsharded one (bit-equal
   where every shard-local item takes the unsharded design, else K1's
   plain-version tolerance) and its record within RUN_TOL x max; K1's
   launches equal to the shard-local items K1 plans times the steps; the
   exchange's copies and bytes a step equal to the halo plan's slabs;
   the design of each shard-local item and why; the first and warm loop
   ms a step, peak device memory; then the (2, 2, 1) shot
   under profiling='measured': K1's and the exchange's device ms a step
   and whether the exchange's copies overlap K1's launches. (2) The
   checkpointed gradient at (2, 2, 1), 100 steps, against the unsharded
   one on the card. (3) Host streaming through the sharded runner at
   128^3 + nbl 10: the streamed save bit-equal to the resident sharded
   run. (4) The uneven topology (3, 2, 1) at 532^3 (six shards, the last
   x-shards dead-padded) against the unsharded shot. (5) A schedule
   explicit_halo_eligible rejects (a tap-read function whose halo the
   user wrote) runs gathered under halo='auto', its reason printed, equal
   to the unsharded run. A host with more than one card would run (1)
   with one shard a card; on one card that branch is logged as not run.

15. devito_tpu's examples through the port (devito_tpu_torch/examples):
   the phase's K1 units handed to nvcc first (every example, the survey
   and the overrides lowered on the CPU with apply stubbed out); (1)
   every example function at devito_tpu's defaults on the card (linalg:
   its five products), each against the same function run by the port
   on the CPU in a child process (fp32 within 1e-4 x max, fp64 within
   1e-10 x max, strings equal), with the facts devito_tpu's tests
   assert: Black-Scholes against the closed form, the products against
   numpy, the ABC methods' interior energy under a quarter of the
   reflecting run's, the FWI objective decreasing; (2) each example's K1
   launches by design equal to its plans' counts, every applied plan
   launched, each declined item's reason, no probe kernel; (3)
   seismic_fwi.run_fwi on a 601^2 survey (nbl 40, SO=4, 4 shots, 151
   receivers, tn 3000 ms: about 1,620 steps a shot and a 3.0 GB save; 2
   iterations, the model update's step a tenth of the example's): ms a
   step of the forward, save-forward and gradient (CUDA events), wall
   seconds an iteration, peak device memory, the objective decreasing
   and the first shot's gradient repeated bit-equal; (4) a Born dm of
   space order 1 into Born's of space order 0 and a written TimeFunction
   override of a wider halo, each against the CPU's run and bit-equal to
   the Operator's own layout, the relaid plans' launches counted; (5)
   with 4 shards on the card, the sharded diffusion and both halo modes
   ('auto', 'explicit') bit-equal to the unsharded run, 'gspmd' refused.

Every failure raises, and the script exits non-zero. The next-to-last
lines are the kernel records (one JSON line, a record per kernel, each with
its time, its plain version's, its bound -- the larger of the bytes its
result needs (each input point it reads once, each output point written
once) over 3.35 TB/s and its fp32 operations over 67 TFLOP/s, the H100
SXM's data-sheet peaks -- the one PyTorch call that computes the same
function, where there is one, and its launches on its own path and on the
main path, phases 4, 5 and 9-15, every kernel's count read there; K1's
narrow-storage variant has a record of its own) and
the card's name and power limit; the last line is {"ok": true, "device":
{...}}.
"""

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from devito_tpu_torch.experiments import time_ms

SEED = 1234
TOL = {np.float32: 1e-5, np.float64: 1e-12}
#: Kernel against plain version over a whole run of many steps, x max
RUN_TOL = {np.float32: 1e-4, np.float64: 1e-10}
FULL = dict(cases=[('2-D SO=4 diffusion', (1024, 1024), 4, 'diffusion'),
                   ('3-D acoustic SO=2', (128, 128, 128), 2, 'acoustic'),
                   ('3-D acoustic SO=4', (128, 128, 128), 4, 'acoustic'),
                   ('3-D acoustic SO=8', (128, 128, 128), 8, 'acoustic'),
                   ('ragged 61x77x93 SO=8', (61, 77, 93), 8, 'acoustic'),
                   ('x-chunk ragged 100x40x50 SO=4', (100, 40, 50), 4,
                    'acoustic')],
            head_n=512, head_steps=100, head_compare=4,
            fwd_n=512, fwd_compare_n=96, fwd_nbl=10, fwd_tn=500.,
            fwd_nrec=512, reps=20, plain_reps=3,
            # the streaming design's (TY, TZ, PY, STAGES, TX) swept at
            # head_n (the chosen tile is timed as the record)
            sweep=[(16, 64, 4, 2, 32), (16, 64, 4, 3, 48), (16, 64, 2, 2, 32),
                   (8, 64, 2, 2, 32), (8, 128, 4, 3, 32)],
            p9_n=256, p9_tx=32, p9_steps=64, p6_n=256, p6_t0=16, big_n=512,
            # main's (N, STEPS, tiles) of each tiled-design entry point, the
            # JAX scripts' TPU defaults; and each kernel's tiles at big_n
            tiled={'halo_tiles_step': (256, 64, 32, 32),
                   'neighbour_blocks_step': (128, 64, 8),
                   'neighbour_blocks_zeroed_step': (128, 64, 8),
                   'tiles_step': (240, 64, 16, 32),
                   'xtiles_step': (240, 64, 32)},
            tiled_big={'halo_tiles_step': (32, 32),
                       'neighbour_blocks_step': (8,),
                       'neighbour_blocks_zeroed_step': (8,),
                       'tiles_step': (16, 32), 'xtiles_step': (16,)},
            # stencil_probe7: the entry points' N, then the compared sizes
            p7_n=256, p7_sizes=(256, 512),
            # phase 9: the fp64 checks' model (+fwd_nbl), tn and receivers;
            # the steps the gradient's increment and its reverse step are
            # profiled over
            inv_n=64, inv_tn=100., inv_nrec=64, inc_steps=10,
            # phase 10: the canonical TTI shape (+nbl), space order, grid
            # spacing and steps; the 96^3 comparison, the staggered
            # forward, the halo-extended K1 cases and the fp64 dot tests'
            # model
            tti_shape=(512, 402, 890), tti_nbl=10, tti_so=12,
            tti_spacing=20., tti_steps=100,
            tti_nrec=512, tti_cmp_n=96, tti_cmp_so=8, tti_cmp_steps=60,
            tti_stag_n=256, tti_stag_so=8, tti_stag_steps=60,
            tti_2d_shape=(600, 500), tti_dot_shape=(24, 26, 28),
            tti_dot_so=8, tti_dot_tn=250.,
            # phase 11: the other solvers' full width (+nbl), grid spacing,
            # steps and the warm steps profiled; the size and steps of their
            # comparison with the CPU; the fp64 dot tests' models
            # (tests/test_viscoacoustic.py, tests/test_self_adjoint.py)
            sol_n=512, sol_nbl=10, sol_spacing=10., sol_steps=100,
            sol_cmp_n=48, sol_cmp_steps=40,
            sol_dot_shape=(21, 25), sol_dot_tn=250., sa_dot_shape=(41, 41),
            sa_dot_tn=250.,
            # phase 12: the headline size, bench.py's second row's steps;
            # the superstep's size, space order and k; the interior box
            # (x, y, z inclusive: 434 x-planes, not a multiple of the
            # streaming design's x-chunk of 32) and its steps; the pickled
            # operator's steps; the steps of the run that blows up
            p12_n=512, p12_steps=100, p12_ss_n=512, p12_ss_so=4,
            p12_ss_ks=(2, 4), p12_box=((37, 470), (20, 491), (9, 500)),
            p12_bound_steps=2, p12_pickle_steps=2, p12_err_steps=150,
            # phase 13: the forward shot's width (+fwd_nbl), the saved rows
            # of (1) and its streamed K; the share of MemAvailable (2) may
            # take; the steps profiled in (3). p13_card_bytes and
            # p13_auto_budget stand in for the card's memory and the
            # default budget where there is no card (the CPU tests)
            p13_n=512, p13_rows=40, p13_K=8, p13_host_share=0.6,
            p13_prof_steps=50, p13_card_bytes=None, p13_auto_budget=None,
            # phase 14: shards on the card, the forward shot's width
            # (+fwd_nbl) and steps, its topologies, the uneven one; the
            # checkpointed gradient's steps and topology; the streamed
            # run's width, rows and K; the gathered schedule's width and
            # steps; the steps of the measured run
            p14_shards=4, p14_n=512, p14_steps=100,
            p14_topologies=((2, 2, 1), (4, 1, 1)), p14_uneven=(3, 2, 1),
            p14_grad_steps=100, p14_grad_topology=(2, 2, 1),
            p14_stream_n=128, p14_stream_rows=40, p14_stream_K=8,
            p14_gather_n=256, p14_gather_steps=20, p14_prof_steps=20,
            # phase 15: each example's arguments by 'module.function' (none:
            # devito_tpu's defaults); the shards of multichip's; the FWI
            # survey's run_fwi arguments; the Born override's width (+nbl
            # 20) and tn, the written override's width and steps
            p15_args={}, p15_shards=4,
            # (tn 3000 ms: the survey's direct wave crosses its 6 km from
            # the sources to the receivers in 2.4-2.5 s; at 2000 ms both
            # records are zero and the objective is 0)
            # the factor on the example's step (0.05 / max|gradient|): at
            # this survey the example's own step raises the objective
            # (PERF.md §5), a tenth of it lowers it
            p15_fwi=dict(shape=(601, 601), spacing=(10., 10.), nbl=40,
                         space_order=4, tn=3000., nshots=4, nreceivers=151,
                         fwi_iterations=2), p15_fwi_step=0.1,
            p15_born_n=201, p15_born_tn=600., p15_diff_n=512,
            p15_diff_steps=100)
#: (name, source, TPU kernel replaced, the part of the kernel's mangled name
#: that picks its ptxas report out of its unit's) of every kernel, in record
#: order.
KERNELS = [
    ('stencil_update', 'devito_tpu_torch/csrc/stencil_stream.cuh',
     'experiments/pallas_backend.py:303', ''),
    ('selftest_window_sum', 'devito_tpu_torch/csrc/selftest.cu',
     'experiments/pallas_backend.py:54', ''),
    ('ring_step', 'devito_tpu_torch/csrc/probe9_ring.cu',
     'experiments/stencil_probe9.py:32', ''),
    ('inplace_step', 'devito_tpu_torch/csrc/probe6_stream.cu',
     'experiments/stencil_probe6.py:110', 'PointILi2EE'),     # full taps
    ('window_copy', 'devito_tpu_torch/csrc/probe6_window_copy.cu',
     'experiments/stencil_probe6.py:68', ''),
    ('halo_tiles_step', 'devito_tpu_torch/csrc/probe_halo_stream.cu',
     'experiments/stencil_probe.py:64', ''),
    ('neighbour_blocks_step', 'devito_tpu_torch/csrc/probe_tiles_stream.cu',
     'experiments/stencil_probe2.py:73', 'Li16ELi64ELi4ELi3EE'),  # tile
    ('neighbour_blocks_zeroed_step',
     'devito_tpu_torch/csrc/probe_tiles_stream.cu',
     'experiments/stencil_probe3.py:94', 'Li16ELi64ELi4ELi3EE'),
    ('tiles_step', 'devito_tpu_torch/csrc/probe_tiles_stream.cu',
     'experiments/stencil_probe4.py:66', 'Li16ELi64ELi4ELi3EE'),  # tile
    ('xtiles_step', 'devito_tpu_torch/csrc/probe_tiles_stream.cu',
     'experiments/stencil_probe5.py:75', 'Li16ELi64ELi4ELi3EE'),
    ('copy_windows', 'devito_tpu_torch/csrc/probe7_copy.cu',
     'experiments/stencil_probe7.py:38', ''),
    ('resident_step', 'devito_tpu_torch/csrc/probe7_resident.cu',
     'experiments/stencil_probe7.py:124', ''),
    ('empty_grid', 'devito_tpu_torch/csrc/probe7_empty.cu',
     'experiments/stencil_probe7.py:190', ''),
    ('stream_windows_depth2', 'devito_tpu_torch/csrc/probe7_stream.cu',
     'experiments/stencil_probe7.py:212', 'stream_kernelILi2E'),
    ('stream_windows_depth3', 'devito_tpu_torch/csrc/probe7_stream.cu',
     'experiments/stencil_probe7.py:272', 'stream_kernelILi3E'),
]
FIXED = ['selftest', 'probe9_ring', 'probe6_stream', 'probe6_window_copy',
         'probe_halo_stream', 'probe_tiles_stream', 'probe7_copy',
         'probe7_resident', 'probe7_empty', 'probe7_stream']
#: The module of devito_tpu_torch.experiments and the launch counter of
#: every probe kernel, by record name; K13 and K14 share a count keyed by
#: pipeline depth.
PROBE_COUNTERS = {
    'ring_step': ('stencil_probe9', 'launches', None),
    'inplace_step': ('stencil_probe6', 'inplace_launches', None),
    'window_copy': ('stencil_probe6', 'window_copy_launches', None),
    'halo_tiles_step': ('stencil_probe', 'launches', None),
    'neighbour_blocks_step': ('stencil_probe2', 'launches', None),
    'neighbour_blocks_zeroed_step': ('stencil_probe3', 'launches', None),
    'tiles_step': ('stencil_probe4', 'launches', None),
    'xtiles_step': ('stencil_probe5', 'launches', None),
    'copy_windows': ('stencil_probe7', 'copy_launches', None),
    'resident_step': ('stencil_probe7', 'resident_launches', None),
    'empty_grid': ('stencil_probe7', 'empty_launches', None),
    'stream_windows_depth2': ('stencil_probe7', 'stream_launches', 2),
    'stream_windows_depth3': ('stencil_probe7', 'stream_launches', 3)}
#: The keys every kernel record has. ``point_ms``: K1's point design
#: (csrc/stencil.cuh) at the record's shape beside its streaming design's
#: ``ms``; None for the other kernels, which have one design.
RECORD_KEYS = ('name', 'route', 'source', 'replaces', 'launches',
               'launches_main_path', 'max_abs_err', 'ms', 'point_ms',
               'plain_ms', 'bound_ms', 'bound_by', 'library_ms')


def log(*args):
    print(*args, flush=True)


def probe_launches(zero=False):
    """Every probe kernel's launch count, by record name; with ``zero``,
    each count is set to 0 first."""
    counts = {}
    for name, (mod, attr, depth) in PROBE_COUNTERS.items():
        m = importlib.import_module(f'devito_tpu_torch.experiments.{mod}')
        if depth is None:
            if zero:
                setattr(m, attr, 0)
            counts[name] = getattr(m, attr)
        else:
            if zero:
                getattr(m, attr).clear()
            counts[name] = getattr(m, attr).get(depth, 0)
    return counts


def star_points(n, faces=6):
    """Points an SO=8 star stencil reads of its centre field over an n^3
    interior: the interior and the 4-deep slabs on ``faces`` of its faces
    (4 where the z taps outside read zero)."""
    return n ** 3 + faces * 4 * n ** 2


def smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def operator_for(kind, shape, so, dtype, opt=None):
    from devito_tpu_torch import (Grid, TimeFunction, Function, Eq,
                                  Operator, solve)
    grid = Grid(shape=shape, extent=tuple(10. * (s - 1) for s in shape),
                dtype=dtype)
    u = TimeFunction(name='u', grid=grid, time_order=2, space_order=so)
    if kind == 'diffusion':
        pde = u.dt - 0.5 * u.laplace
        fns = {'u': u}
    else:
        vp = Function(name='vp', grid=grid, space_order=so)
        damp = Function(name='damp', grid=grid, space_order=so)
        pde = (1 / (vp * vp)) * u.dt2 - u.laplace + damp * u.dt
        fns = {'u': u, 'vp': vp, 'damp': damp}
    fns['eq'] = Eq(u.forward, solve(pde, u.forward))
    op = Operator(fns['eq'], subs=grid.spacing_map,
                  name=f'{kind}{len(shape)}d', opt=opt)
    return op, fns


def random_rows(plan, device, gen):
    """Inputs of one update of ``plan``: positive velocities, small
    damping, normal wavefield rows; and two zero target rows."""
    tdt = torch.from_numpy(np.empty(0, plan.dtype)).dtype
    ins = []
    for g in plan.groups:
        shape = g['fn']._allocated_space()
        if g['fn'].name == 'vp':
            r = 1.5 + torch.rand(shape, generator=gen, device=device,
                                 dtype=tdt)
        elif g['fn'].name == 'damp':
            r = 0.01 * torch.rand(shape, generator=gen, device=device,
                                  dtype=tdt)
        else:
            r = torch.randn(shape, generator=gen, device=device, dtype=tdt)
        ins.append(r)
    out = torch.zeros(plan.eq.target._allocated_space(), device=device,
                      dtype=tdt)
    return out, out.clone(), ins


def compare_once(plan, device, gen, point=None):
    """One kernel update against the plain version on the same inputs,
    and against ``point`` (the same equation on the point design) when
    given: (max |kernel - plain|, tolerance, max |kernel - point| or
    None). Raises when either is beyond the tolerance."""
    from devito_tpu_torch.kernels import stencil as K
    out, ref, ins = random_rows(plan, device, gen)
    params = {n: 0.7 for n in plan.param_names}
    K.stencil_update(plan, (out, ins), params)
    K.stencil_update_reference(plan, (ref, ins), params)
    diff = None
    if point is not None:
        pout = ref.new_zeros(ref.shape)
        K.stencil_update(point, (pout, ins), params)
    sync(device)
    err = (out - ref).abs().max().item()
    tol = TOL[plan.dtype.type] * ref.abs().max().item()
    if point is not None:
        diff = (out - pout).abs().max().item()
    if not err <= tol or (diff is not None and not diff <= tol):
        raise AssertionError(f"kernel disagrees: max|err| {err:.3e}, "
                             f"against the point design {diff} > "
                             f"{tol:.3e} for {plan.eq!r}")
    return err, tol, diff


def occupancy(K, plan, device):
    """CTAs of ``plan``'s streaming kernel an SM holds, from the CUDA
    runtime (registers, shared memory, threads); None off the card."""
    return K.stream_occupancy(plan) if device.type == 'cuda' else None


def host_us_per_call(fn, device, calls=20):
    """Host microseconds a call of ``fn`` takes to return (the enqueue),
    over ``calls`` calls after one warm-up; the device is synchronised
    before and after, outside the clock."""
    fn()
    sync(device)
    tic = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - tic
    sync(device)
    return host / calls * 1e6


def trace_of(trace_dir):
    """(rows, busy ms) of the newest torch.profiler Chrome trace under
    ``trace_dir``, read by operator/trace_profile.py: ``rows``, (name,
    device ms, calls) of every device event name (kernels, copies, fills),
    longest first; ``busy``, the union of the device events' intervals, in
    which events that overlap (two streams) count once. Only device events
    count: the program's ranges that torch.profiler draws on the device's
    timeline (``dtpu::k1.launch``, ``dtpu_secN``) and the host's ops are
    none. A trace with no device event (a CPU run) gives ([], 0.0)."""
    from collections import Counter
    from devito_tpu_torch.operator import trace_profile as TP
    calls = Counter(n for n, _, _ in TP.device_events(trace_dir) or ())
    rows = sorted(((n, secs * 1e3, calls[n]) for n, secs in
                   (TP.device_op_durations(trace_dir) or {}).items()),
                  key=lambda r: -r[1])
    busy, end = 0.0, None
    for _, _, a, b, _, _ in sorted(TP.section_events(trace_dir) or (),
                                   key=lambda e: e[2]):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return rows, busy * 1e-3


def profiled(fn, device):
    """``trace_of`` one call of ``fn`` under torch.profiler, its trace
    written into a temporary directory."""
    import os
    import tempfile
    from torch.profiler import profile, ProfilerActivity
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            fn()
            sync(device)
        prof.export_chrome_trace(os.path.join(tmp, 'fn.pt.trace.json'))
        return trace_of(tmp)


def item_label(op, it):
    """The label of a body item of ``op``: ``K1 <unit>`` for a dense item
    that launches its unit (None for a fused unit's later equations, which
    launch in the first one's), ``translator <target>`` for one K1
    declined, ``<kind> <sparse function>`` for a sparse one."""
    if hasattr(it, 'region'):
        plan = next(p for e, p in op.kernel_plans if e is it)
        if plan is None:
            return f'translator {it.target.name}'
        return f'K1 {unit_name(plan)}' if plan.eq is it else None
    return f'{it.kind} {it.sparse.name}'


def measured(fn, op, steps, device):
    """``fn()``, one apply of ``op`` over ``steps`` steps whose outputs
    end with its summary, under profiling='measured' with a profile-dir,
    read back by operator/trace_profile.py. Returns (fn's outputs, a row
    of ms a step): ``loop_ms``, the loop's CUDA-event time under the
    profiler; ``busy_ms``, the union of its device events; ``waited_ms``,
    the loop less that union, where the device waited for the host;
    ``idle_share``; ``items``, each body item's device ms by
    ``item_label`` (its ``dtpu_secN`` section); ``other_ms``, the device
    time outside the sections (prologue, epilogue); ``kernels``, the ten
    longest rows of ``trace_of``."""
    import tempfile
    from devito_tpu_torch import switchconfig
    from devito_tpu_torch.operator import trace_profile as TP
    with tempfile.TemporaryDirectory() as tmp:
        with switchconfig(**{'profiling': 'measured', 'profile-dir': tmp}):
            out = fn()
        sync(device)
        rows, busy = trace_of(tmp)
        secs = TP.attribute(tmp) or {'sections': {}, 'other': 0.0}
    loop = out[-1].globals['fdlike'].time * 1e3
    items = {}
    for i, it in enumerate(op.schedule.body):
        lab = item_label(op, it)
        if lab is not None:
            items[lab] = items.get(lab, 0.0) + secs['sections'].get(
                f'dtpu_sec{i}', 0.0) * 1e3 / steps
    return out, dict(
        steps=steps, loop_ms=loop / steps, busy_ms=busy / steps,
        waited_ms=(loop - busy) / steps,
        idle_share=1 - busy / loop if loop else None, items=items,
        other_ms=secs['other'] * 1e3 / steps,
        kernels=[dict(name=n[:120], ms=m / steps, calls=c)
                 for n, m, c in rows[:10]])


def log_measured(label, m):
    log(f"[measured] {label}, {m['steps']} steps: loop {m['loop_ms']:.3f} "
        f"ms/step under the profiler, device busy {m['busy_ms']:.3f} (the "
        f"union of its events), waiting for the host {m['waited_ms']:.3f} "
        f"({100 * (m['idle_share'] or 0):.1f} %); by item: " + '; '.join(
            f"{k} {v:.3f}" for k, v in m['items'].items())
        + f"; outside the sections {m['other_ms']:.3f}; by kernel: "
        + '; '.join(f"{k['ms']:.3f} x{k['calls'] / m['steps']:g}: "
                    f"{k['name'][:60]}" for k in m['kernels'][:6]))


def release(device):
    """Free the device memory of the Functions that earlier work dropped:
    sympy's cache keeps every Function it has seen, and with it the
    function's tensor, until it is cleared."""
    import gc
    from sympy.core.cache import clear_cache
    clear_cache()
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize()


def headline_operator(n, device, opt=None):
    """bench.py's operator at n^3 SO=8 fp32 with a seeded state: velocity
    in [1.5, 2), small damping, a Gaussian pulse in both time slots; built
    with ``opt`` (bench.py's second row: bf16 storage of the fields)."""
    op, fns = operator_for('acoustic', (n, n, n), 8, np.float32, opt)
    rng = np.random.default_rng(SEED)
    fns['vp'].data[:] = 1.5 + 0.5 * rng.random((n,) * 3, dtype=np.float32)
    fns['damp'].data[:] = 0.01 * rng.random((n,) * 3, dtype=np.float32)
    x = (np.arange(n, dtype=np.float32) - n / 2) ** 2
    pulse = np.exp(-(x[:, None, None] + x[None, :, None] + x[None, None, :])
                   / (2 * 6. ** 2))
    fns['u'].data[0] = pulse
    fns['u'].data[1] = pulse
    return op, fns


def forward_solver(n, nbl, tn, nrec, dtype=np.float32, model=None):
    """AcousticWaveSolver on demo_model('layers-isotropic') at n^3, 10 m
    spacing, SO=8, in ``dtype`` (or on ``model``, built so already); a
    10 Hz Ricker at the centre of the surface at z=20 m; ``nrec``
    receivers along x at y centre, z=20 m."""
    from devito_tpu_torch.models.seismic import (
        demo_model, AcquisitionGeometry, AcousticWaveSolver)
    if model is None:
        model = demo_model('layers-isotropic', shape=(n, n, n),
                           spacing=(10., 10., 10.), nbl=nbl, space_order=8,
                           dtype=dtype)
    ext = 10. * (n - 1)
    src = np.array([[ext / 2, ext / 2, 20.]])
    rec = np.stack([np.linspace(0, ext, nrec), np.full(nrec, ext / 2),
                    np.full(nrec, 20.)], 1)
    geom = AcquisitionGeometry(model, rec, src, 0., tn, f0=0.010,
                               src_type='Ricker')
    return AcousticWaveSolver(model, geom, space_order=8)


def inverse_ops(solver, full_save):
    """(label, Operator) of the inverse problem on ``solver``, built as its
    entry points build them (memoized on the solver): the adjoint, Born,
    the checkpointed gradient and its rolling forward; with ``full_save``,
    also the full-save gradient and forward."""
    ops = [('op_adj', solver.op_adj()), ('op_born', solver.op_born()),
           ('op_grad(save=False)', solver.op_grad(save=False)),
           ('op_fwd(save=False)', solver.op_fwd(save=False))]
    if full_save:
        ops += [('op_grad', solver.op_grad()),
                ('op_fwd(True)', solver.op_fwd(True))]
    return ops


def smooth_plan(f, g):
    """The plan of the operator ``builtins.smooth(f, g)`` builds (a moving
    average along the last axis)."""
    from devito_tpu_torch import Eq, Operator
    op = Operator(Eq(f, g.avg(dims=g.dimensions[-1])), name='smoother')
    (_, plan), = op.kernel_plans
    return plan


def smoke(device, sizes):
    """All phases after the first on ``device``; returns the device's
    name and the kernel records."""
    from devito_tpu_torch import switchconfig
    with switchconfig(device=device.type):
        return _smoke(device, sizes)


def _smoke(device, sizes):
    from devito_tpu_torch import Function, switchconfig
    from devito_tpu_torch.compiler.executor import plan_rows
    from devito_tpu_torch.kernels import stencil as K, _nvcc
    from devito_tpu_torch.experiments import stencil_probe7 as P7
    from concurrent.futures import ThreadPoolExecutor

    gen = torch.Generator(device=device).manual_seed(SEED)
    kind = torch.cuda.get_device_name(device) if device.type == 'cuda' \
        else 'cpu'
    records = [{'name': n, 'route': 'cuda', 'source': src, 'replaces': rep}
               for n, src, rep, _ in KERNELS]
    record, selftest = records[:2]

    # -- 2. build every kernel of the phases below -------------------------
    cases = [(f'{lab} {np.dtype(dt).name}',
              operator_for(kind_, shape, so, dt)[0].kernel_plans[0][1])
             for lab, shape, so, kind_ in sizes['cases']
             for dt in (np.float32, np.float64)]
    head_op, head = headline_operator(sizes['head_n'], device)
    solver = forward_solver(sizes['fwd_n'], sizes['fwd_nbl'],
                            sizes['fwd_tn'], sizes['fwd_nrec'])
    small = forward_solver(sizes['fwd_compare_n'], sizes['fwd_nbl'],
                           sizes['fwd_tn'], sizes['fwd_nrec'])
    # phase 9's operators: on the forward shot's solver, and on an fp64
    # solver of its own; smooth's operator into vp0
    small64 = forward_solver(sizes['inv_n'], sizes['fwd_nbl'],
                             sizes['inv_tn'], sizes['inv_nrec'], np.float64)
    vp0 = Function(name='vp0', grid=solver.model.grid, space_order=8)
    inv_plans = [(lab, eq, p) for s_, full in ((solver, False),
                                               (small64, True))
                 for lab, op in inverse_ops(s_, full)
                 for eq, p in op.kernel_plans]
    bad = [(lab, K.decline_reason(eq)) for lab, eq, p in inv_plans
           if p is None and not (lab.startswith('op_grad') and
                                 K.decline_reason(eq) == 'increment')]
    if bad:
        raise AssertionError(f"phase 9 declined more than the gradient's "
                             f"increment: {bad}")
    plans = [p for _, p in cases] + \
        [p for op in (head_op, solver.op_fwd(None), small.op_fwd(None))
         for _, p in op.kernel_plans] + \
        [p for _, _, p in inv_plans if p is not None] + \
        [smooth_plan(vp0, solver.model.vp)]
    if any(p is None for p in plans):
        raise AssertionError("an equation of the smoke path was declined")
    hplan = head_op.kernel_plans[0][1]
    main_plans = [p for op in (head_op, solver.op_fwd(None))
                  for _, p in op.kernel_plans]
    if any(p.design != 'stream' for p in main_plans) or any(
            (p.design == 'stream') != (p.ndim == 3) for _, p in cases):
        raise AssertionError("a 3-D acoustic equation took the point design "
                             "or a 2-D one the streaming design: " + '; '.join(
                                 f"{p.design} ({p.design_reason})"
                                 for p in main_plans + [p for _, p in cases]))
    # the headline's equation in fp64; the point design of each 3-D case;
    # the tiles of the sweep
    h64 = operator_for('acoustic', (sizes['head_n'],) * 3, 8,
                       np.float64)[0].kernel_plans[0][1]
    points = {id(p): K.plan_for(p.eq, _design='point')
              for p in [p for _, p in cases] + [hplan, h64] if p.ndim == 3}
    sweep = [K.plan_for(hplan.eq, _tile=t) for t in sizes['sweep']]
    if any(p.design != 'stream' for p in sweep):
        raise AssertionError("a tile of the sweep does not fit")
    log(f"[design] headline and forward: {hplan.design} "
        f"({hplan.design_reason}); tile {hplan.tile}; 2-D case: "
        f"{cases[0][1].design} "
        f"({cases[0][1].design_reason})")
    if device.type == 'cuda':
        uniq = list({p.key: p for p in
                     plans + [h64] + list(points.values()) + sweep}.values())
        tic = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(K.build, uniq))
            list(pool.map(_nvcc.fixed, FIXED))
        log(f"[build] {len(uniq) + len(FIXED)} kernels in "
            f"{time.perf_counter() - tic:.2f} s wall "
            f"(nvcc {sum(K.build_seconds.values()):.2f} s); headline "
            f"kernel (stream): " + ptxas(K.build_log.get(hplan.key, ''))
            + "; point design: " + ptxas(K.build_log.get(
                points[id(hplan)].key, '')))
        entries = {'probe7_resident': resident_entry(
            P7.resident_tile(16)[0], 'full')}
        for name in FIXED:
            log(f"[build] {name}: " + ptxas(K.build_log.get(
                _nvcc.fixed_key(name), ''), entries.get(name, '')))
        for rec, (_, src, _, entry) in zip(records, KERNELS):
            unit = Path(src).stem
            key = hplan.key if unit == 'stencil_stream' \
                else _nvcc.fixed_key(unit)
            rec['ptxas'] = ptxas(K.build_log.get(key, ''),
                                 entries.get(unit, entry))
    K.validate_backend(device)
    log(f"[selftest] K2 passed on {device} (self-tests run: {K.selftests})")

    # -- 3. K1 and K2 against their plain versions -------------------------
    x = torch.randn(K.SELFTEST_SHAPE, generator=gen, device=device)
    ones = torch.ones(K.SELFTEST_SHAPE, device=device)
    k2_out = torch.empty(K.SELFTEST_OUT, device=device)
    for inp in (x, ones):
        before = K.selftest_launches
        want = K.selftest_window_sum_reference(inp)
        got = K.selftest_window_sum(inp)
        into = K.selftest_window_sum(inp, k2_out)
        if not (torch.equal(got, want) and into is k2_out and
                torch.equal(k2_out, want)) or \
                K.selftest_launches - before != 2 * (device.type == 'cuda'):
            raise AssertionError("self-test kernel disagrees with its plain "
                                 "version, new or into out, or did not "
                                 "count one launch a call")
    err = (got - want).abs().max().item()
    selftest.update(
        max_abs_err=err,
        ms=time_ms(lambda: K.selftest_window_sum(x, k2_out), sizes['reps'],
                   device),
        plain_ms=time_ms(lambda: K.selftest_window_sum_reference(x),
                         sizes['reps'], device),
        **selftest_calls(K, x, k2_out, device))
    set_bound(selftest, 4 * (x.numel() + got.numel()), got.numel())
    log(f"[kernel] K2 self-test (TMA boxes, two-slot mbarrier ring) on "
        f"random input and on ones, new and into out: bit-equal to its "
        f"plain version; {selftest['ms']:.4f} ms into out, plain "
        f"{selftest['plain_ms']:.4f} ms")
    log(f"[selftest] K2 host us a call: into out {selftest['host_us']:.2f}, "
        f"allocating {selftest['host_us_alloc']:.2f}; K12 empty grid of 2 "
        f"CTAs into out {selftest['k12_host_us']:.2f}; device us of one "
        f"launch (torch.profiler): K2 {selftest['device_us']:.2f}, K12 "
        f"{selftest['k12_device_us']:.2f}; validate_backend as the first "
        f"call of a fresh process: "
        + (f"{selftest['first_call_ms']:.2f} ms"
           if selftest['first_call_ms'] is not None else 'not measured'))
    errs, vs_point = [], []
    for lab, plan in cases:
        err, tol, diff = compare_once(plan, device, gen, points.get(id(plan)))
        errs.append(err)
        line = (f"[kernel] {lab} ({plan.design}): max|kernel - plain| "
                f"{err:.3e} (tolerance {tol:.3e})")
        if diff is not None:
            vs_point.append((lab, diff))
            line += (f"; max|stream - point| {diff:.3e}"
                     + (" (bit-equal)" if diff == 0 else ""))
        log(line)
    out, ref, ins = random_rows(hplan, device, gen)
    pout = out.clone()
    params = {'dt': 0.7}
    hpoint = points[id(hplan)]
    K.stencil_update(hplan, (out, ins), params)
    K.stencil_update(hpoint, (pout, ins), params)
    K.stencil_update_reference(hplan, (ref, ins), params)
    sync(device)
    err = (out - ref).abs().max().item()
    diff = (out - pout).abs().max().item()
    tol = TOL[np.float32] * ref.abs().max().item()
    if not (err <= tol and diff <= tol):
        raise AssertionError(f"kernel disagrees at the headline shape: "
                             f"{err:.3e} (plain), {diff:.3e} (point) > "
                             f"{tol:.3e}")
    n = sizes['head_n']
    # u[t] at the star's points, u[t-1], vp, damp in the interior read,
    # u[t+1]'s interior written
    nbytes, flops = 4 * (star_points(n) + 4 * n ** 3), \
        K.point_flops(hplan) * n ** 3
    sweep_rows = []
    for p in sweep:
        ms = time_ms(lambda: K.stencil_update(p, (out, ins), params),
                     sizes['reps'], device)
        sweep_rows.append(dict(tile=p.tile, ms=ms,
                               ctas_per_sm=occupancy(K, p, device),
                               ptxas=ptxas(K.build_log.get(p.key, ''))))
    ms = time_ms(lambda: K.stencil_update(hplan, (out, ins), params),
                 sizes['reps'], device)
    point_ms = time_ms(lambda: K.stencil_update(hpoint, (pout, ins), params),
                       sizes['reps'], device)
    plain_ms = time_ms(
        lambda: K.stencil_update_reference(hplan, (ref, ins), params),
        sizes['plain_reps'], device)
    host_us = {d: host_us_per_call(lambda: K.stencil_update(p, (o, ins),
                                                            params), device)
               for d, p, o in (('stream', hplan, out),
                               ('point', hpoint, pout))}
    record.update(max_abs_err=max(errs + [err]), ms=ms, point_ms=point_ms,
                  plain_ms=plain_ms, point_source='devito_tpu_torch/csrc/'
                  'stencil.cuh', tile=hplan.tile,
                  ctas_per_sm=occupancy(K, hplan, device),
                  max_abs_stream_minus_point=max([diff] + [d for _, d in
                                                           vs_point]),
                  host_us_per_call=host_us, sweep=sweep_rows)
    set_bound(record, nbytes, flops)
    for row in sweep_rows:
        row['share_of_bound'] = record['bound_ms'] / row['ms']
        t = row['tile']
        log(f"[sweep] {n}^3 SO=8 fp32 tile TYxTZ {t['ty']}x{t['tz']}, "
            f"{t['py']} points a thread, {t['stages']} stages, TX "
            f"{t['tx']}: {row['ms']:.4f} ms = {100 * row['share_of_bound']:.1f} % of "
            f"the {record['bound_ms']:.3f} ms bound; {row['ctas_per_sm']} "
            f"CTAs/SM ({t['smem_bytes']} B shared); {row['ptxas']}")
    t = hplan.tile
    log(f"[kernel] chosen tile (stream_tile): TYxTZ {t['ty']}x{t['tz']}, "
        f"{t['py']} points a thread, {t['stages']} stages, TX {t['tx']}, "
        f"{t['threads']} threads, {t['smem_bytes']} B shared; {record['ctas_per_sm']} "
        f"CTAs/SM on the card; {record.get('ptxas', '')}")
    log(f"[kernel] {n}^3 SO=8 fp32: max|kernel - plain| {err:.3e}, "
        f"max|stream - point| {diff:.3e} (tolerance {tol:.3e}); per update "
        f"stream {ms:.4f} ms = {100 * record['share_of_bound']:.1f} % of "
        f"the {record['bound_ms']:.3f} ms bound ({n ** 3 / ms / 1e6:.2f} "
        f"GPts/s), point {point_ms:.4f} ms ({n ** 3 / point_ms / 1e6:.2f} "
        f"GPts/s), plain {plain_ms:.3f} ms; host time a call: stream "
        f"{host_us['stream']:.1f} us, point {host_us['point']:.1f} us")
    del out, ref, ins, pout
    # the same update in fp64: the streaming design's fp64 tile
    out, ref, ins = random_rows(h64, device, gen)
    pout = out.clone()
    K.stencil_update(h64, (out, ins), params)
    K.stencil_update(points[id(h64)], (pout, ins), params)
    K.stencil_update_reference(h64, (ref, ins), params)
    sync(device)
    err64 = max((out - ref).abs().max().item(),
                (out - pout).abs().max().item())
    if not err64 <= TOL[np.float64] * ref.abs().max().item():
        raise AssertionError(f"fp64 kernel disagrees at {n}^3: {err64:.3e}")
    del ref
    fp64 = dict(
        tile=h64.tile, ctas_per_sm=occupancy(K, h64, device),
        ptxas=ptxas(K.build_log.get(h64.key, '')),
        ms=time_ms(lambda: K.stencil_update(h64, (out, ins), params),
                   sizes['reps'], device),
        point_ms=time_ms(lambda: K.stencil_update(points[id(h64)],
                                                  (pout, ins), params),
                         sizes['reps'], device),
        bound_ms=2 * record['bound_ms'])
    record['fp64'] = fp64
    t = h64.tile
    log(f"[kernel] {n}^3 SO=8 fp64, tile TYxTZ {t['ty']}x{t['tz']}, "
        f"{t['py']} points a thread, {t['stages']} stages, TX {t['tx']}: "
        f"stream {fp64['ms']:.4f} ms = "
        f"{100 * fp64['bound_ms'] / fp64['ms']:.1f} % of the "
        f"{fp64['bound_ms']:.3f} ms bound, point {fp64['point_ms']:.4f} ms; "
        f"{fp64['ctas_per_sm']} CTAs/SM; {fp64['ptxas']}; max|stream - "
        f"plain or point| {err64:.3e}")
    del out, ins, pout, points, sweep, h64

    # -- 4. headline operator ---------------------------------------------
    dt_ = 0.6 * 10.0 / 1.5 / (3 ** 0.5) / 4   # bench.py's dt
    ntc = sizes['head_compare']
    u = head['u']
    snap = u._device_array().clone()
    head_op.apply(time_m=1, time_M=ntc, dt=dt_)
    got = u._device_array().clone()
    bufs, hparams = head_op.arguments(time_m=1, time_M=ntc, dt=dt_)
    bufs['u'].copy_(snap)
    for t in range(1, ntc + 1):
        for _, plan in head_op.kernel_plans:
            K.stencil_update_reference(plan, plan_rows(plan, bufs, t,
                                                       hparams), hparams)
    sync(device)
    err = (got - bufs['u']).abs().max().item()
    tol = TOL[np.float32] * bufs['u'].abs().max().item()
    if not err <= tol:
        raise AssertionError(f"headline operator: kernel and plain runs "
                             f"differ by {err:.3e} > {tol:.3e}")
    log(f"[headline] {ntc} steps at {n}^3 SO=8 fp32, kernel vs plain: "
        f"max|diff| {err:.3e} (tolerance {tol:.3e})")
    del snap, got, bufs

    steps = sizes['head_steps']
    ndense = len(head_op.kernel_plans)
    nbuilds = len(K.build_seconds)
    on_card = int(device.type == 'cuda')     # the CPU runs no K1 kernel
    # main path starts here, as in a new process: counts at 0 and no
    # device self-tested yet
    K.launches = K.selftest_launches = K.selftests = 0
    K.launches_by_design.update(point=0, stream=0)
    K.validated.clear()
    probe_launches(zero=True)
    summary = head_op.apply(time_m=1, time_M=steps, dt=dt_)
    head_launches = K.launches
    by_design = dict(K.launches_by_design)
    if by_design != {'stream': on_card * steps * ndense, 'point': 0} or \
            head_launches != on_card * steps * ndense:
        raise AssertionError(f"headline operator launched the kernels "
                             f"{by_design} times for {steps} steps x "
                             f"{ndense} dense equations")
    if not bool(torch.isfinite(u._device_array()).all()):
        raise AssertionError("headline operator: non-finite wavefield")
    g = summary.globals['fdlike']
    log(f"[headline] {steps} steps through Operator.apply: "
        f"{g.time * 1e3 / steps:.3f} ms/step, {g.gpointss:.2f} GPts/s on "
        f"{summary.device}; launches {head_launches} = {steps} x {ndense} "
        f"(stream {by_design['stream']}, point {by_design['point']}), "
        f"declined 0")
    del head_op, head, u
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    # -- 5. seismic forward -------------------------------------------------
    fop = solver.op_fwd(None)
    nsteps = solver.geometry.nt - 2      # time_m=1 .. time_M=nt-2
    before = dict(K.launches_by_design)
    rec = solver.forward()[0]
    sync(device)
    by_design = {d: K.launches_by_design[d] - before[d] for d in before}
    fwd_launches = sum(by_design.values())       # main path ends here
    off_path = probe_launches()
    if (K.selftests, K.selftest_launches) != (on_card, on_card):
        raise AssertionError(f"the main path ran {K.selftests} self-tests "
                             f"({K.selftest_launches} launches), not "
                             f"{on_card}")
    r = np.array(rec.data)
    if not (np.isfinite(r).all() and np.linalg.norm(r) > 0):
        raise AssertionError("forward: rec is not finite and non-zero")
    want = on_card * nsteps * len(fop.kernel_plans)
    if by_design != {'stream': want, 'point': 0}:
        raise AssertionError(f"forward launched the kernels {by_design} "
                             f"times for {nsteps} steps")
    nf = sizes['fwd_n'] + 2 * sizes['fwd_nbl']
    log(f"[forward] {sizes['fwd_n']}^3 (+nbl {sizes['fwd_nbl']}: {nf}^3) "
        f"SO=8, {nsteps} steps, {r.shape[1]} receivers: rec norm "
        f"{np.linalg.norm(r):.6g}; launches {fwd_launches} = {nsteps} "
        f"steps (stream {by_design['stream']}, point {by_design['point']}), "
        f"declined 0")
    record['launches'] = record['launches_main_path'] = \
        head_launches + fwd_launches
    record['launches_by_design'] = {
        d: K.launches_by_design[d] for d in K.launches_by_design}
    selftest['launches'] = selftest['launches_main_path'] = \
        K.selftest_launches
    for rec in records:
        if rec['name'] in off_path:
            rec['launches_main_path'] = off_path[rec['name']]
    if any(off_path.values()):
        raise AssertionError(f"the main path launched probe kernels: "
                             f"{off_path}")
    if len(K.build_seconds) != nbuilds:
        raise AssertionError("the main path rebuilt a kernel")
    log(f"[forward] kernel builds during the main path: 0 (every apply, "
        f"with its own dt and grid, reused the phase-2 builds); K2 "
        f"self-test ran once before the first K1 launch, not once per "
        f"apply")
    del rec, fop        # the solver stays for phase 9
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    rk = np.array(small.forward()[0].data)
    with switchconfig(device='cpu'):
        plain = forward_solver(sizes['fwd_compare_n'], sizes['fwd_nbl'],
                               sizes['fwd_tn'], sizes['fwd_nrec'])
        rp = np.array(plain.forward()[0].data)
    err = np.abs(rk - rp).max()
    tol = RUN_TOL[np.float32] * np.abs(rp).max()
    if not err <= tol:
        raise AssertionError(f"forward at {sizes['fwd_compare_n']}^3: "
                             f"kernel and plain recs differ by {err:.3e}")
    log(f"[forward] {sizes['fwd_compare_n']}^3: rec through the kernel vs "
        f"the plain version (CPU): max|diff| {err:.3e} (tolerance "
        f"{tol:.3e}), rec norm {np.linalg.norm(rk):.6g}")
    del small

    ceiling = probes(device, sizes, gen, records)
    tiled_probes(device, sizes, gen, records, ceiling)
    probe7(device, sizes, gen, records, ceiling)
    if len(K.build_seconds) != nbuilds:
        raise AssertionError("the probe entry points built a kernel")
    inverse(device, sizes, solver, r, vp0, small64, record)
    if len(K.build_seconds) != nbuilds:
        raise AssertionError("the inverse problem built a kernel")
    if (K.selftests, K.selftest_launches) != (on_card, on_card):
        raise AssertionError("the inverse problem ran the self-test again")
    del solver, vp0, small64
    tti(device, sizes, record, gen)
    if (K.selftests, K.selftest_launches) != (on_card, on_card):
        raise AssertionError("the TTI path ran the self-test again")
    solvers(device, sizes, record, gen)
    if (K.selftests, K.selftest_launches) != (on_card, on_card):
        raise AssertionError("the other solvers ran the self-test again")
    narrow_phase(device, sizes, records, gen)
    if (K.selftests, K.selftest_launches) != (on_card, on_card):
        raise AssertionError("phase 12 ran the self-test again")
    streaming_phase(device, sizes, record)
    if (K.selftests, K.selftest_launches) != (on_card, on_card):
        raise AssertionError("phase 13 ran the self-test again")
    many = sharded_phase(device, sizes, record)['one_shard_a_card']
    cards = many['cards'] if isinstance(many, dict) else 1
    if (K.selftests, K.selftest_launches) != (on_card * cards,
                                              on_card * cards):
        raise AssertionError("phase 14 ran the self-test again (once a "
                             "card is due)")
    examples_phase(device, sizes, record)
    if (K.selftests, K.selftest_launches) != (on_card * cards,
                                              on_card * cards):
        raise AssertionError("phase 15 ran the self-test again")
    for rec in records:
        rec.setdefault('library_ms', None)
        rec.setdefault('point_ms', None)
        missing = [k for k in RECORD_KEYS if k not in rec]
        if missing:
            raise AssertionError(f"kernel record {rec['name']} lacks "
                                 f"{missing}")
    return kind, records


#: A fresh process with a CUDA context and a first torch kernel run:
#: validate_backend's wall time as the first self-test of the process (the
#: library built already).
FIRST_CALL = """
import json, time, torch
torch.ones(1, device='cuda')
torch.cuda.synchronize()
from devito_tpu_torch.kernels import stencil as K
tic = time.perf_counter()
K.validate_backend('cuda')
torch.cuda.synchronize()
print(json.dumps({'ms': (time.perf_counter() - tic) * 1e3}))
"""


def device_us(fn, device, calls=20):
    """Device microseconds of one call of ``fn`` under torch.profiler: the
    device events of ``calls`` calls, over ``calls``."""
    rows, _ = profiled(lambda: [fn() for _ in range(calls)], device)
    return sum(ms for _, ms, _ in rows) * 1e3 / calls


def selftest_calls(K, x, out, device):
    """K2's host microseconds a call into ``out`` and allocating, beside
    K12's empty grid of 2 CTAs into an (8, 128) tensor, the device
    microseconds of one launch of each under torch.profiler, and (on the
    card) validate_backend's wall ms as the first call of a fresh
    process."""
    from devito_tpu_torch.experiments import stencil_probe7 as P7
    e = torch.empty(P7.OUT, device=device)
    res = dict(
        host_us=host_us_per_call(lambda: K.selftest_window_sum(x, out),
                                 device, 200),
        host_us_alloc=host_us_per_call(lambda: K.selftest_window_sum(x),
                                       device, 200),
        k12_host_us=host_us_per_call(lambda: P7.empty_grid(2, device, e),
                                     device, 200),
        device_us=device_us(lambda: K.selftest_window_sum(x, out), device),
        k12_device_us=device_us(lambda: P7.empty_grid(2, device, e), device),
        first_call_ms=None)
    if device.type == 'cuda':
        run = subprocess.run(
            [sys.executable, '-c', FIRST_CALL], capture_output=True,
            text=True, timeout=300, cwd=Path(__file__).resolve().parent)
        if run.returncode:
            raise AssertionError(f"validate_backend in a fresh process: "
                                 f"{run.stderr[-2000:]}")
        res['first_call_ms'] = json.loads(run.stdout.splitlines()[-1])['ms']
    return res


def ptxas(log_text, entry=''):
    """The register and spill lines of a ptxas report, joined; of the
    kernels whose mangled name holds ``entry`` only."""
    keep, lines = True, []
    for ln in log_text.splitlines():
        if 'Compiling entry function' in ln:
            keep = entry in ln
        elif keep and ('registers' in ln or 'spill' in ln):
            lines.append(ln.strip())
    return ' '.join(lines)


def set_bound(rec, nbytes, flops):
    """Put into ``rec`` its bound -- the least time the card could take to
    move the ``nbytes`` its result needs (each input point it reads once,
    each output point written once) and do ``flops`` -- which of the two
    binds, and the share of its time."""
    from devito_tpu_torch.experiments import bound_ms
    rec['bound_ms'], rec['bound_by'] = bound_ms(nbytes, flops)
    rec.update(bound_bytes=nbytes, bound_flops=flops,
               share_of_bound=rec['bound_ms'] / rec['ms'])


def check_close(what, got, want):
    err = (got - want).abs().max().item()
    tol = TOL[np.float32] * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: max|kernel - plain| {err:.3e} > "
                             f"{tol:.3e}")
    return err


def probes(device, sizes, gen, records):
    """Phase 6: the probe entry points, each driven with its kernels'
    launch counts at 0 just before and read just after; then the 512^3
    comparisons and times. Returns P1's GB/s, the copy ceiling."""
    from devito_tpu_torch.experiments import _stream as S
    from devito_tpu_torch.experiments import stencil_probe6 as P6
    from devito_tpu_torch.experiments import stencil_probe9 as P9
    k1, _, ring, inplace, wcopy = records[:5]
    dev = device.type
    on_card = int(dev == 'cuda')     # the CPU runs the plain versions
    H = P6.H

    # -- stencil_probe9: K15 -------------------------------------------------
    n, tx, steps = sizes['p9_n'], sizes['p9_tx'], sizes['p9_steps']
    P9.launches = 0
    r9 = P9.main(n, tx, steps, dev)
    ring['launches'] = P9.launches
    want = on_card * (steps + 2)  # one compared, one warm-up, steps timed
    if P9.launches != want:
        raise AssertionError(f"stencil_probe9 launched K15 {P9.launches} "
                             f"times, not {want}")
    log(f"[probe9] K15 at N={n}, TX={tx}: max|kernel - plain| "
        f"{r9['err']:.3e} (tolerance {r9['tol']:.3e}); {r9['ms']:.3f} "
        f"ms/step; launches {P9.launches}")

    # -- stencil_probe6: P1, K8, K9 -----------------------------------------
    n6, t0 = sizes['p6_n'], sizes['p6_t0']
    P6.inplace_launches = P6.window_copy_launches = 0
    r6 = P6.main(t0, dev, n6)
    wcopy['launches'] = P6.window_copy_launches
    inplace['launches'] = P6.inplace_launches
    # P2: 3 windows x (1 + warm-up + 10); P3: 6 x (1 compared + 4 x 32)
    want = (on_card * 3 * 12, on_card * 6 * (1 + 4 * 32))
    if (P6.window_copy_launches, P6.inplace_launches) != want:
        raise AssertionError(f"stencil_probe6 launched K8/K9 "
                             f"{P6.window_copy_launches}/"
                             f"{P6.inplace_launches} times, not {want}")
    if not all(r['correct'] for r in r6['p2']):
        raise AssertionError("K8 copied a window wrongly")
    log(f"[probe6] K8 windows correct=True x3: " + ', '.join(
        f"{r['label'].split(' partial')[0].strip()} {r['gbs']:.1f} GB/s "
        f"({r['ms']:.4f} ms)" for r in r6['p2'])
        + f"; launches K8 {P6.window_copy_launches}, K9 "
        f"{P6.inplace_launches}")

    # K9 in both output modes, every ablation, on random buffers
    NY = n6 + 2 * H
    bufs = [torch.randn((NY,) * 3, generator=gen, device=device)
            for _ in range(3)]
    vp = 1.5 + torch.rand((NY,) * 3, generator=gen, device=device)
    damp = 0.01 * torch.rand((NY,) * 3, generator=gen, device=device)
    errs = []
    for tt0 in (t0, 2 * t0):
        for taps in P6.TAPS:
            for mode in P6.OUT_MODES:
                ut, utm1, tgt = bufs
                got = P6.inplace_step(ut, utm1, vp, damp, tgt.clone(), tt0,
                                      mode, taps)
                ref = P6.inplace_step_reference(ut, utm1, vp, damp,
                                                tgt.clone(), mode, taps)
                errs.append(check_close(f"K9 t0={tt0} {taps} {mode}", got,
                                        ref))
                for sl in (slice(0, H), slice(H + n6, None)):
                    if not torch.equal(got[sl], tgt[sl]):
                        raise AssertionError("K9 wrote an x-halo row")
    log(f"[probe6] K9 at N={n6}, t0={t0} and {2 * t0}, taps none/z/full, "
        f"fullz and interior: max|kernel - plain| {max(errs):.3e}, x-halo "
        f"rows untouched")
    del bufs, vp, damp, ut, utm1, tgt, got, ref

    # -- 512^3: K15, K9 beside K1; P1 as the copy ceiling -------------------
    N = sizes['big_n']
    reps, preps = sizes['reps'], sizes['plain_reps']
    p1 = P6.p1_copy_roofline(N, dev)
    ceiling = p1['gbs']
    u0 = torch.randn((N + 2 * H, N + 2 * H, N), generator=gen, device=device)
    slab = [torch.randn((N + 2 * H, N, N), generator=gen, device=device),
            1.5 + torch.rand((N + 2 * H, N, N), generator=gen, device=device),
            0.01 * torch.rand((N + 2 * H, N, N), generator=gen,
                              device=device)]
    err = check_close("K15 at 512^3", P9.ring_step(u0, *slab, 1e-4, tx),
                      P9.ring_step_reference(u0, *slab, 1e-4))
    ring.update(max_abs_err=max(err, r9['err']),
                ms=time_ms(lambda: P9.ring_step(u0, *slab, 1e-4, tx), reps,
                           device),
                plain_ms=time_ms(lambda: P9.ring_step_reference(
                    u0, *slab, 1e-4), preps, device))
    # u0 at the star's points (z compact), u1, vp, dp's interior read
    set_bound(ring, 4 * (star_points(N, faces=4) + 4 * N ** 3),
              P9.FLOPS * N ** 3)
    del u0, slab
    NY = N + 2 * H
    ut, utm1, tgt = (torch.randn((NY,) * 3, generator=gen, device=device)
                     for _ in range(3))
    vp = 1.5 + torch.rand((NY,) * 3, generator=gen, device=device)
    damp = 0.01 * torch.rand((NY,) * 3, generator=gen, device=device)
    ref = P6.inplace_step_reference(ut, utm1, vp, damp, tgt.clone())
    err = check_close("K9 at 512^3", P6.inplace_step(
        ut, utm1, vp, damp, tgt.clone(), t0), ref)
    inplace.update(
        max_abs_err=max(errs + [err]),
        ms=time_ms(lambda: P6.inplace_step(ut, utm1, vp, damp, tgt, t0),
                   reps, device),
        ms_t0_2x=time_ms(lambda: P6.inplace_step(ut, utm1, vp, damp, tgt,
                                                 2 * t0), reps, device),
        plain_ms=time_ms(lambda: P6.inplace_step_reference(
            ut, utm1, vp, damp, tgt), preps, device))
    # ut at the star's points, utm1, vp, damp's interior read; rows
    # [H, H+N) of tgt written whole ('fullz')
    set_bound(inplace, 4 * (star_points(N) + 3 * N ** 3 + N * NY * NY),
              P6.FLOPS['full'] * N ** 3)
    # the x-planes a CTA walks: each candidate bit-equal to the pick
    pick = P6.inplace_step(ut, utm1, vp, damp, tgt.clone(), t0)
    inplace.update(x_chunk=S.X_CHUNK, x_chunk_sweep=[],
                   ms_interior=time_ms(lambda: P6.inplace_step(
                       ut, utm1, vp, damp, tgt, t0, 'interior'), reps,
                       device),
                   ctas_per_sm=S.occupancy('probe6_stream', 2)
                   if on_card else None)
    for xc in S.X_CHUNKS if on_card else ():
        if not torch.equal(P6.inplace_kernel(ut, utm1, vp, damp, tgt.clone(),
                                             'fullz', 'full', xc), pick):
            raise AssertionError(f"K9 at x-chunk {xc} differs from K9 at "
                                 f"{S.X_CHUNK}")
        ms = time_ms(lambda: P6.inplace_kernel(ut, utm1, vp, damp, tgt,
                                               'fullz', 'full', xc),
                     reps, device)
        inplace['x_chunk_sweep'].append(
            dict(x_chunk=xc, ms=ms, share_of_bound=inplace['bound_ms'] / ms))
        log(f"[probe6-sweep] K9 at {N}^3, x-chunk {xc}: {ms:.4f} ms = "
            f"{100 * inplace['bound_ms'] / ms:.1f} % of the "
            f"{inplace['bound_ms']:.3f} ms bound; bit-equal to x-chunk "
            f"{S.X_CHUNK}")
    log(f"[probe6] K9 at {N}^3 (fullz, full taps, x-chunk {S.X_CHUNK}, "
        f"tile {S.TILE}): {inplace['ms']:.4f} ms = "
        f"{100 * inplace['share_of_bound']:.1f} % of the "
        f"{inplace['bound_ms']:.3f} ms bound; interior only (no frame "
        f"kernel) {inplace['ms_interior']:.4f} ms; "
        f"{inplace['ctas_per_sm']} CTAs/SM; {inplace.get('ptxas', '')}")
    del ut, utm1, tgt, vp, damp, ref, pick
    src = torch.randn((NY,) * 3, generator=gen, device=device)
    by_window = {}
    for label, window in P6.p2_windows(N):
        sl = tuple(slice(a, a + k) for a, k in window)
        got = P6.window_copy(src, window)
        if not torch.equal(got[sl], src[sl]):
            raise AssertionError(f"K8 {label} at {N}: wrong copy")
        by_window[label] = time_ms(lambda: P6.window_copy(src, window),
                                   reps, device)
    _, mis = P6.p2_windows(N)[1]
    msl = tuple(slice(a, a + k) for a, k in mis)
    dst = torch.empty_like(src)
    wcopy.update(max_abs_err=0.0, window=str(mis),
                 ms=by_window[P6.p2_windows(N)[1][0]],
                 plain_ms=time_ms(lambda: P6.window_copy_reference(src, mis),
                                  reps, device),
                 library_ms=time_ms(lambda: dst[msl].copy_(src[msl]), reps,
                                    device),
                 library_call='dst[window].copy_(src[window])',
                 ms_by_window=by_window)
    set_bound(wcopy, 2 * 4 * int(np.prod([k for _, k in mis])), 0)
    del src, got, dst

    nbytes = 5 * N ** 3 * 4 / 1e9      # 4 interiors read, 1 written, fp32
    log(f"[probe] P1 copy at {N + 2 * H}^3 (read + write): {p1['ms']:.3f} "
        f"ms, {ceiling:.1f} GB/s = the card's measured copy ceiling")
    for lab, rec in (('K1 stencil_update', k1), ('K15 ring_step TX=%d' % tx,
                                                 ring),
                     ('K9 inplace_step t0=%d' % t0, inplace)):
        gbs = nbytes / rec['ms'] * 1e3
        log(f"[probe] {lab} at {N}^3 SO=8: {rec['ms']:.3f} ms "
            f"({N ** 3 / rec['ms'] / 1e6:.2f} GPts/s, {gbs:.0f} GB/s of "
            f"the 5 arrays = {100 * gbs / ceiling:.1f} % of P1's); plain "
            f"{rec['plain_ms']:.3f} ms")
    log(f"[probe] K9 t0={2 * t0} at {N}^3: {inplace['ms_t0_2x']:.3f} ms; K8 "
        f"window copies at N={N}: " + ', '.join(
            f"{k.split(' partial')[0].strip()} {v:.4f} ms"
            for k, v in by_window.items()))
    return ceiling


def tiled_cases(N, device, gen, tiles):
    """The tiled-design kernels at N^3 on random inputs, by record name:
    (label, one kernel step, its plain version, 3 steps of the loop through
    the kernel and through the plain version -- each returning the whole
    field -- the loop's step through the kernel and through the plain
    version, for timing, the bytes one step's result needs, the points it
    updates, and the bytes of the padded arrays one step reads and writes,
    with how they are counted)."""
    from devito_tpu_torch.experiments import (
        stencil_probe as T3, stencil_probe2 as T4, stencil_probe3 as T5,
        stencil_probe4 as T6, stencil_probe5 as T7)
    H = T3.H
    NP = N + 2 * H
    ZP = -(-NP // 128) * 128

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def coef(*shape):
        return 0.1 + 0.1 * torch.rand(shape, generator=gen, device=device)

    c = slice(H, H + N)
    star = star_points(N)     # of uc: the interior and its 4-deep slabs

    def k3():
        tx, ty = tiles['halo_tiles_step']
        up, uc, m, damp = normal(NP, NP, NP), normal(NP, NP, NP), \
            coef(N, N, N), 0.5 * coef(N, N, N)
        return (f'K3 halo_tiles_step TX={tx} TY={ty}',
                lambda: T3.halo_tiles_step(up, uc, m, damp, tx, ty),
                lambda: T3.halo_tiles_step_reference(up, uc, m, damp),
                lambda: T3.run_pallas(up.clone(), uc.clone(), m, damp, 3, tx,
                                      ty)[1],
                lambda: T3.run_pallas(up.clone(), uc.clone(), m, damp, 3,
                                      plain=True)[1],
                lambda: T3.halo_tiles_step(up, uc, m, damp, tx, ty,
                                           out=up[c, c, c]),
                lambda: T3.halo_tiles_step_reference(up, uc, m, damp,
                                                     out=up[c, c, c]),
                4 * (star + 4 * N ** 3), N ** 3,
                4 * (2 * NP ** 3 + 3 * N ** 3),
                f'up, uc {NP}^3 and m, damp {N}^3 read, {N}^3 written')

    def nb(label, name, step, ref, run, zeroed):
        # K4 computes every x row, K5 zeroes the x halo's; both write the
        # whole array
        if zeroed:
            need, points = star + 2 * N ** 3, N ** 3
        else:
            need, points = NP * (N * N + 16 * N) + 2 * NP * N * N, NP * N * N

        def case():
            t, = tiles[name]
            up, uc, mf = normal(NP, NP, ZP), normal(NP, NP, ZP), \
                coef(NP, NP, ZP)
            spare = torch.empty_like(uc)
            return (f'{label} {name} T={t}',
                    lambda: step(up, uc, mf, t),
                    lambda: ref(up, uc, mf, t),
                    lambda: run(up.clone(), uc.clone(), mf, 3, t)[1],
                    lambda: run(up.clone(), uc.clone(), mf, 3, t,
                                plain=True)[1],
                    lambda: step(up, uc, mf, t, out=spare),
                    lambda: ref(up, uc, mf, t, out=spare),
                    4 * (need + NP * NP * ZP), points, 4 * 4 * NP * NP * ZP,
                    f'uc, up, mfull ({NP}, {NP}, {ZP}) read, out written')
        return case

    def k6():
        tx, ty = tiles['tiles_step']
        u0, uc, m_i = normal(NP, NP, ZP), normal(NP, NP, ZP), coef(N, N, ZP)
        up_i = u0[c, c, :]
        return (f'K6 tiles_step TX={tx} TY={ty}',
                lambda: T6.tiles_step(uc, up_i, m_i, tx, ty),
                lambda: T6.tiles_step_reference(uc, up_i, m_i),
                lambda: T6.run_E(u0.clone(), uc.clone(), m_i, 3, tx, ty)[1],
                lambda: T6.run_E(u0.clone(), uc.clone(), m_i, 3,
                                 plain=True)[1],
                lambda: T6.tiles_step(uc, up_i, m_i, tx, ty, out=up_i),
                lambda: T6.tiles_step_reference(uc, up_i, m_i, out=up_i),
                4 * (star + 2 * N ** 3 + N * N * ZP), N ** 3,
                4 * (NP * NP * ZP + 3 * N * N * ZP),
                f'uc ({NP}, {NP}, {ZP}) and up_i, m_i ({N}, {N}, {ZP}) read, '
                f'({N}, {N}, {ZP}) written')

    def k7():
        tx, = tiles['xtiles_step']
        XP = N + 4 * H
        up, uc, mp = normal(XP, NP, ZP), normal(XP, NP, ZP), \
            coef(XP, NP, ZP)
        spare = torch.empty_like(uc)
        return (f'K7 xtiles_step TX={tx}',
                lambda: T7.xtiles_step(uc, up, mp, tx),
                lambda: T7.xtiles_step_reference(uc, up, mp),
                lambda: T7.run_E(up.clone(), uc.clone(), mp, 3, tx)[1],
                lambda: T7.run_E(up.clone(), uc.clone(), mp, 3,
                                 plain=True)[1],
                lambda: T7.xtiles_step(uc, up, mp, tx, out=spare),
                lambda: T7.xtiles_step_reference(uc, up, mp, out=spare),
                4 * (star + 2 * N ** 3 + XP * NP * ZP), N ** 3,
                4 * 4 * XP * NP * ZP,
                f'uc, up, m_pad ({XP}, {NP}, {ZP}) read, out written')

    return {'halo_tiles_step': k3,
            'neighbour_blocks_step': nb(
                'K4', 'neighbour_blocks_step', T4.neighbour_blocks_step,
                T4.neighbour_blocks_step_reference, T4.run_C, False),
            'neighbour_blocks_zeroed_step': nb(
                'K5', 'neighbour_blocks_zeroed_step',
                T5.neighbour_blocks_zeroed_step,
                T5.neighbour_blocks_zeroed_step_reference, T5.run_E, True),
            'tiles_step': k6, 'xtiles_step': k7}


def tiled_probes(device, sizes, gen, records, ceiling):
    """Phase 7: the tiled-design entry points, each main driven with its
    kernel's launch count at 0 just before and read just after; then each
    kernel against its plain version at big_n^3, whole fields, and its
    time against P1's ``ceiling`` GB/s."""
    from devito_tpu_torch.experiments import (
        stencil_probe as T3, stencil_probe2 as T4, stencil_probe3 as T5,
        stencil_probe4 as T6, stencil_probe5 as T7)
    by_name = {r['name']: r for r in records}
    mods = {'halo_tiles_step': T3, 'neighbour_blocks_step': T4,
            'neighbour_blocks_zeroed_step': T5, 'tiles_step': T6,
            'xtiles_step': T7}
    on_card = int(device.type == 'cuda')     # the CPU runs the plain versions
    for name, mod in mods.items():
        args = sizes['tiled'][name]
        mod.launches = 0
        res = mod.main(*args, device=device.type)
        launches = mod.launches
        # a warm-up and a timed run of STEPS, then 3 + 1 steps compared
        want = on_card * (2 * args[1] + 4)
        if launches != want:
            raise AssertionError(f"{mod.__name__} launched its kernel "
                                 f"{launches} times, not {want}")
        by_name[name].update(launches=launches, max_abs_err=res['err'])
        times = ', '.join(f"{k[3:].upper()} {v:.3f} ms" for k, v in
                          res.items() if k.startswith('ms_'))
        log(f"[tiled] {mod.__name__.split('.')[-1]}.main{args}: {times} "
            f"per {args[1]} steps; max|kernel - plain| {res['err']:.3e} "
            f"(1 and 3 steps, whole field), against variant A "
            f"{res.get('err_a')} (tolerance {res.get('tol')}); launches "
            f"{launches}")

    N = sizes['big_n']
    cases = tiled_cases(N, device, gen, sizes['tiled_big'])
    reps, preps = sizes['reps'], sizes['plain_reps']
    lines = []
    for name, make in cases.items():
        (label, step, plain, loop, plain_loop, timed, plain_timed, need,
         points, nbytes, counted) = make()
        rec = by_name[name]
        errs = [check_close(f"{label} at {N}^3, 1 step", step(), plain()),
                check_close(f"{label} at {N}^3, 3 steps", loop(),
                            plain_loop())]
        rec.update(max_abs_err=max(errs + [rec['max_abs_err']]),
                   ms=time_ms(timed, reps, device),
                   plain_ms=time_ms(plain_timed, preps, device),
                   layout_bytes=nbytes)
        set_bound(rec, need, mods[name].FLOPS * points)
        gbs = nbytes / 1e9 / rec['ms'] * 1e3
        lines.append(
            f"[tiled] {label} at {N}^3: {rec['ms']:.3f} ms "
            f"({N ** 3 / rec['ms'] / 1e6:.2f} GPts/s, {gbs:.0f} GB/s of "
            f"{nbytes / 1e9:.3f} GB = {counted}; {100 * gbs / ceiling:.1f} % "
            f"of P1's); bound {rec['bound_ms']:.3f} ms of the "
            f"{need / 1e9:.3f} GB the result needs = "
            f"{100 * rec['share_of_bound']:.1f} %; plain "
            f"{rec['plain_ms']:.3f} ms; max|kernel - plain| {max(errs):.3e} "
            f"over 1 and 3 steps")
        del step, plain, loop, plain_loop, timed, plain_timed
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    lines += k3_in_place(device, N, gen, by_name['halo_tiles_step'], reps)
    lines += tiles_stream(device, N, gen, by_name,
                          sizes['tiled_big']['neighbour_blocks_step'][0],
                          reps)
    for line in lines:
        log(line)


def k3_in_place(device, N, gen, rec, reps):
    """K3 at N^3 into a new tensor and into up's own interior (the loop's
    target), each against its plain version and bit-equal to each other,
    up's halo untouched; then each x-chunk of ``_stream.X_CHUNKS``, bit-equal
    to the pick, timed into a new tensor. Puts the CTAs per SM and the
    sweep into ``rec``; returns the lines to print."""
    from devito_tpu_torch.experiments import _stream as S
    from devito_tpu_torch.experiments import stencil_probe as T3
    H, NP, c = T3.H, N + 2 * T3.H, slice(T3.H, T3.H + N)
    up, uc = (torch.randn((NP,) * 3, generator=gen, device=device)
              for _ in range(2))
    m = 0.1 + 0.1 * torch.rand((N,) * 3, generator=gen, device=device)
    damp = 0.05 * torch.rand((N,) * 3, generator=gen, device=device)
    plain = T3.halo_tiles_step_reference(up, uc, m, damp)
    new = T3.halo_tiles_step(up, uc, m, damp)
    inplace = up.clone()
    T3.halo_tiles_step(inplace, uc, m, damp, out=inplace[c, c, c])
    errs = [check_close(f"K3 at {N}^3 into a new tensor", new, plain),
            check_close(f"K3 at {N}^3 into up's interior", inplace[c, c, c],
                        plain)]
    if not torch.equal(inplace[c, c, c], new):
        raise AssertionError("K3 into up's interior differs from K3 into a "
                             "new tensor")
    inplace[c, c, c] = up[c, c, c]
    if not torch.equal(inplace, up):
        raise AssertionError("K3 into up's interior wrote up's halo")
    del inplace, plain
    on_card = device.type == 'cuda'
    rec.update(max_abs_err=max(errs + [rec['max_abs_err']]),
               in_place_bit_equal=True, x_chunk=S.X_CHUNK, x_chunk_sweep=[],
               ctas_per_sm=S.occupancy('probe_halo_stream')
               if on_card else None)
    lines = [f"[tiled] K3 at {N}^3 (x-chunk {S.X_CHUNK}, tile {S.TILE}): "
             f"into a new tensor and into up's interior max|kernel - plain| "
             f"{errs[0]:.3e}, {errs[1]:.3e}, the two bit-equal, up's halo "
             f"untouched; {rec['ctas_per_sm']} CTAs/SM; "
             f"{rec.get('ptxas', '')}"]
    spare = torch.empty_like(m)
    for xc in S.X_CHUNKS if on_card else ():
        if not torch.equal(T3.halo_tiles_kernel(up, uc, m, damp, spare, xc),
                           new):
            raise AssertionError(f"K3 at x-chunk {xc} differs from K3 at "
                                 f"{S.X_CHUNK}")
        ms = time_ms(lambda: T3.halo_tiles_kernel(up, uc, m, damp, spare, xc),
                     reps, device)
        rec['x_chunk_sweep'].append(
            dict(x_chunk=xc, ms=ms, share_of_bound=rec['bound_ms'] / ms))
        lines.append(f"[tiled-sweep] K3 at {N}^3, x-chunk {xc}: {ms:.4f} ms "
                     f"= {100 * rec['bound_ms'] / ms:.1f} % of the "
                     f"{rec['bound_ms']:.3f} ms bound; bit-equal to x-chunk "
                     f"{S.X_CHUNK}")
    return lines


def tile_entry(tile):
    """The part of the mangled name of the engine's kernel compiled for
    ``tile`` (TY, TZ, PY, STAGES) that picks its ptxas report."""
    return ''.join(f'Li{v}E' for v in tile) + 'E'


def tiles_stream(device, N, gen, recs, nb_t, reps):
    """K6 at N^3 into up's interior columns (the loop's target) and into a
    new tensor, each against its plain version and bit-equal to each
    other, up's x/y halo untouched; then for K6 (in place), K7, K4 and K5
    (into a spare; K4 at the x-tile ``nb_t``) the time without the frame,
    the device time of the frame, of K4's edge rows and of the engine
    under torch.profiler, beside that of the same frame zeroed by PyTorch
    and of as many bytes zeroed in one run, and each tile of
    ``_tiled.STREAM_TILES`` and x-chunk of ``_stream.X_CHUNKS``, bit-equal
    to the pick, timed as the loop runs it; K4 and K5 also into up itself,
    bit-equal to a new tensor. Puts these, the CTAs per SM and the frame's
    bytes into the records ``recs`` (by name); returns the lines to
    print."""
    from devito_tpu_torch.experiments import _stream as S, _tiled as TT
    from devito_tpu_torch.experiments import stencil_probe2 as T4
    from devito_tpu_torch.experiments import stencil_probe3 as T5
    from devito_tpu_torch.experiments import stencil_probe4 as T6
    from devito_tpu_torch.experiments import stencil_probe5 as T7
    from devito_tpu_torch.kernels import _nvcc
    H, NP, XP = T6.H, N + 2 * T6.H, N + 4 * T6.H
    ZA, c = -(-NP // 128) * 128, slice(T6.H, T6.H + N)
    on_card = device.type == 'cuda'

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def coef(*shape):
        return 0.1 + 0.1 * torch.rand(shape, generator=gen, device=device)

    up, uc = normal(NP, NP, ZA), normal(NP, NP, ZA)
    m_i = coef(N, N, ZA)
    plain = T6.tiles_step_reference(uc, up[c, c, :], m_i)
    new = T6.tiles_step(uc, up[c, c, :], m_i)
    inplace = up.clone()
    T6.tiles_step(uc, inplace[c, c, :], m_i, out=inplace[c, c, :])
    errs = [check_close(f"K6 at {N}^3 into a new tensor", new, plain),
            check_close(f"K6 at {N}^3 into up's interior columns",
                        inplace[c, c, :], plain)]
    if not torch.equal(inplace[c, c, :], new):
        raise AssertionError("K6 into up's interior columns differs from K6 "
                             "into a new tensor")
    inplace[c, c, :] = up[c, c, :]
    if not torch.equal(inplace, up):
        raise AssertionError("K6 into up's interior columns wrote up's x/y "
                             "halo")
    recs['tiles_step'].update(
        max_abs_err=max(errs + [recs['tiles_step']['max_abs_err']]),
        in_place_bit_equal=True)
    lines = [f"[tiled] K6 at {N}^3 into a new tensor and into up's interior "
             f"columns: max|kernel - plain| {errs[0]:.3e}, {errs[1]:.3e}, "
             f"the two bit-equal, up's x/y halo untouched"]
    del inplace, plain, new

    work = up.clone()
    up7, uc7, mp = normal(XP, NP, ZA), normal(XP, NP, ZA), coef(XP, NP, ZA)
    spare = torch.empty_like(uc7)
    up4, uc4, mf4 = normal(NP, NP, ZA), normal(NP, NP, ZA), coef(NP, NP, ZA)
    spare4 = torch.empty_like(uc4)

    def k6_run(xc, tile, zeros=True, into=work):
        T6.tiles_kernel(uc, into[c, c, :], m_i, into[c, c, :], xc, tile,
                        zeros)
        return into

    def k7_run(xc, tile, zeros=True, into=spare):
        return T7.xtiles_kernel(uc7, up7, mp, into, xc, tile, zeros)

    def k4_run(xc, tile, zeros=True, into=spare4):
        return T4.neighbour_blocks_kernel(up4, uc4, mf4, nb_t, into, xc,
                                          tile, zeros)

    def k5_run(xc, tile, zeros=True, into=spare4):
        return T5.neighbour_blocks_zeroed_kernel(up4, uc4, mf4, into, xc,
                                                 tile, zeros)

    # K4's and K5's steps, and their plain versions, from up_ into out
    nb_steps = {
        'K4': (lambda up_, out=None: T4.neighbour_blocks_step(
            up_, uc4, mf4, nb_t, out=out),
            lambda: T4.neighbour_blocks_step_reference(up4, uc4, mf4, nb_t)),
        'K5': (lambda up_, out=None: T5.neighbour_blocks_zeroed_step(
            up_, uc4, mf4, nb_t, out=out),
            lambda: T5.neighbour_blocks_zeroed_step_reference(up4, uc4, mf4,
                                                             nb_t))}

    # the same frames zeroed by PyTorch, a zero_ a box
    x7, a = slice(2 * H, 2 * H + N), slice(None)
    k6_boxes = [(c, c, slice(0, H)), (c, c, slice(H + N, None))]
    k7_boxes = [(slice(0, 2 * H),), (slice(2 * H + N, None),),
                (x7, slice(0, H)), (x7, slice(H + N, None)),
                (x7, c, slice(0, H)), (x7, c, slice(H + N, None))]
    k4_boxes = [(a, slice(0, H)), (a, slice(H + N, None)),
                (a, c, slice(0, H)), (a, c, slice(H + N, None))]
    k5_boxes = [(slice(0, H),), (slice(H + N, None),),
                (c, slice(0, H)), (c, slice(H + N, None)),
                (c, c, slice(0, H)), (c, c, slice(H + N, None))]
    fill = torch.empty(XP * NP * ZA - N ** 3, device=device)

    def device_rows_of(fn, kernels):
        """(name, device ms a call) of each kernel of ``fn``, which
        launches ``kernels`` device kernels a call, from ``reps`` calls
        under torch.profiler. A session can drop a kernel's event (the
        CUPTI trace on the card returned 39 of 40, and once none of 20),
        so each kernel's time a call is the mean of the events returned
        times its launches a call; profiled again (three tries) unless
        the launches a call add up to ``kernels``, and raises then."""
        for _ in range(3):
            sync(device)
            rows, _ = profiled(lambda: [fn() for _ in range(reps)],
                               device)
            per_call = [round(r[2] / reps) for r in rows]
            if sum(per_call) == kernels and all(per_call):
                return [(r[0], r[1] / r[2] * k)
                        for r, k in zip(rows, per_call)]
        got = [r[2] for r in rows]
        raise AssertionError(f"torch.profiler returned {got} device events "
                             f"of {reps} calls of {kernels} kernels")

    def device_ms(fn, kernels):
        """Device ms a call of ``fn``, all kernels, under torch.profiler."""
        return sum(r[1] for r in device_rows_of(fn, kernels))

    log_ = _nvcc.build_log.get(_nvcc.fixed_key('probe_tiles_stream'), '') \
        if on_card else ''
    xc0, tile0 = S.X_CHUNK, TT.STREAM_TILE
    new4 = lambda: torch.empty_like(uc4)  # noqa: E731
    for lab, name, run, fresh, frame_points, target, boxes in (
            ('K6', 'tiles_step', k6_run, lambda: up.clone(),
             N * N * (ZA - N), work, k6_boxes),
            ('K7', 'xtiles_step', k7_run, lambda: torch.empty_like(uc7),
             XP * NP * ZA - N ** 3, spare, k7_boxes),
            ('K4', 'neighbour_blocks_step', k4_run, new4,
             NP * NP * ZA - NP * N * N, spare4, k4_boxes),
            ('K5', 'neighbour_blocks_zeroed_step', k5_run, new4,
             NP * NP * ZA - N ** 3, spare4, k5_boxes)):
        rec = recs[name]
        nb = lab in ('K4', 'K5')
        rec.update(x_chunk=xc0, tile=list(tile0), x_chunk_sweep=[],
                   tile_sweep=[], frame_bytes=4 * frame_points,
                   ms_interior=None, frame_device_ms=None,
                   engine_device_ms=None, ctas_per_sm=None,
                   frame_library_call=f'{len(boxes)} zero_ of its boxes',
                   frame_library_device_ms=None, frame_fill_device_ms=None)
        if lab == 'K4':
            rec.update(edge_device_ms=None, edge_rows_t=nb_t)
        if nb:
            # into up itself: the frame zeroes only up's y/z halo, which
            # the engine never reads, and the edge rows read up only at
            # the point they write
            step, plain = nb_steps[lab]
            into_up = up4.clone()
            step(into_up, out=into_up)
            err = check_close(f"{lab} at {N}^3 into up", into_up, plain())
            if not torch.equal(into_up, step(up4)):
                raise AssertionError(f"{lab} into up differs from {lab} "
                                     f"into a new tensor")
            del into_up
            rec.update(out_up_bit_equal=True,
                       max_abs_err=max(err, rec['max_abs_err']))
        if not on_card:
            continue
        pick = run(xc0, tile0, into=fresh())
        # device time by kernel of reps calls (the frame is a launch shorter
        # than the host path of a call, so CUDA events cannot time it)
        prof = device_rows_of(lambda: run(xc0, tile0),
                              3 if lab == 'K4' else 2)
        rec.update(
            ms_interior=time_ms(lambda: run(xc0, tile0, False), reps,
                                device),
            frame_device_ms=sum(r[1] for r in prof
                                if 'frame_kernel' in r[0]),
            engine_device_ms=sum(r[1] for r in prof
                                 if 'stream_kernel' in r[0]),
            ctas_per_sm=S.occupancy('probe_tiles_stream',
                                    2 * TT.STREAM_TILES.index(tile0)),
            frame_ptxas=ptxas(log_, 'frame_kernel'),
            frame_library_device_ms=device_ms(
                lambda: [target[b].zero_() for b in boxes], len(boxes)),
            frame_fill_device_ms=device_ms(
                lambda: fill[:frame_points].zero_(), 1))
        edge = ''
        if lab == 'K4':
            rec.update(edge_device_ms=sum(
                r[1] for r in prof if 'edge_rows_kernel' in r[0]),
                edge_ptxas=ptxas(log_, 'edge_rows_kernel'))
            edge = (f", edge rows (T={nb_t}) {rec['edge_device_ms']:.4f} "
                    f"ms ({rec['edge_ptxas']})")
        for key, cands in (('tile', TT.STREAM_TILES), ('x_chunk', S.X_CHUNKS)):
            for cand in cands:
                xc, tile = (xc0, cand) if key == 'tile' else (cand, tile0)
                if not torch.equal(run(xc, tile, into=fresh()), pick):
                    raise AssertionError(f"{lab} at {key} {cand} differs "
                                         f"from {lab} at {key} "
                                         f"{rec[key]}")
                ms = time_ms(lambda: run(xc, tile), reps, device)
                row = dict(ms=ms, share_of_bound=rec['bound_ms'] / ms)
                row[key] = list(cand) if key == 'tile' else cand
                extra = ''
                if key == 'tile':
                    row.update(ctas_per_sm=S.occupancy(
                        'probe_tiles_stream', 2 * cands.index(cand)),
                        ptxas=ptxas(log_, tile_entry(cand)))
                    extra = (f"; {row['ctas_per_sm']} CTAs/SM; "
                             f"{row['ptxas']}")
                rec[f'{key}_sweep'].append(row)
                lines.append(
                    f"[tiled-sweep] {lab} at {N}^3, {key} {cand}: {ms:.4f} "
                    f"ms = {100 * rec['bound_ms'] / ms:.1f} % of the "
                    f"{rec['bound_ms']:.3f} ms bound; bit-equal to {key} "
                    f"{rec[key]}{extra}")
        gbs = rec['frame_bytes'] / rec['frame_device_ms'] / 1e6
        lines.append(
            f"[tiled] {lab} at {N}^3 (x-chunk {xc0}, tile {tile0}): "
            f"{rec['ms']:.4f} ms = {100 * rec['share_of_bound']:.1f} % of "
            f"the {rec['bound_ms']:.3f} ms bound; without the frame "
            f"{rec['ms_interior']:.4f} ms; device time a call (profiler): "
            f"engine {rec['engine_device_ms']:.4f} ms, frame "
            f"{rec['frame_device_ms']:.4f} ms ({rec['frame_bytes'] / 1e6:.1f}"
            f" MB of zeros, {gbs:.0f} GB/s){edge}, the same frame by "
            f"{rec['frame_library_call']} "
            f"{rec['frame_library_device_ms']:.4f} ms, as many bytes "
            f"zeroed in one run {rec['frame_fill_device_ms']:.4f} ms; "
            f"{rec['ctas_per_sm']} CTAs/SM; {rec.get('ptxas', '')}; frame "
            f"kernel {rec['frame_ptxas']}"
            + ("; into up itself bit-equal to a new tensor" if nb else ''))
    return lines


def probe7(device, sizes, gen, records, ceiling):
    """Phase 8: stencil_probe7's probes, each driven with its kernel's
    launch count at 0 just before and read just after; then each kernel
    against its plain version on seeded inputs at every N of p7_sizes, and
    timed there beside its bound, its plain version, its library call and
    P1's ``ceiling`` GB/s. The records hold the times at the last N."""
    from devito_tpu_torch.experiments import stencil_probe7 as P7
    from devito_tpu_torch.experiments import HBM_BYTES_S
    by_name = {r['name']: r for r in records}
    k10, k11, k12, k13, k14 = (by_name[k] for k in (
        'copy_windows', 'resident_step', 'empty_grid',
        'stream_windows_depth2', 'stream_windows_depth3'))
    dev, n, H = device.type, sizes['p7_n'], P7.H
    on_card = int(dev == 'cuda')     # the CPU runs the plain versions
    timed = on_card * (2 + P7.REPS)  # compared, warm-up, timed
    reps, preps = sizes['reps'], sizes['plain_reps']

    def counted(label, got, want):
        if got != want:
            raise AssertionError(f"probe {label} launched its kernel {got} "
                                 f"times, not {want}")
        return got

    # -- the probes at the JAX script's defaults ------------------------------
    k10['launches'] = k11['launches'] = 0
    for wb in (True, False):
        for ns in (1, 2):
            P7.copy_launches = 0
            P7.probe_A(16, 4, wb, ns, n=n, device=dev)
            k10['launches'] += counted(f"A wb={wb} nsplit={ns}",
                                       P7.copy_launches, timed)
    b_ms = {}
    for taps in P7.TAPS:
        P7.resident_launches = 0
        b_ms[taps] = P7.probe_B(16, 16, taps, n, dev)['ms']
        k11['launches'] += counted(f"B taps={taps}", P7.resident_launches,
                                   timed)
    # probe C: 2 checks, 3 timed loops of LOOP calls through the wrapper
    # (each run 1 + 3 times), and LOOP calls captured in a CUDA graph: one
    # launch counted a captured call, none a replay. The loop of bare
    # ctypes calls (4 x LOOP launches on the card) goes around the wrapper
    # and is not counted either
    P7.empty_launches = 0
    c = P7.probe_C(16, dev)
    k12.update(launches=counted("C", P7.empty_launches,
                                on_card * (2 + 13 * P7.LOOP)),
               us_per_call=c['us_per_call'])
    streams = {2: 0, 3: 0, 4: 0}
    for depth in (None, 2, 3, 4):        # D, then E at each depth
        P7.stream_launches.clear()
        if depth is None:
            P7.probe_D(16, 4, n=n, device=dev)
        else:
            P7.probe_E(16, 4, depth, n=n, device=dev)
        d = depth or 2
        streams[d] += counted(f"{'E' if depth else 'D'} depth={d}",
                              P7.stream_launches.get(d, 0), timed)
        counted("D/E at other depths", sum(P7.stream_launches.values()),
                timed)
    k13['launches'], k14['launches'] = streams[2], streams[3]
    log(f"[probe7] entry points at N={n}: launches K10 {k10['launches']}, "
        f"K11 {k11['launches']}, K12 {k12['launches']}, K13 "
        f"{k13['launches']}, K14 {k14['launches']}, depth 4 "
        f"{streams[4]}; B ms by taps " + ', '.join(f"{k} {v:.4f}"
                                               for k, v in b_ms.items()))

    # -- each kernel against its plain version, and timed ---------------------
    # K11: probe_B's fills, a second constant set, and u varying with
    # position (the only one in which the Laplacian does not cancel)
    k11_sets = [(P7.FILLS, 0.0), ((0.02, 0.01, 2.0, 0.3), 0.0), P7.VARIED]
    for N in sizes['p7_sizes']:
        NY = N + 2 * H
        src = torch.randn((NY,) * 3, generator=gen, device=device)
        S = N * NY * NY * 4                # bytes of src[H:H+N]
        for wb, ns in ((True, 1), (True, 2), (False, 1)):
            got = P7.copy_windows(src, 16, 4, wb, ns)
            if got.shape != src.shape or wb and not torch.equal(
                    got[H:H + N], P7.copy_windows_reference(src)[H:H + N]):
                raise AssertionError(f"K10 at N={N} wb={wb} nsplit={ns}")
        errs = []
        for taps in P7.TAPS:
            for fills, vary in k11_sets:
                errs.append(check_close(
                    f"K11 at N={N} taps={taps} fills={fills} vary={vary}",
                    P7.resident_step(16, N // 16, taps, fills, N, device,
                                     vary),
                    P7.resident_step_reference(16, N // 16, taps, fills, N,
                                               device, vary)))
        k12_out = torch.empty((8, 128), device=device)
        for r in (1, 7, 16, 300):
            want = P7.empty_grid_reference(r, device)
            if not (torch.equal(P7.empty_grid(r, device), want) and
                    torch.equal(P7.empty_grid(r, device, k12_out), want)):
                raise AssertionError(f"K12 with {r} CTAs")
        for depth in (2, 3, 4):
            if not torch.equal(P7.stream_windows(src, 16, 4, depth),
                               P7.stream_windows_reference(src, 16, 4,
                                                           depth)):
                raise AssertionError(f"K13/K14 at N={N} depth={depth}")

        out = torch.empty_like(src)
        lib_out = torch.empty((8, 128), device=device)
        last = N == sizes['p7_sizes'][-1]
        need, adds = P7.stream_needs(N, 16)
        res = {
            'copy_windows': (
                lambda: P7.copy_windows(src, 16, 4),
                lambda: P7.copy_windows_reference(src),
                lambda: torch.add(src[H:H + N], 1.0, out=out[H:H + N]),
                'torch.add(src[H:H+N], 1.0, out=out[H:H+N])', 2 * S,
                S // 4, 0.0),
            'resident_step': (
                lambda: P7.resident_step(16, N // 16, 'full', P7.FILLS, N,
                                         device),
                lambda: P7.resident_step_reference(16, N // 16, 'full',
                                                   P7.FILLS, N, device),
                None, None, 4 * 8 * 128, P7.FLOPS['full'] * N ** 3,
                max(errs)),
            'empty_grid': (
                lambda: P7.empty_grid(16, device, k12_out),
                lambda: P7.empty_grid_reference(16, device),
                lambda: lib_out.fill_(15.0), 'out.fill_(reps - 1)',
                4 * 8 * 128, 0, 0.0),
            **{name: (
                lambda d=d: P7.stream_windows(src, 16, 4, d),
                lambda d=d: P7.stream_windows_reference(src, 16, 4, d),
                lambda: src[H:H + N:16, :8, :128].sum(0),
                'src[H:H+N:t0, :8, :128].sum(0)', need, adds, 0.0)
               for name, d in (('stream_windows_depth2', 2),
                               ('stream_windows_depth3', 3))}}
        for name, (kern, plain, lib, call, nbytes, flops, err) in \
                res.items():
            rec = by_name[name]
            ms = time_ms(kern, reps, device)
            row = {'ms': ms, 'plain_ms': time_ms(plain, preps, device),
                   'library_ms': time_ms(lib, reps, device) if lib else None}
            if not last:
                rec.update({f'{k}_n{N}': v for k, v in row.items()})
                continue
            rec.update(row, n=N, max_abs_err=err, library_call=call)
            set_bound(rec, nbytes, flops)
            if name.startswith('stream_windows'):
                # the traffic the probe exists to measure: src[H:H+N]
                # streamed once, against the call that reads it once
                sb = S + 4 * 8 * 128
                rec.update(stream_bytes=sb,
                           stream_bound_ms=sb / HBM_BYTES_S * 1e3,
                           stream_library_ms=time_ms(
                               lambda: src[H:H + N].sum(), reps, device),
                           stream_library_call='src[H:H+N].sum()')
                rec['stream_share'] = rec['stream_bound_ms'] / ms
        if last:
            stream_sweep(P7, src, device, reps, ceiling, k13, k14)
            copy_sweep(P7, src, device, reps, ceiling, k10)
            resident_probe(P7, device, N, reps, k11, k11_sets)
        del src, out, got
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        log(f"[probe7] N={N}: K10 interior rows, K12 (new and into out) and "
            f"K13/K14 at depths 2-4 equal their plain versions to the bit; "
            f"K11 max|kernel - plain| {max(errs):.3e} over 3 ablations x 3 "
            f"fill sets (one varying with position)")

    N = sizes['p7_sizes'][-1]
    for lab, rec in (('K10 copy_windows wb, nwin 4', k10),
                     ('K11 resident_step full', k11),
                     ('K12 empty_grid 16 CTAs', k12),
                     ('K13 stream_windows depth 2', k13),
                     ('K14 stream_windows depth 3', k14)):
        moved = rec.get('stream_bytes', rec['bound_bytes'])
        gbs = moved / rec['ms'] / 1e6
        rate = (f"{gbs:.0f} GB/s unique = {100 * gbs / ceiling:.1f} % of "
                f"P1's" if moved > 1e6 else
                f"{rec['bound_flops'] / rec['ms'] / 1e9:.2f} TFLOP/s")
        if 'stream_bytes' in rec:
            rate += (f"; streamed-bytes bound {rec['stream_bound_ms']:.4f} "
                     f"ms = {100 * rec['stream_share']:.1f} %, "
                     f"{rec['stream_library_call']} "
                     f"{rec['stream_library_ms']:.4f} ms; L2 to shared "
                     f"{rec['l2_to_shared_gbs']:.0f} GB/s; nwin 1 "
                     f"{rec['nwin1_ms']:.4f} ms = "
                     f"{100 * rec['stream_bound_ms'] / rec['nwin1_ms']:.1f} %"
                     f"; tile {rec['tile']}, {rec['smem_bytes']} B shared, "
                     f"{rec['ctas_per_sm']} CTAs/SM; {rec.get('ptxas', '')}")
        elif 'ablation' in rec:
            rate += (f"; depth {rec['depth']}, {rec['stages']} staging "
                     f"windows, tile {rec['tile']}, "
                     f"{rec['smem_bytes']} B shared, {rec['ctas_per_sm']} "
                     f"CTAs/SM; {rec.get('ptxas', '')}; chosen tiles "
                     + ', '.join(f"{k} {v:.4f} ms"
                                 for k, v in rec['ablation'].items()))
        log(f"[probe7] {lab} at N={N}: {rec['ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.6f} ms ({rec['bound_by']}) = "
            f"{100 * rec['share_of_bound']:.3f} %; {rate}; plain "
            f"{rec['plain_ms']:.4f} ms; library "
            + (f"{rec['library_ms']:.4f} ms ({rec['library_call']})"
               if rec['library_ms'] is not None else 'none'))
    log_resident(k11, N)
    us = k12['us_per_call']
    log(f"[probe7] K12 16 CTAs, us a call over {P7.LOOP}: into out "
        f"{us['out']:.2f} against out.fill_ {us['fill_']:.2f}; allocating "
        f"{us['alloc']:.2f} against torch.full {us['torch.full']:.2f}; with "
        f"the add {us['add']:.2f}"
        + (f"; bare ctypes {us['ctypes']:.2f}; replayed from a CUDA graph "
           f"{us['graph']:.3f} a launch against fill_ replayed "
           f"{us['graph fill_']:.3f}" if 'graph' in us else ''))


def resident_entry(tile, taps, fast=False):
    """The part of the mangled name of K11's instantiation for ``tile``
    (TY, ROWS) and ``taps`` that picks its ptxas report and its SASS."""
    from devito_tpu_torch.experiments import stencil_probe7 as P7
    return (f"resident_kernelILi{P7.TAPS.index(taps)}ELi{tile[1]}"
            f"ELb{int(fast)}E")


def resident_words(tile, t0, taps):
    """Shared words K11 loads a point on ``tile``: 'full' two z strips of
    4 (2 words a point), 8 y rows, (ROWS + 8) / ROWS x rows into the queue
    and u1, vp, damp; 'z' the strips, the centre and the three; 'none' the
    centre and the three."""
    rows = tile[1] or t0
    return {'full': 2 + 8 + (rows + 8) / rows + 3, 'z': 6, 'none': 4}[taps]


def sass_loop(so, entry):
    """(SASS instructions, of them issued when no division takes its slow
    path, 16-byte shared loads) of the repetition loop of the kernel whose
    mangled name holds ``entry`` in the library ``so``: the longest span
    that a backward branch closes, from ``cuobjdump -sass``, less the
    ranges that a conditional forward branch skips over a CALL (an IEEE
    division's slow path); None where cuobjdump is missing or finds no
    such loop."""
    import re
    import shutil
    exe = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not Path(exe).exists():
        return None
    out = subprocess.run([exe, '-sass', str(so)], capture_output=True,
                         text=True, timeout=300).stdout
    body = next((f for f in re.split(r'\n\s*Function : ', out)[1:]
                 if entry in f.split('\n', 1)[0]), '')
    ins = [(int(a, 16), op.strip()) for a, op in
           re.findall(r'/\*([0-9a-f]{4,})\*/\s+([^;]*);', body)]
    spans = [(int(t, 16), a) for a, op in ins for t in
             re.findall(r'\bBRA(?:\.\w+)*\s+(0x[0-9a-f]+)', op)]
    back = [(t, a) for t, a in spans if t < a]
    if not back:
        return None
    t, a = max(back, key=lambda s: s[1] - s[0])
    loop = [(at, op) for at, op in ins if t <= at <= a]
    skipped = set()
    for at, op in loop:
        m = re.match(r'@!?P\w+\s+BRA(?:\.\w+)*\s+(0x[0-9a-f]+)', op)
        if m and int(m.group(1), 16) > at:
            over = [x for x in loop if at < x[0] < int(m.group(1), 16)]
            if any(o.startswith('CALL') for _, o in over):
                skipped.update(x for x, _ in over)
    loads = sum('LDS.128' in op for _, op in loop)
    return len(loop), len(loop) - len(skipped), loads


def clock_hz():
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    return 1e6 * float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


def resident_probe(P7, device, N, reps, k11, sets):
    """K11 at phase 8's last N, t0 16, N / 16 reps: every tile of
    ``resident_tiles`` held against its plain version on P7.VARIED, then
    timed at 'full' (the sweep); the pick at twice the reps and by taps;
    the division ablation (``__fdividef`` within the tolerance for every
    taps x fill set, and timed beside IEEE division); the pick's ptxas,
    CTAs per SM and shared bytes; and two floors of the pick at 'full':
    issue (the SASS instructions of its repetition loop a point over the
    card's 128 thread-instructions a clock an SM) and shared memory (the
    words it loads a point over 32 a clock an SM), both at the maximum SM
    clock -- diagnostics beside the bound, which they do not replace."""
    from devito_tpu_torch.kernels import _nvcc
    t0, r = 16, N // 16
    on_card = device.type == 'cuda'
    fills, vary = P7.VARIED
    pick = P7.resident_tile(t0)
    log_text = _nvcc.build_log.get(_nvcc.fixed_key('probe7_resident'), '') \
        if on_card else ''
    sweep = []
    for tile, smem, threads, _, _ in P7.resident_tiles(t0):
        err = check_close(
            f"K11 at N={N} tile {tile}",
            P7.resident_step(t0, r, 'full', fills, N, device, vary, tile),
            P7.resident_step_reference(t0, r, 'full', fills, N, device,
                                       vary))
        ms = time_ms(lambda tile=tile: P7.resident_step(
            t0, r, 'full', P7.FILLS, N, device, tile=tile), reps, device)
        ctas = P7.resident_occupancy(t0, 'full', tile, device=device) \
            if on_card else None
        sweep.append(dict(
            tile=tile, kind=P7.resident_instantiation(tile), ms=ms, err=err,
            threads=threads, smem_bytes=smem, ctas_per_sm=ctas,
            warps_per_sm=ctas * threads // 32 if ctas else None,
            words=resident_words(tile, t0, 'full'),
            ptxas=ptxas(log_text, resident_entry(tile, 'full'))))
    division = {}
    for taps in P7.TAPS:
        errs = []
        for f, v in sets:
            got = P7.resident_step(t0, r, taps, f, N, device, v,
                                   fast_div=True)
            want = P7.resident_step_reference(t0, r, taps, f, N, device, v)
            errs.append(((got - want).abs().max().item(),
                         P7.TOL * want.abs().max().item()))
        division[taps] = dict(
            max_err=max(e for e, _ in errs),
            within_tol=all(e <= tol for e, tol in errs),
            ms=time_ms(lambda taps=taps: P7.resident_step(
                t0, r, taps, P7.FILLS, N, device), reps, device),
            fast_ms=time_ms(lambda taps=taps: P7.resident_step(
                t0, r, taps, P7.FILLS, N, device, fast_div=True), reps,
                device))
    pts = t0 * N * N * r
    k11.update(
        tile=pick[0], kind=P7.resident_instantiation(pick[0]),
        threads=pick[2], smem_bytes=pick[1], sweep=sweep, division=division,
        ms_2x_reps=time_ms(lambda: P7.resident_step(
            t0, 2 * r, 'full', P7.FILLS, N, device), reps, device),
        ms_by_taps={t: division[t]['ms'] for t in P7.TAPS},
        ctas_per_sm=P7.resident_occupancy(t0, 'full', device=device)
        if on_card else None,
        ptxas=ptxas(log_text, resident_entry(pick[0], 'full')),
        words=resident_words(pick[0], t0, 'full'), points=pts)
    k11['fixed_ms'] = 2 * k11['ms'] - k11['ms_2x_reps']
    if on_card:
        so = _nvcc._BUILD / (f"probe7_resident_"
                             f"{_nvcc.fixed_key('probe7_resident')}.so")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        hz = clock_hz()
        loop, issued, loads = sass_loop(
            so, resident_entry(pick[0], 'full')) or (None, None, None)
        rows = pick[0][1] or t0
        pts_loop = rows * 4
        # a repetition primes the queue (8 rows) and loads 14 a row: the
        # new queue row, two z strips, 8 y rows, u1, vp and damp
        if loop and loads != 8 + 14 * rows:
            raise AssertionError(f"K11's repetition loop holds {loads} "
                                 f"shared loads, not {8 + 14 * rows}: one "
                                 f"left the loop")
        k11.update(sass_loop=loop, sass_issued=issued, sass_loads=loads,
                   clock_hz=hz, sms=sms,
                   sass_per_point=issued / pts_loop if loop else None)
        k11['issue_floor_ms'] = issued / pts_loop * pts / (
            sms * 128 * hz) * 1e3 if loop else None
        k11['smem_floor_ms'] = k11['words'] * pts / (sms * 32 * hz) * 1e3


def log_resident(k11, N):
    """The [probe7] lines of K11's probe (``resident_probe``)."""
    fl = k11.get('issue_floor_ms')
    log(f"[probe7] K11 at N={N}: full {k11['ms']:.4f} ms on tile "
        f"{k11['tile']} (TY, ROWS; {k11['kind']}), {k11['threads']} "
        f"threads, {k11['smem_bytes']} B shared, {k11['ctas_per_sm']} "
        f"CTAs/SM; {k11['ptxas']}; twice the reps {k11['ms_2x_reps']:.4f} "
        f"ms, so fill and launch {k11['fixed_ms']:.4f} ms; by taps "
        + ', '.join(f"{k} {v:.4f}" for k, v in k11['ms_by_taps'].items()))
    for row in k11['sweep']:
        log(f"[resident-sweep] tile {row['tile']} ({row['kind']}): "
            f"{row['ms']:.4f} ms, {row['threads']} threads, "
            f"{row['smem_bytes']} B, {row['ctas_per_sm']} CTAs/SM = "
            f"{row['warps_per_sm']} warps/SM, {row['words']:.2f} shared "
            f"words/pt, max|kernel - plain| {row['err']:.2e} (varied); "
            f"{row['ptxas']}")
    for taps, d in k11['division'].items():
        log(f"[resident-division] {taps}: IEEE {d['ms']:.4f} ms, "
            f"__fdividef {d['fast_ms']:.4f} ms; __fdividef max|kernel - "
            f"plain| {d['max_err']:.2e} over 3 fill sets, within "
            f"1e-5 x max|plain|: {d['within_tol']}")
    log(f"[resident-floor] full at N={N}: {k11['points']} points; SASS "
        f"of the repetition loop {k11.get('sass_loop')} instructions, "
        f"{k11.get('sass_issued')} issued off the divisions' slow paths "
        f"({k11.get('sass_loads')} LDS.128) = "
        + (f"{k11['sass_per_point']:.2f} a point; issue floor {fl:.4f} ms "
           f"at {k11['clock_hz'] / 1e9:.3f} GHz x {k11['sms']} SMs x 128 "
           f"= {100 * fl / k11['ms']:.1f} % of the time; shared-memory "
           f"floor {k11['smem_floor_ms']:.4f} ms ({k11['words']:.2f} "
           f"words/pt); bound {k11['bound_ms']:.4f} ms (operations)"
           if fl else "not measured"))


def stream_sweep(P7, src, device, reps, ceiling, k13, k14):
    """K13/K14 at phase 8's last N on ``src``: every tile of
    ``stream_tiles`` at depths 2, 3 and 4 and nwin 1 and 4 (t0 16), each
    equal to its plain version to the bit, timed, with its rates: the
    streamed bytes from device memory (src[H:H+N] once) and nwin times
    them from L2 into shared memory. The record of K13 (depth 2) and K14
    (depth 3) gets its chosen tile's shared bytes, CTAs per SM (CUDA
    runtime), nwin 1 time and L2-to-shared rate, and its depth's rows
    (K14 depth 4's too)."""
    from devito_tpu_torch.experiments import HBM_BYTES_S
    on_card = device.type == 'cuda'
    N = src.shape[0] - 2 * P7.H
    S = N * src.shape[1] * src.shape[2] * 4     # bytes of src[H:H+N]
    sb = S + 4 * 8 * 128
    rows = []
    for depth in (2, 3, 4):
        for nwin in (1, 4):
            want = P7.stream_windows_reference(src, 16, nwin, depth)
            chosen = P7.stream_tile(depth, nwin, 16)[0]
            for tile, smem, _ in P7.stream_tiles(depth, nwin, 16):
                if not torch.equal(P7.stream_windows(src, 16, nwin, depth,
                                                     tile), want):
                    raise AssertionError(f"K13/K14 at N={N} depth={depth} "
                                         f"nwin={nwin} tile={tile}")
                ms = time_ms(lambda: P7.stream_windows(src, 16, nwin, depth,
                                                       tile), reps, device)
                row = dict(depth=depth, nwin=nwin, tile=tile,
                           chosen=tile == chosen, smem_bytes=smem,
                           ctas_per_sm=P7.stream_occupancy(
                               16, nwin, depth, tile, device)
                           if on_card else None, ms=ms,
                           hbm_gbs=sb / ms / 1e6,
                           l2_to_shared_gbs=nwin * S / ms / 1e6,
                           stream_share=sb / HBM_BYTES_S * 1e3 / ms)
                rows.append(row)
                log(f"[stream-sweep] N={N} depth {depth} nwin {nwin} tile "
                    f"{tile}{' (chosen)' if row['chosen'] else ''}: "
                    f"{ms:.4f} ms = {100 * row['stream_share']:.1f} % of the "
                    f"streamed-bytes bound, {row['hbm_gbs']:.0f} GB/s = "
                    f"{100 * row['hbm_gbs'] / ceiling:.1f} % of P1, L2 to "
                    f"shared {row['l2_to_shared_gbs']:.0f} GB/s; {smem} B "
                    f"shared, {row['ctas_per_sm']} CTAs/SM")
    for depth in (2, 3, 4):
        at = {r['nwin']: r for r in rows if r['depth'] == depth
              and r['chosen']}
        best = {w: min((r for r in rows if r['depth'] == depth
                        and r['nwin'] == w), key=lambda r: r['ms'])
                for w in (1, 4)}
        log(f"[stream-ablation] N={N} depth {depth}, chosen tiles: nwin 1 "
            f"{at[1]['ms']:.4f} ms ({at[1]['tile']}, "
            f"{100 * at[1]['hbm_gbs'] / ceiling:.1f} % of P1), nwin 4 "
            f"{at[4]['ms']:.4f} ms ({at[4]['tile']}, L2 to shared "
            f"{at[4]['l2_to_shared_gbs']:.0f} GB/s); fastest: nwin 1 "
            f"{best[1]['tile']} {best[1]['ms']:.4f} ms, nwin 4 "
            f"{best[4]['tile']} {best[4]['ms']:.4f} ms")
    for rec, depths in ((k13, (2,)), (k14, (3, 4))):
        d = depths[0]
        at = {r['nwin']: r for r in rows if r['depth'] == d and r['chosen']}
        rec.update(tile=at[4]['tile'], smem_bytes=at[4]['smem_bytes'],
                   ctas_per_sm=at[4]['ctas_per_sm'], nwin1_ms=at[1]['ms'],
                   nwin1_tile=at[1]['tile'],
                   l2_to_shared_gbs=4 * S / rec['ms'] / 1e6,
                   sweep=[r for r in rows if r['depth'] in depths])


def copy_sweep(P7, src, device, reps, ceiling, k10):
    """K10 at phase 8's last N on ``src``: every tile of ``copy_tiles`` at
    depths 2, 3 and 4, nwin 1 and 4, with and without write-back (t0 16),
    each run first (with write-back its rows [H, H+N) equal to src + 1 to
    the bit), then timed, with its rates: the bytes it must move
    (src[H:H+N] read once and, with write-back, out[H:H+N] written once)
    against device memory and P1, and nwin times src[H:H+N] into shared
    memory. K10's record gets its chosen tile's shared bytes and CTAs per
    SM (CUDA runtime), the chosen tiles' times at COPY_DEPTH by nwin and
    write-back, and the rows."""
    from devito_tpu_torch.experiments import HBM_BYTES_S
    on_card = device.type == 'cuda'
    H = P7.H
    N = src.shape[0] - 2 * H
    S = N * src.shape[1] * src.shape[2] * 4     # bytes of src[H:H+N]
    want = src[H:H + N] + 1.0
    rows = []
    for depth in (2, 3, 4):
        for nwin in (1, 4):
            for wb in (True, False):
                chosen = P7.copy_tile(depth, nwin, 16, wb)[0]
                moved = (1 + wb) * S
                for tile, smem, _ in P7.copy_tiles(depth, nwin, 16, wb):
                    def run():
                        return P7.copy_windows(src, 16, nwin, wb, 1, tile,
                                               depth)
                    got = run()
                    sync(device)
                    if wb and not torch.equal(got[H:H + N], want):
                        raise AssertionError(
                            f"K10 at N={N} depth={depth} nwin={nwin} "
                            f"tile={tile}")
                    del got
                    ms = time_ms(run, reps, device)
                    row = dict(depth=depth, nwin=nwin, writeback=wb,
                               tile=tile, chosen=tile == chosen,
                               smem_bytes=smem, ctas_per_sm=P7.copy_occupancy(
                                   16, nwin, depth, tile, wb, device)
                               if on_card else None, ms=ms,
                               hbm_gbs=moved / ms / 1e6,
                               to_shared_gbs=nwin * S / ms / 1e6,
                               share=moved / HBM_BYTES_S * 1e3 / ms)
                    rows.append(row)
                    log(f"[copy-sweep] N={N} depth {depth} nwin {nwin} "
                        f"{'wb' if wb else 'nowb'} tile {tile}"
                        f"{' (chosen)' if row['chosen'] else ''}: {ms:.4f} ms"
                        f" = {100 * row['share']:.1f} % of the bound of its "
                        f"{moved / 1e6:.1f} MB, {row['hbm_gbs']:.0f} GB/s = "
                        f"{100 * row['hbm_gbs'] / ceiling:.1f} % of P1, into "
                        f"shared {row['to_shared_gbs']:.0f} GB/s; {smem} B "
                        f"shared, {row['ctas_per_sm']} CTAs/SM")
    del want
    for depth in (2, 3, 4):
        at = {(r['nwin'], r['writeback']): r for r in rows
              if r['depth'] == depth and r['chosen']}
        best = {k: min((r for r in rows if r['depth'] == depth and
                        (r['nwin'], r['writeback']) == k),
                       key=lambda r: r['ms']) for k in at}
        log(f"[copy-ablation] N={N} depth {depth}, chosen tiles: " + ', '.join(
            f"{'wb' if wb else 'nowb'} nwin {w} {r['ms']:.4f} ms "
            f"({100 * r['hbm_gbs'] / ceiling:.1f} % of P1)"
            for (w, wb), r in sorted(at.items()))
            + f"; torch.add {k10['library_ms']:.4f} ms, bound "
            f"{k10['bound_ms']:.4f} ms; fastest: " + ', '.join(
                f"{'wb' if wb else 'nowb'} nwin {w} {r['tile']} "
                f"{r['ms']:.4f} ms" for (w, wb), r in sorted(best.items())))
    at = {(r['nwin'], r['writeback']): r for r in rows
          if r['depth'] == P7.COPY_DEPTH and r['chosen']}
    k10.update(depth=P7.COPY_DEPTH, stages=P7.COPY_STAGES,
               tile=at[4, True]['tile'],
               smem_bytes=at[4, True]['smem_bytes'],
               ctas_per_sm=at[4, True]['ctas_per_sm'],
               ablation={f"{'wb' if wb else 'nowb'} nwin {w}": r['ms']
                         for (w, wb), r in sorted(at.items())},
               sweep=rows)


def step_kernels(label, trace, steps):
    """Log and return ``profiled``'s reading of a run of ``steps`` steps as
    device ms a step by kernel, with the busy time (the union of the
    device events)."""
    rows, busy = trace
    busy /= steps
    log(f"[profile] {label}: device busy {busy:.4f} ms a step ({steps} "
        f"steps); by kernel: " + '; '.join(
            f"{m / steps:.4f} ms x{c / steps:g}: {n[:70]}"
            for n, m, c in rows[:6]))
    return dict(busy_ms_per_step=busy, kernels=[
        dict(name=n[:120], ms_per_step=m / steps, calls=c)
        for n, m, c in rows[:8]])


def inverse(device, sizes, solver, shot, vp0, small, record):
    """Phase 9: the inverse problem on the forward shot's solver, each
    entry point driven with K1's counts at 0 just before it and read just
    after: (a) the adjoint of the shot's record; (b) smooth, then Born
    about the smoothed model; (c) the checkpointed gradient of Born's
    record (J^T J dm), with its Revolver's counts, its peak memory, its
    cost a reverse step and the increment's device time; then (d) the fp64
    checks on ``small``: the dot tests, the checkpointed gradient against
    the full-save one, and the adjoint and the gradient against the plain
    versions on the CPU. Adds its launches to K1's ``record``."""
    from devito_tpu_torch import Function, TimeFunction
    from devito_tpu_torch import checkpointing as CK
    from devito_tpu_torch.builtins import inner, norm, smooth
    from devito_tpu_torch.compiler.executor import _exec_dense
    from devito_tpu_torch.experiments import bound_ms
    from devito_tpu_torch.kernels import stencil as K
    on_card = int(device.type == 'cuda')     # the CPU runs no K1 kernel
    nsteps = solver.geometry.nt - 2
    nf = sizes['fwd_n'] + 2 * sizes['fwd_nbl']
    inv = record['inverse'] = {}
    paths = record.setdefault('launches_by_path', {})
    rng = np.random.default_rng(SEED)
    release(device)
    if on_card:
        log(f"[inverse] device memory allocated at the start of phase 9: "
            f"{torch.cuda.memory_allocated(device) / 1e9:.2f} GB")

    def drive(label, fn, plans, steps, extra_stream=0):
        """``fn()`` with every kernel's count at 0 just before and read
        just after (K2's, which runs once a process, is read before and
        after); raises unless each plan launched its design ``steps``
        times (and the streaming design ``extra_stream`` more) and no other
        kernel launched. Returns fn's result, the launches by design and
        the wall seconds."""
        K.launches = 0
        K.launches_by_design.update(point=0, stream=0)
        probe_launches(zero=True)
        k2 = K.selftest_launches
        tic = time.perf_counter()
        out = fn()
        sync(device)
        wall = time.perf_counter() - tic
        by = dict(K.launches_by_design)
        want = {d: on_card * (steps * sum(p.design == d for p in plans)
                              + (extra_stream if d == 'stream' else 0))
                for d in ('stream', 'point')}
        if by != want or K.launches != sum(by.values()):
            raise AssertionError(f"{label} launched K1 {by} times, not "
                                 f"{want}")
        off = {n: c for n, c in probe_launches().items() if c}
        if off or K.selftest_launches != k2:
            raise AssertionError(f"{label} launched kernels off its path: "
                                 f"{off}, K2 {K.selftest_launches - k2}")
        paths[label] = by
        return out, by, wall

    def finite_nonzero(label, a):
        a = np.asarray(a)
        if not (np.isfinite(a).all() and np.abs(a).max() > 0):
            raise AssertionError(f"{label} is not finite and non-zero")
        return float(np.linalg.norm(a))

    # -- (a) the adjoint of the forward shot's record ---------------------
    aop = solver.op_adj()
    (_, aplan), = aop.kernel_plans
    rec = solver.geometry.rec
    rec.data[:] = shot
    (srca, _, asum), by, wall = drive(
        'adjoint', lambda: solver.adjoint(rec), [aplan], nsteps)
    loop = asum.globals['fdlike'].time
    inv['adjoint'] = dict(
        design=aplan.design, design_reason=aplan.design_reason,
        ms_per_step=loop * 1e3 / nsteps, wall_s=wall,
        srca_norm=finite_nonzero('adjoint: srca', srca.data))
    log(f"[adjoint] {nf}^3 SO=8 fp32, {nsteps} steps back from the forward "
        f"shot's {rec.npoint} receivers: v.backward in the {aplan.design} "
        f"design ({aplan.design_reason}); launches stream {by['stream']}, "
        f"point {by['point']} (one streaming launch a step); loop "
        f"{loop * 1e3 / nsteps:.3f} ms/step; wall {wall:.2f} s; srca "
        f"norm {inv['adjoint']['srca_norm']:.6g}")
    k = sizes['inc_steps']
    inv['adjoint']['measured'] = measured(
        lambda: solver.adjoint(rec, time_m=nsteps + 1 - k), aop, k,
        device)[1]
    log_measured('adjoint', inv['adjoint']['measured'])
    del srca, rec
    release(device)

    # -- (b) smooth, then Born about the smoothed model ---------------------
    splan = smooth_plan(vp0, solver.model.vp)
    _, by, wall = drive('smooth', lambda: smooth(vp0, solver.model.vp),
                        [splan], 1)
    log(f"[born] smooth(vp0, vp) at {nf}^3: one launch in the "
        f"{splan.design} design ({splan.design_reason}), wall {wall:.2f} s")
    dm = Function(name='dm', grid=solver.model.grid, space_order=0)
    dm.data[:] = 1e-3 * rng.standard_normal(dm.shape, dtype=np.float32)
    bop = solver.op_born()
    bplans = [p for _, p in bop.kernel_plans]
    (lin, u, U, bsum), by, wall = drive(
        'born', lambda: solver.jacobian(dm, vp=vp0), bplans, nsteps)
    del u, U
    loop = bsum.globals['fdlike'].time
    inv['born'] = dict(
        designs={eq.target.name: (p.design, p.design_reason)
                 for eq, p in bop.kernel_plans},
        ms_per_step=loop * 1e3 / nsteps, wall_s=wall,
        rec_norm=finite_nonzero('Born: the linearized record', lin.data))
    log(f"[born] {nsteps} steps about smooth(vp), dm seeded normal x 1e-3: "
        + '; '.join(f"{eq.target.name}.forward in the {p.design} design "
                    f"({p.design_reason})" for eq, p in bop.kernel_plans)
        + f"; launches stream {by['stream']}, point {by['point']} ("
        f"{by['stream'] // max(nsteps, 1)} + {by['point'] // max(nsteps, 1)}"
        f" a step, as the plans imply); loop {loop * 1e3 / nsteps:.3f} "
        f"ms/step; wall {wall:.2f} s; linearized record norm "
        f"{inv['born']['rec_norm']:.6g}")
    inv['born']['measured'] = measured(
        lambda: solver.jacobian(dm, vp=vp0, time_M=k), bop, k, device)[1]
    log_measured('born', inv['born']['measured'])
    release(device)

    # -- (c) the checkpointed gradient of Born's record ----------------------
    gop, fop = solver.op_grad(save=False), solver.op_fwd(save=False)
    gplan, fplan = gop.kernel_plans[0][1], fop.kernel_plans[0][1]
    (inc_eq,) = [eq for eq, p in gop.kernel_plans if p is None]
    made, revolver = [], CK.Revolver

    class Timed(revolver):
        """The Revolver, with the wall seconds of its two sweeps."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def apply_forward(self):
            tic = time.perf_counter()
            super().apply_forward()
            sync(device)
            self.forward_s = time.perf_counter() - tic

        def apply_reverse(self):
            tic = time.perf_counter()
            super().apply_reverse()
            sync(device)
            self.reverse_s = time.perf_counter() - tic

    # the Revolver's default: sqrt(nt) snapshots, the optimal count + 1
    ncp = max(1, int(np.sqrt(nsteps)))
    opt = CK.optimal_forward_count(nsteps, ncp - 1)
    CK.Revolver = Timed
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device) if on_card else None
    try:
        (grad, _), by, wall = drive(
            'gradient', lambda: solver.jacobian_adjoint(
                lin, None, vp=vp0, checkpointing=True), [gplan], nsteps,
            extra_stream=(opt + 1) * len(fop.kernel_plans))
    finally:
        CK.Revolver = revolver
    (rv,) = made
    if (rv.n_checkpoints, rv.nt, rv.forward_steps) != (ncp, nsteps, opt + 1):
        raise AssertionError(f"Revolver: {rv.n_checkpoints} snapshots, "
                             f"{rv.forward_steps} forward steps over "
                             f"{rv.nt}, not {ncp}, {opt} + 1 over {nsteps}")
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    snap_bytes = rv.n_checkpoints * rv.cp.size * 4
    g = finite_nonzero('the gradient', grad.data)
    t1, t2 = inner(grad, dm), norm(lin) ** 2
    inv['gradient'] = dict(
        snapshots=rv.n_checkpoints, snapshot_bytes=snap_bytes,
        max_memory_allocated=peak, memory_allocated_before=held,
        forward_steps=rv.forward_steps,
        reverse_recompute_steps=rv.reverse_recompute_steps,
        optimal_forward_count=opt, forward_sweep_s=rv.forward_s,
        reverse_sweep_s=rv.reverse_s,
        reverse_ms_per_step=rv.reverse_s * 1e3 / nsteps, wall_s=wall,
        grad_norm=g, dot_J_fp32=(t1 - t2) / t1)
    log(f"[gradient] checkpointed, {rv.nt} steps, {rv.n_checkpoints} "
        f"snapshots of u ({snap_bytes / 1e9:.2f} GB on the device); peak "
        f"device memory {peak / 1e9 if peak else float('nan'):.2f} GB "
        f"(torch.cuda.max_memory_allocated), of it "
        f"{held / 1e9 if held else float('nan'):.2f} GB allocated before the "
        f"call; Revolver forward_steps "
        f"{rv.forward_steps} = optimal_forward_count({rv.nt}, "
        f"{rv.n_checkpoints - 1}) {opt} + 1, reverse_recompute_steps "
        f"{rv.reverse_recompute_steps}; launches stream {by['stream']} = "
        f"{rv.forward_steps} forward + {rv.nt} reverse, point "
        f"{by['point']}; gradient's v.backward {gplan.design}, its Inc "
        f"declined ({K.decline_reason(inc_eq)}): the torch translator")
    log(f"[gradient] forward sweep {rv.forward_s:.2f} s, reverse sweep "
        f"{rv.reverse_s:.2f} s = {rv.reverse_s * 1e3 / nsteps:.3f} ms a "
        f"reversed step; wall {wall:.2f} s; gradient norm {g:.6g}; "
        f"<dm, J^T J dm> against |J dm|^2 in fp32: {(t1 - t2) / t1:.3e}")

    # the increment alone, and whole reverse steps, under torch.profiler
    v = TimeFunction(name='v', grid=solver.model.grid, time_order=2,
                     space_order=8)
    args = dict(rec=lin, grad=grad, v=v, vp=vp0, dt=solver.dt)
    bufs, params = gop.arguments(**args)

    def incs():
        for t in range(1, k + 1):
            _exec_dense(inc_eq, None, bufs, params, t)

    def reverse_steps():
        for t in range(nsteps, nsteps - k, -1):
            gop.apply(time_m=t, time_M=t, **args)
    inc = step_kernels('Inc(grad, -u*v.dt2)', profiled(incs, device), k)
    step = step_kernels('a reverse step', profiled(reverse_steps, device), k)
    inc_ms, step_ms = inc['busy_ms_per_step'], step['busy_ms_per_step']
    inc_event_ms = time_ms(incs, 1, device) / k
    # u, v[t-1], v[t], v[t+1] and grad read, grad written, once each
    inc_bound = bound_ms(6 * 4 * nf ** 3, 0)[0]
    inv['gradient'].update(
        inc_device_ms_per_step=inc_ms, inc_event_ms_per_step=inc_event_ms,
        reverse_step_device_ms=step_ms,
        inc_share=inc_ms / step_ms if step_ms else None,
        inc_bound_ms=inc_bound, inc_kernels=inc['kernels'],
        reverse_step_kernels=step['kernels'])
    log(f"[gradient] Inc(grad, -u*v.dt2) at {nf}^3: device time "
        f"{inc_ms:.4f} ms a step (torch.profiler; CUDA events "
        f"{inc_event_ms:.4f} ms) = {100 * inc_ms / (step_ms or 1):.1f} % of "
        f"a reverse step's {step_ms:.4f} ms device time; the bytes it "
        f"needs bound it at {inc_bound:.4f} ms")
    del grad, lin, dm, v, bufs, params, args
    release(device)
    for by in paths.values():
        record['launches'] += sum(by.values())
        for d in by:
            record['launches_by_design'][d] += by[d]
    record['launches_main_path'] = record['launches']

    # -- (d) fp64 checks at a small size --------------------------------------
    inv['fp64'] = inverse_fp64(device, sizes, small, rng)


def inverse_fp64(device, sizes, small, rng):
    """Phase 9 (d) on ``small`` (fp64): the F and J dot tests, the
    checkpointed gradient against the full-save one, and the adjoint's and
    the full-save gradient's results against the same operators on the
    plain versions (the CPU), from the same inputs."""
    from devito_tpu_torch import Function, switchconfig
    from devito_tpu_torch.builtins import inner, norm
    n = sizes['inv_n'] + 2 * sizes['fwd_nbl']
    rec = small.forward(save=False)[0]
    srca = small.adjoint(rec)[0]
    t1, t2 = inner(srca, small.geometry.src), norm(rec) ** 2
    dot_f = (t1 - t2) / t1
    dm = Function(name='dm', grid=small.model.grid, space_order=0)
    dm.data[:] = 1e-2 * rng.standard_normal(dm.shape)
    du = small.jacobian(dm)[0]
    u0 = small.forward(save=True)[1]
    g_full = np.array(small.jacobian_adjoint(du, u0)[0].data)
    t1 = float(np.dot(g_full.ravel(), np.asarray(dm.data).ravel()))
    t2 = norm(du) ** 2
    dot_j = (t1 - t2) / t1
    g_ck = np.array(small.jacobian_adjoint(du, None,
                                           checkpointing=True)[0].data)
    ck_diff = float(np.abs(g_ck - g_full).max())
    with switchconfig(device='cpu'):
        plain = forward_solver(sizes['inv_n'], sizes['fwd_nbl'],
                               sizes['inv_tn'], sizes['inv_nrec'],
                               np.float64)
        prec = plain.geometry.rec
        prec.data[:] = np.array(rec.data)
        s_plain = np.array(plain.adjoint(prec)[0].data)
        pdu = plain.geometry.rec
        pdu.data[:] = np.array(du.data)
        pu0 = plain.forward(save=True)[1]
        g_plain = np.array(plain.jacobian_adjoint(pdu, pu0)[0].data)
    s_card = np.array(srca.data)
    err_s = float(np.abs(s_card - s_plain).max())
    err_g = float(np.abs(g_full - g_plain).max())
    tol = RUN_TOL[np.float64]
    res = dict(n=n, steps=small.geometry.nt - 2, dot_F=dot_f, dot_J=dot_j,
               ck_minus_full=ck_diff, ck_bit_equal=ck_diff == 0.,
               adjoint_vs_plain=err_s, gradient_vs_plain=err_g,
               srca_max=float(np.abs(s_plain).max()),
               grad_max=float(np.abs(g_plain).max()))
    log(f"[inverse-fp64] {n}^3 SO=8 fp64, {res['steps']} steps: dot test "
        f"F {dot_f:.3e} (atol 1e-11), J {dot_j:.3e} (atol 1e-12); "
        f"checkpointed - full-save gradient: max|diff| {ck_diff:.3e}"
        + (" (bit-equal)" if ck_diff == 0 else "")
        + f"; against the plain versions on the CPU: srca max|diff| "
        f"{err_s:.3e} of {res['srca_max']:.3e}, gradient {err_g:.3e} of "
        f"{res['grad_max']:.3e} (tolerance {tol:g} x max)")
    if not (abs(dot_f) <= 1e-11 and abs(dot_j) <= 1e-12):
        raise AssertionError(f"fp64 dot tests: F {dot_f:.3e}, J {dot_j:.3e}")
    if not ck_diff <= TOL[np.float64] * np.abs(g_full).max():
        raise AssertionError(f"checkpointed gradient differs from the "
                             f"full-save one by {ck_diff:.3e}")
    if not (err_s <= tol * res['srca_max'] and
            err_g <= tol * res['grad_max'] and res['grad_max'] > 0):
        raise AssertionError(f"fp64 adjoint/gradient against the plain "
                             f"versions: {err_s:.3e}, {err_g:.3e}")
    return res


# -- 10. the TTI path --------------------------------------------------------

#: The kinds of K1 launches on the TTI path, by the item of the schedule
#: they run.
TTI_KINDS = ('body update', 'CIRE temporary', 'hoisted prologue item',
             'interpolation temporary')


def tti_solver(shape, so, nbl, steps, nrec, dtype=np.float32,
               kernel='centered', spacing=20., model=None, **kwargs):
    """AnisotropicWaveSolver on tti_setup's layered TTI model at ``shape``
    (+``nbl``), ``spacing`` m, ``so``, in ``dtype`` (or on ``model``),
    running ``steps`` steps: a 10 Hz Ricker at the centre of the surface,
    2 spacings deep, and ``nrec`` receivers along x at y centre (2-D: at
    the surface), 2 spacings deep. ``kwargs`` go to its operators
    (``opt``)."""
    from devito_tpu_torch.models.seismic import (
        AcquisitionGeometry, AnisotropicWaveSolver, tti_setup)
    if model is None:
        model = tti_setup(shape=shape, spacing=(spacing,) * len(shape),
                          tn=1., space_order=so, nbl=nbl, dtype=dtype,
                          kernel=kernel).model
    ext = [spacing * (n - 1) for n in shape]
    src = np.array([[e / 2 for e in ext[:-1]] + [2 * spacing]])
    rec = np.stack([np.linspace(0, ext[0], nrec)] +
                   [np.full(nrec, e / 2) for e in ext[1:-1]] +
                   [np.full(nrec, 2 * spacing)], 1)
    # the time axis has ceil((tn + dt) / dt) = steps + 2 rows
    geom = AcquisitionGeometry(model, rec, src, 0., (steps + .5) *
                               model.critical_dt, f0=0.010,
                               src_type='Ricker')
    return AnisotropicWaveSolver(model, geom, space_order=so, kernel=kernel,
                                 **kwargs)


def tti_kinds(op):
    """(kind, lowered eq, plan or None) of every dense item of ``op``'s
    schedule, ``kind`` one of TTI_KINDS."""
    plans = {id(eq): p for eq, p in op.kernel_plans}
    out = []
    for sec in ('prologue', 'body', 'epilogue'):
        for it in getattr(op.schedule, sec):
            if not hasattr(it, 'region'):
                continue
            kind = ('hoisted prologue item' if sec != 'body' else
                    'body update' if not it.target._compiler_temp else
                    'interpolation temporary'
                    if it.target.name.endswith('_itmp') else
                    'CIRE temporary')
            out.append((kind, it, plans[id(it)]))
    return out


def units(kinds):
    """The entries of ``kinds`` (tti_kinds' triples) that launch a K1
    unit: every one but the later equations of a fused unit
    (kernels/stencil.py ``plan_run``), whose unit launches at its first
    equation, once for all of them; a declined equation's too."""
    return [(k, eq, p) for k, eq, p in kinds if p is None or p.eq is eq]


def unit_name(plan):
    """A unit's targets: one, or a fused unit's, joined by ``+``."""
    return '+'.join(e.target.name for e in plan.eqs)


def trig_taps_on(op):
    """True when ``op``'s time loop reads no sin or cos of a field: its
    transcendentals of the tilt fields were hoisted (hoist-trig-taps)."""
    import sympy
    return not any(sympy.sympify(it.rhs).atoms(sympy.sin, sympy.cos)
                   for it in op.schedule.body if hasattr(it, 'region'))


def loop_steps(op):
    """Steps of ``op``'s time loop under its default time bounds."""
    tm, tM = op._default_time_bounds()
    return tM - tm + 1


def tti_drive(label, fn, kinds, steps, device):
    """``fn()`` with every count at 0 just before it and read just after;
    raises unless each body plan launched its design ``steps`` times and
    each prologue plan once -- a fused unit's plan once a step for all its
    equations -- and no other kernel launched. Returns fn's result, the
    launches by kind (of each unit's first equation) and the wall
    seconds."""
    from devito_tpu_torch.kernels import stencil as K
    on_card = int(device.type == 'cuda')
    for _, _, p in kinds:
        p.launches = 0
    K.launches = 0
    K.launches_by_design.update(point=0, stream=0)
    probe_launches(zero=True)
    k2 = K.selftest_launches
    tic = time.perf_counter()
    out = fn()
    sync(device)
    wall = time.perf_counter() - tic
    by_kind = {k: 0 for k in TTI_KINDS}
    by_design = {'point': 0, 'stream': 0}
    for kind, eq, p in kinds:
        want = on_card * (1 if kind == 'hoisted prologue item' else steps)
        if p.launches != want:
            raise AssertionError(f"{label}: {eq!r} launched {p.launches} "
                                 f"times, not {want}")
    for kind, eq, p in units(kinds):
        by_kind[kind] += p.launches
        by_design[p.design] += p.launches
    if K.launches_by_design != by_design or \
            K.launches != sum(by_kind.values()):
        raise AssertionError(f"{label}: K1 launched {K.launches_by_design}, "
                             f"not {by_design}")
    off = {n: c for n, c in probe_launches().items() if c}
    if off or K.selftest_launches != k2:
        raise AssertionError(f"{label} launched kernels off its path: {off}")
    return out, by_kind, wall


def point_alts(kinds):
    """{id(plan): the same equation's point-design plan} of every
    streaming plan of ``kinds``, for ``launch_ms``'s comparison."""
    from devito_tpu_torch.kernels import stencil as K
    return {id(p): K.plan_for(eq, _design='point') for _, eq, p in kinds
            if p is not None and p.design == 'stream'}


def check_tti_plans(label, kinds):
    """Log each K1 unit of ``kinds`` with its design and why, and every
    decline with its reason; raise when a dense equation runs in the
    translator. Which design a unit takes is K1's rule
    (kernels/stencil.py), held by the CPU tests."""
    from devito_tpu_torch.kernels import stencil as K
    bad = [(k, eq.target.name, K.decline_reason(eq)) for k, eq, p in kinds
           if p is None]
    for k, name, why in bad:
        log(f"[tti] {label}: {k} {name} declined: {why}")
    log(f"[tti] {label}: " + '; '.join(
        f"{k} {unit_name(p)} {p.design} ({p.design_reason})"
        for k, _, p in units(kinds) if p is not None))
    if bad:
        raise AssertionError(f"{label}: a dense equation runs in the "
                             f"translator: {bad}")


def halo_cases(device, ops, gen):
    """Phase 10 (1): each halo-extended item of ``ops`` ((label, operator)
    pairs) -- CIRE's temporaries and the hoisted prologue items -- through
    K1 on seeded rows against its plain version on the same rows; raises
    beyond TOL x max |plain|. Returns a row per item."""
    from devito_tpu_torch.compiler.executor import plan_rows
    from devito_tpu_torch.kernels import stencil as K
    rows = []
    for label, op in ops:
        bufs, params = op.arguments(time_M=1, dt=0.1)
        # new seeded tensors: the functions' own keep their values
        bufs = {n: torch.rand(b.shape, generator=gen, device=device,
                              dtype=b.dtype)
                if b.is_floating_point() and not n.endswith('_coords')
                else b for n, b in bufs.items()}
        for kind, eq, plan in units(tti_kinds(op)):
            if eq.region[0][0] >= 0:
                continue
            t = None if kind == 'hoisted prologue item' else 1
            out, ins = plan_rows(plan, bufs, t, params)
            err, tol = held(f"halo-extended {label}", plan, (out, ins),
                            params, device)
            rows.append(dict(case=label, item=f'{kind} {unit_name(plan)}',
                             region=eq.region, max_abs_err=err, tol=tol))
            log(f"[tti-halo] {label}: {kind} {unit_name(plan)} over "
                f"{eq.region}: max|kernel - plain| {err:.3e} (tolerance "
                f"{tol:.3e})")
        del bufs
    return rows


def tti_gather_ms(solver, kinds, u, v, device):
    """The receivers' interpolation of ``solver``'s forward, both ways, on
    the rows of step 1 of ``u`` and ``v`` (``time_ms``, 3 calls after a
    warm-up): as its schedule runs it under devito_tpu's 4096-corner rule
    (K1 writes the sampled expression into ``<rec>_itmp``, and the points
    gather from it), and the direct gather of the sampled expression from
    the fields, which the schedule runs below that rule. None when the
    schedule has no interpolation temporary. Raises unless both ways give
    the same record."""
    import copy
    from devito_tpu_torch.compiler.executor import _exec_sparse, plan_rows
    from devito_tpu_torch.kernels import stencil as K
    tmp = [(eq, p) for kind, eq, p in kinds
           if kind == 'interpolation temporary']
    if not tmp:
        return None
    (teq, plan), = tmp
    op = solver.op_fwd(None)
    item = next(it for it in op.schedule.body
                if getattr(it, 'kind', None) == 'interp'
                and getattr(it.expr, 'name', None) == teq.target.name)
    direct = copy.copy(item)
    direct.expr = teq.rhs
    bufs, params = op.arguments(time_M=1, dt=solver.dt, u=u, v=v)
    rows = plan_rows(plan, bufs, 1, params)
    geom = {}
    rec = bufs[item.sparse.name][1 + item.target_time_off]

    def record(it):
        _exec_sparse(it, bufs, params, 1, geom)
        return rec.clone()

    out = dict(npoint=item.sparse.npoint,
               itmp_ms=time_ms(lambda: K.stencil_update(plan, rows, params),
                               3, device))
    want = record(item)
    out['gather_ms'] = time_ms(lambda: record(item), 3, device)
    got = record(direct)
    out['direct_ms'] = time_ms(lambda: record(direct), 3, device)
    out['max_abs_diff'] = float((got - want).abs().max())
    tol = RUN_TOL[np.float32] * float(want.abs().max())
    if not out['max_abs_diff'] <= tol:
        raise AssertionError(f"the direct gather differs from the gather "
                             f"from {teq.target.name} by "
                             f"{out['max_abs_diff']:.3e} (tolerance "
                             f"{tol:.3e})")
    return out


def tti(device, sizes, record, gen):
    """Phase 10, the TTI path: (1) K1's point design on halo-extended
    regions against its plain version; (2) the centered forward at the
    canonical shape, driven with every count at 0 just before and read
    just after (each unit launched once a step, as its plan implies), each
    unit at that shape held against its plain version and timed beside
    its point design, and again with hoist-trig-taps forced the other way,
    the two settings timed warm in turns; (3) the forward at tti_cmp_n^3
    against the plain version on the CPU; (4) the staggered kernel's
    forward; (5) the fp64 dot tests F and J. Adds the canonical forward's
    launches, by design, to K1's ``record``."""
    from devito_tpu_torch import switchconfig
    from devito_tpu_torch.builtins import inner, norm
    from devito_tpu_torch.kernels import stencil as K
    from devito_tpu_torch.models.seismic import tti_setup
    from concurrent.futures import ThreadPoolExecutor
    on_card = device.type == 'cuda'
    res = record['tti'] = {}
    release(device)
    if on_card:
        res['held_at_start'] = torch.cuda.memory_allocated(device)
        log(f"[tti] device memory allocated at the start of phase 10: "
            f"{res['held_at_start'] / 1e9:.2f} GB")
    shape, nbl, so = sizes['tti_shape'], sizes['tti_nbl'], sizes['tti_so']
    steps, h = sizes['tti_steps'], sizes['tti_spacing']
    cn, cso, csteps = sizes['tti_cmp_n'], sizes['tti_cmp_so'], \
        sizes['tti_cmp_steps']
    cshape, dshape = (cn,) * 3, sizes['tti_dot_shape']

    # -- every operator of the phase, and all their kernels built at once --
    tic = time.perf_counter()
    main = tti_solver(shape, so, nbl, steps, sizes['tti_nrec'], spacing=h)
    fop = main.op_fwd(None)
    auto_on = trig_taps_on(fop)
    forced = tti_solver(shape, so, nbl, steps, sizes['tti_nrec'], spacing=h,
                        model=main.model,
                        opt=('advanced', {'hoist-trig-taps': not auto_on}))
    fop2 = forced.op_fwd(None)
    if trig_taps_on(fop2) == auto_on:
        raise AssertionError("hoist-trig-taps forced the other way left the "
                             "schedule as it was")
    small = tti_solver(cshape, cso, nbl, csteps, cn)
    stag = tti_solver((sizes['tti_stag_n'],) * 3, sizes['tti_stag_so'], nbl,
                      sizes['tti_stag_steps'], sizes['tti_stag_n'],
                      kernel='staggered')
    # the dot tests' solver as tests/test_adjoint.py builds it
    dot = tti_setup(shape=dshape, spacing=(15.,) * len(dshape), nbl=nbl,
                    tn=sizes['tti_dot_tn'], space_order=sizes['tti_dot_so'],
                    dtype=np.float64)
    halo_ops = [(f'2-D {sizes["tti_2d_shape"]} SO=8 {np.dtype(d).name}',
                 tti_solver(sizes['tti_2d_shape'], 8, nbl, 1, 64, dtype=d,
                            opt=('advanced', {'hoist-trig-taps': True}))
                 .op_fwd(None)) for d in (np.float32, np.float64)]
    halo_ops += [(f'3-D {cn}^3 SO={cso} float32', small.op_fwd(None)),
                 (f'3-D {dshape} SO={sizes["tti_dot_so"]} float64',
                  dot.op_fwd(None))]
    ops = {'forward': fop, 'forward, trig taps forced': fop2,
           f'{cn}^3 forward': small.op_fwd(None),
           'staggered forward': stag.op_fwd(None),
           'dot F': dot.op_fwd(False), 'dot F adjoint': dot.op_adj(),
           'dot J forward (save)': dot.op_fwd(True),
           'dot J Born': dot.op_jac(), 'dot J gradient': dot.op_jacadj(True)}
    ops.update(halo_ops)
    lower_s = time.perf_counter() - tic
    kinds = {lab: tti_kinds(op) for lab, op in ops.items()}
    for lab in ('forward', 'forward, trig taps forced', f'{cn}^3 forward',
                'staggered forward'):
        check_tti_plans(lab, kinds[lab])
    # each streaming unit of the canonical forward beside its point design
    alts = {lab: point_alts(kinds[lab])
            for lab in ('forward', 'forward, trig taps forced')}
    plans = [p for ks in kinds.values() for _, _, p in ks if p is not None]
    plans += [p for a in alts.values() for p in a.values()]
    uniq = list({p.key: p for p in plans}.values())
    nvcc_s = 0.
    if on_card:
        tic = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(K.build, uniq))
        nvcc_s = sum(K.build_seconds.get(p.key, 0.) for p in uniq)
        log(f"[tti-build] {len(uniq)} K1 units in "
            f"{time.perf_counter() - tic:.2f} s wall (nvcc {nvcc_s:.2f} s); "
            f"the operators' lowering took {lower_s:.2f} s")
    built = [dict(op=lab, kind=k, target=eq.target.name, key=p.key,
                  nvcc_s=K.build_seconds.get(p.key),
                  ptxas=ptxas(K.build_log.get(p.key, '')))
             for lab in ('forward', 'forward, trig taps forced')
             for k, eq, p in kinds[lab]]
    for u in built:
        log(f"[tti-unit] {u['op']}: {u['kind']} {u['target']}: nvcc "
            f"{u['nvcc_s'] or 0:.2f} s; {u['ptxas'] or 'no ptxas report'}")
    res.update(units=built, nvcc_s=nvcc_s, lower_s=lower_s,
               n_units=len(uniq))
    del plans, uniq     # they would keep every operator's temporaries

    # -- (1) K1's point design on halo-extended regions -------------------
    res['halo'] = halo_cases(device, halo_ops, gen)
    release(device)

    # -- (2) the canonical forward ------------------------------------------
    nf = tuple(n + 2 * nbl for n in shape)
    fk, k2 = kinds['forward'], kinds['forward, trig taps forced']
    (rec, u, v, _), by_kind, _ = tti_drive(
        'TTI forward', main.forward, fk, loop_steps(fop), device)
    r = np.array(rec.data)
    if not (np.isfinite(r).all() and np.abs(r).max() > 0):
        raise AssertionError("TTI forward: the shot record is not finite "
                             "and non-zero")
    designs = by_design(fk)
    record['launches'] += sum(by_kind.values())
    for d, c in designs.items():
        record['launches_by_design'][d] += c
    record['launches_main_path'] = record['launches']
    record.setdefault('launches_by_path', {})['tti forward'] = by_kind
    # each unit at this shape against its plain version, the streaming
    # ones also on the point design
    per_eq = launch_ms(fop, fk, dict(u=u, v=v), main.dt, device, gen,
                       alts['forward'])
    del rec, u, v
    release(device)
    (rec2, u2, v2, _), by2, _ = tti_drive(
        'TTI forward, trig taps forced', forced.forward, k2, loop_steps(fop2),
        device)
    forced_eqs = launch_ms(forced.op_fwd(None), k2, dict(u=u2, v=v2),
                           forced.dt, device, gen,
                           alts['forward, trig taps forced'])
    gather = tti_gather_ms(forced, k2, u2, v2, device)
    del u2, v2
    r2 = np.array(rec2.data)
    diff = float(np.abs(r2 - r).max())
    if not diff <= RUN_TOL[np.float32] * np.abs(r).max():
        raise AssertionError(f"the two hoist-trig-taps settings give shot "
                             f"records {diff:.3e} apart")
    del rec2, r2
    # hoist-trig-taps' 'auto' against the setting forced the other way
    # (ir/optimize.py), warm, in turns: 'auto', forced, forced, 'auto'
    warm = {True: [], False: []}
    turns = [(main, auto_on), (forced, not auto_on)]
    for sv, setting in turns + turns[::-1]:
        warm[setting].append(
            sv.forward()[3].globals['fdlike'].time * 1e3 / steps)
    ms = {k: float(np.mean(v)) for k, v in warm.items()}
    nbody = sum(k != 'hoisted prologue item' for k, _, _ in fk)
    nstream = sum(p.design == 'stream' for k, _, p in units(fk)
                  if k != 'hoisted prologue item')
    res['forward'] = dict(
        shape=nf, so=so, steps=steps, nrec=r.shape[1],
        hoist_trig_taps_auto=auto_on, launches_by_kind=by_kind,
        launches_by_design=designs, launches_per_step=nbody,
        stream_launches_per_step=nstream, per_equation=per_eq,
        rec_norm=float(np.linalg.norm(r)))
    res['forward_forced'] = dict(
        hoist_trig_taps=not auto_on, launches_by_kind=by2,
        rec_max_abs_diff=diff, per_equation=forced_eqs,
        receiver_gather=gather)
    res['hoist_trig_taps'] = dict(auto=auto_on, ms_per_step=ms[auto_on],
                                  forced_ms_per_step=ms[not auto_on],
                                  warm_runs={str(k): v
                                             for k, v in warm.items()})
    log(f"[tti] forward {shape} (+nbl {nbl}: {nf}) SO={so} fp32, {steps} "
        f"steps, {r.shape[1]} receivers, hoist-trig-taps 'auto' -> "
        f"{auto_on}: K1 launches by kind {by_kind} ({nbody} equations a step, "
        f"{nstream} of them on the streaming design), by design {designs}, "
        f"no equation in the translator; rec norm {np.linalg.norm(r):.6g}")
    for lab, eqs in (('auto', per_eq), ('forced', forced_eqs)):
        log(f"[tti] a launch by unit, hoist-trig-taps {lab}, held against "
            f"its plain version and timed alone (CUDA events): " + '; '.join(
                f"{e['kind']} {e['target']} {e['design']} {e['ms']:.3f} ms"
                + (f" (point {e['point_ms']:.3f})" if 'point_ms' in e
                   else '') for e in eqs))
    log(f"[tti] hoist-trig-taps, warm, in turns ('auto' = {auto_on}, "
        f"forced, forced, 'auto'): {auto_on} "
        f"{[round(w, 3) for w in warm[auto_on]]} ms/step, "
        f"{not auto_on} {[round(w, 3) for w in warm[not auto_on]]} "
        f"ms/step; launches by kind with it forced {by2}; rec max|diff| "
        f"between the two {diff:.3e}")
    if gather:
        log(f"[tti] the receivers' interpolation, {gather['npoint']} "
            f"points (CUDA events on the card): K1's {gather['itmp_ms']:.4f}"
            f" ms for the dense temporary and {gather['gather_ms']:.4f} ms "
            f"for the gather from it, as the schedule runs it under the "
            f"4096-corner rule; the direct gather from the fields "
            f"{gather['direct_ms']:.4f} ms; max|diff| "
            f"{gather['max_abs_diff']:.3e}")
    del r, main, fop, forced, fop2, turns, sv, k2, alts
    ops.pop('forward')
    ops.pop('forward, trig taps forced')
    kinds.pop('forward')
    kinds.pop('forward, trig taps forced')
    release(device)

    # -- (3) the forward at cn^3 against the plain version on the CPU -----
    rk = np.array(small.forward()[0].data)
    with switchconfig(device='cpu'):
        plain = tti_solver(cshape, cso, nbl, csteps, cn)
        rp = np.array(plain.forward()[0].data)
    err = float(np.abs(rk - rp).max())
    tol = RUN_TOL[np.float32] * float(np.abs(rp).max())
    if not (err <= tol and tol > 0):
        raise AssertionError(f"TTI forward at {cn}^3: kernel and plain recs "
                             f"differ by {err:.3e} > {tol:.3e}")
    res['compare'] = dict(n=cn, so=cso, steps=csteps, max_abs_diff=err,
                          tol=tol, rec_norm=float(np.linalg.norm(rk)))
    log(f"[tti] {cn}^3 (+nbl {nbl}) SO={cso} fp32, {csteps} steps: rec "
        f"through the kernels vs the plain version (CPU): max|diff| "
        f"{err:.3e} (tolerance {tol:.3e}), rec norm "
        f"{np.linalg.norm(rk):.6g}")
    del small, plain
    release(device)

    # -- (4) the staggered kernel's forward ----------------------------------
    ks = kinds['staggered forward']
    # the first-order system's loop runs from t = 0: one step more
    sst = loop_steps(stag.op_fwd(None))
    (srec, _, _, ssum), sby, swall = tti_drive(
        'staggered TTI forward', stag.forward, ks, sst, device)
    sr = np.array(srec.data)
    if not (np.isfinite(sr).all() and np.abs(sr).max() > 0):
        raise AssertionError("staggered TTI forward: the shot record is not "
                             "finite and non-zero")
    sloop = ssum.globals['fdlike'].time * 1e3 / sst
    designs = {eq.target.name: p.design for _, eq, p in ks}
    res['staggered'] = dict(n=sizes['tti_stag_n'], so=sizes['tti_stag_so'],
                            steps=sst, loop_ms_per_step=sloop,
                            launches_by_kind=sby, designs=designs,
                            rec_norm=float(np.linalg.norm(sr)))
    log(f"[tti] staggered forward {sizes['tti_stag_n']}^3 (+nbl {nbl}) "
        f"SO={sizes['tti_stag_so']} fp32, {sst} steps: loop {sloop:.3f} "
        f"ms/step, K1 launches by kind {sby}, designs {designs}, rec norm "
        f"{np.linalg.norm(sr):.6g}")
    del stag, srec, sr
    release(device)

    # -- (5) the fp64 dot tests through the kernels --------------------------
    rec = dot.forward(save=False)[0]
    srca = dot.adjoint(rec)[0]
    t1, t2 = inner(srca, dot.geometry.src), norm(rec) ** 2
    dot_f = (t1 - t2) / t1
    vp = np.asarray(dot.model.vp.data)
    dm = vp ** -2 - np.full_like(vp, 1.5) ** -2
    lin = dot.jacobian(dm)[0]
    t2 = norm(lin) ** 2
    _, u0, v0, _ = dot.forward(save=True)
    im = dot.jacobian_adjoint(lin, u0, v0)[0]
    t1 = float(np.dot(np.asarray(im.data).ravel(), dm.ravel()))
    dot_j = (t1 - t2) / t1
    res['dot'] = dict(shape=dshape, so=sizes['tti_dot_so'],
                      steps=dot.geometry.nt - 2, F=float(dot_f),
                      J=float(dot_j))
    log(f"[tti-fp64] {dshape} (+nbl {nbl}) SO={sizes['tti_dot_so']} fp64, "
        f"{dot.geometry.nt - 2} steps, through the kernels: dot test F "
        f"{dot_f:.3e} (atol 1e-11), J {dot_j:.3e} (atol 1e-12)")
    if not (abs(dot_f) <= 1e-11 and abs(dot_j) <= 1e-12):
        raise AssertionError(f"TTI fp64 dot tests: F {dot_f:.3e}, J "
                             f"{dot_j:.3e}")
    del dot, rec, srca, lin, u0, v0, im
    release(device)
    return res


#: Phase 11's solvers at full width and their space orders.
SOLVERS = {'elastic': 4, 'viscoelastic': 4, 'viscoacoustic sls-2': 4,
           'self-adjoint': 8}
#: The viscoacoustic kernels, (rheology, time order), as
#: models/seismic/viscoacoustic.py ``stencils`` names them.
VISCO = [(k, o) for k in ('sls', 'kv', 'maxwell') for o in (1, 2)]


def precomputed_rec(geom, name='rec', coordinates=None):
    """A receiver set of ``geom`` as a precomputed sparse function: each
    point's minimum corner and the linear weights of its two points an
    axis, computed on the host from the geometry's positions."""
    from devito_tpu_torch import PrecomputedSparseTimeFunction
    grid = geom.grid
    pos = (np.asarray(coordinates if coordinates is not None else
                      geom.rec_positions) - np.array(grid.origin)) / \
        np.array(grid.spacing, dtype=np.float64)
    base = np.floor(pos)
    frac = pos - base
    return PrecomputedSparseTimeFunction(
        name=name, grid=grid, npoint=len(pos), nt=geom.nt, r=2,
        gridpoints=base.astype(np.int32),
        interpolation_coeffs=np.stack([1 - frac, frac], -1).astype(
            grid.dtype))


def solver_for(kind, shape, so, nbl, steps, spacing, dtype=np.float32,
               interpolation='linear', model=None, tn=None):
    """The solver ``kind`` (a key of SOLVERS, or 'viscoacoustic <rheology>-
    <time order>') built by its ``*_setup`` on its layered model at
    ``shape`` (+``nbl``), ``spacing`` m, ``so``, in ``dtype`` (an elastic
    one on ``model`` when given), with setup_geometry's geometry -- a
    Ricker at the centre of the surface, one spacing deep, and a receiver
    at every surface node (3-D: shape[0] x shape[1]), two spacings deep --
    up to ``tn`` ms, or over ``steps`` steps, its receivers interpolated by
    ``interpolation`` ('linear', 'sinc' at r=4, or 'precomputed': linear
    weights as precomputed tables)."""
    from devito_tpu_torch.models import seismic as S
    if model is not None:
        s = S.ElasticWaveSolver(model, None, space_order=so)
    else:
        if kind.startswith('viscoacoustic'):
            rheology, order = kind.split()[1].split('-')
            setup, kw = S.viscoacoustic_setup, dict(kernel=rheology,
                                                    time_order=int(order))
        else:
            setup, kw = {'elastic': S.elastic_setup,
                         'viscoelastic': S.viscoelastic_setup,
                         'self-adjoint': S.sa_setup}[kind], {}
        kw['npad' if kind == 'self-adjoint' else 'nbl'] = nbl
        s = setup(shape=shape, spacing=(spacing,) * len(shape), tn=1.,
                  space_order=so, dtype=dtype, **kw)
    # steps: the time axis has ceil((tn + dt) / dt) = steps + 2 rows
    tn = tn or (steps + .5) * s.model.critical_dt
    s.geometry = S.setup_geometry(
        s.model, tn, interpolation='linear' if interpolation ==
        'precomputed' else interpolation)
    if interpolation == 'precomputed':
        geom = s.geometry
        geom.new_rec = lambda name='rec', coordinates=None: \
            precomputed_rec(geom, name, coordinates)
    return s


def wavefields(out):
    """{name: function} of every wavefield component in a solver's
    outputs (vector and tensor components, time functions)."""
    fields = {}
    for f in out:
        comps = f.values() if hasattr(f, 'values') else \
            getattr(f, 'components', [f])
        for c in comps:
            if getattr(c, 'is_TimeFunction', False) and \
                    not getattr(c, 'is_SparseFunction', False):
                fields[c.name] = c
    return fields


def records_of(out):
    """The sparse records (receivers, adjoint sources) in a solver's
    outputs, as arrays, by name; raises unless each is finite and
    non-zero."""
    recs = {f.name: np.array(f.data) for f in out
            if getattr(f, 'is_SparseFunction', False)}
    for name, r in recs.items():
        if not (np.isfinite(r).all() and np.abs(r).max() > 0):
            raise AssertionError(f"record {name} is not finite and "
                                 f"non-zero")
    return recs


def held(label, plan, rows, params, device):
    """K1 of ``plan`` on ``rows`` against its plain version on the same
    rows (the plain one first, into a copy of the target row, or of each
    of a fused unit's); raises beyond TOL x max |plain|, over every
    target. Returns (max |kernel - plain|, tolerance)."""
    from devito_tpu_torch.kernels import stencil as K
    out, ins = rows
    outs = [out] if plan.nt == 1 else list(out)
    refs = [o.clone() for o in outs]
    K.stencil_update_reference(plan, (refs[0] if plan.nt == 1 else refs,
                                      ins), params)
    K.stencil_update(plan, rows, params)
    sync(device)
    top = max(r.abs().max().item() for r in refs)
    err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
    tol = TOL[plan.dtype.type] * top
    if not (err <= tol and 0 < top < float('inf')):
        raise AssertionError(f"{label}: {plan.eq!r} on the {plan.design} "
                             f"design: max|kernel - plain| {err:.3e} > "
                             f"{tol:.3e}")
    return err, tol


def launch_ms(op, kinds, fields, dt, device, gen, alts=None, apart=None):
    """Each K1 launch of ``op``, by equation, at the shapes its loop gives
    it (the rows of step 1; ``fields`` stand in for the operator's own
    wavefields, which are then not allocated): the wavefields' rows and
    the target row seeded in [1, 2) over the whole allocation, the
    model's and the temporaries' rows as they are (a seeded model could
    divide by zero: sls's relaxation times at a point where two equal
    draws meet). Each launch is held against its plain version (``held``:
    ``max_abs_err``, ``tol``), then timed alone (``ms``: CUDA events, 3
    launches after a warm-up). A row read and written is one seeded row.
    With ``alts`` ({id(plan): the same equation's point-design plan}), a
    streaming equation's point design is held and timed beside it
    (``point_max_abs_err``, ``point_ms``). A fused unit is one launch, a
    row of its targets (``target``: joined by ``+``); with ``apart``
    ({id(plan): its equations' own plans}) each of those is held and timed
    beside it, one launch each on the same rows (``apart_max_abs_err``,
    ``apart_ms``: their sum)."""
    from devito_tpu_torch.compiler.executor import plan_rows
    from devito_tpu_torch.kernels import stencil as K
    bufs, params = op.arguments(time_M=1, dt=dt, **fields)
    out = []
    for kind, eq, plan in units(kinds):
        t = None if kind == 'hoisted prologue item' else 1
        seeded = {}

        def seed(r, fn):
            key = (r.data_ptr(), r.dtype, tuple(r.shape))
            if key not in seeded and fn is not None and \
                    not getattr(fn, 'is_TimeFunction', False):
                return r
            if key not in seeded:
                seeded[key] = r.clone().uniform_(1, 2, generator=gen)
            return seeded[key]
        dst, ins = plan_rows(plan, bufs, t, params)
        dst = seed(dst, None) if plan.nt == 1 else [seed(r, None)
                                                     for r in dst]
        rows = (dst, [seed(r, g['fn']) for r, g in zip(ins, plan.groups)])
        shape = tuple((dst if plan.nt == 1 else dst[0]).shape)
        row = dict(kind=kind, target=unit_name(plan), design=plan.design,
                   groups=len(plan.groups))
        for pre, p in (('', plan), ('point_', (alts or {}).get(id(plan)))):
            if p is None:
                continue
            row[f'{pre}max_abs_err'], row['tol'] = held(
                f'{op.name} at {shape}', p, rows, params, device)
            row[f'{pre}ms'] = time_ms(
                lambda: K.stencil_update(p, rows, params), 3, device)
        mine = {g['key']: r for g, r in zip(plan.groups, rows[1])}
        alone = [(p, (d, [mine[g['key']] for g in p.groups])) for p, d in
                 zip((apart or {}).get(id(plan), ()),
                     dst if plan.nt > 1 else [dst])]
        if alone:
            row['apart_max_abs_err'] = max(
                held(f'{op.name} at {shape}', p, r, params, device)[0]
                for p, r in alone)
            row['apart_ms'] = time_ms(lambda: [
                K.stencil_update(p, r, params) for p, r in alone], 3, device)
        out.append(row)
        del seeded, rows
    return out


def sparse_ms(op, fields, dt, device):
    """Each sparse operation of ``op``'s time loop timed alone on the rows
    of step 1 of ``fields``, the geometry built before: [(label, points,
    ms, device ms)], ``ms`` by ``time_ms`` (3 calls after a warm-up; CUDA
    events, so host-paced where the host is slower than the device) and
    ``device ms`` the device time of a call under torch.profiler; and the
    host ms the first call took with its geometry built (synchronised)."""
    from devito_tpu_torch.compiler.executor import _exec_sparse
    from devito_tpu_torch.ir.lowering import LoweredSparse
    bufs, params = op.arguments(time_M=1, dt=dt, **fields)
    geom, rows = {}, []
    sync(device)
    tic = time.perf_counter()
    items = [it for it in op.schedule.body if isinstance(it, LoweredSparse)]
    for it in items:
        _exec_sparse(it, bufs, params, 1, geom)
    sync(device)
    first = (time.perf_counter() - tic) * 1e3
    for it in items:
        def call():
            _exec_sparse(it, bufs, params, 1, geom)
        dev = sum(m for _, m, _ in profiled(
            lambda: [call() for _ in range(3)], device)[0]) / 3
        rows.append((f'{it.kind} {it.sparse.name}', it.sparse.npoint,
                     time_ms(call, 3, device), dev))
    return rows, first


def log_units(label, ops, kinds):
    """Log every dense equation of ``ops`` ((label, op) pairs) with its
    design, design reason and group count, and every K1 unit with its
    nvcc seconds, registers and spills; return the units' rows."""
    from devito_tpu_torch.kernels import stencil as K
    units = []
    for lab, _ in ops:
        for k, eq, p in kinds[lab]:
            u = dict(op=lab, kind=k, target=eq.target.name, design=p.design,
                     reason=p.design_reason, groups=len(p.groups),
                     key=p.key, nvcc_s=K.build_seconds.get(p.key),
                     ptxas=ptxas(K.build_log.get(p.key, '')))
            units.append(u)
            log(f"[{label}-unit] {lab}: {k} {u['target']}: {u['design']} "
                f"({u['reason']}), {u['groups']} groups; nvcc "
                f"{u['nvcc_s'] or 0:.2f} s; {u['ptxas'] or 'no ptxas'}")
    return units


def by_design(kinds):
    """Launches by design of the plans of ``kinds`` (their counts), a fused
    unit's once."""
    out = {'point': 0, 'stream': 0}
    for _, _, p in units(kinds):
        out[p.design] += p.launches
    return out


def drive_solver(label, fn, op, kinds, device, record):
    """``tti_drive`` of ``fn`` (a solver's entry point) over ``op``'s loop
    steps, its peak device memory and loop time a step; adds the launches
    to K1's ``record``. Returns (fn's outputs, a row)."""
    on_card = device.type == 'cuda'
    steps = loop_steps(op)
    held = torch.cuda.memory_allocated(device) if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    out, by_kind, wall = tti_drive(label, fn, kinds, steps, device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    summary = out[-1]
    designs = by_design(kinds)
    record['launches'] += sum(by_kind.values())
    for d, c in designs.items():
        record['launches_by_design'][d] += c
    record['launches_main_path'] = record['launches']
    record.setdefault('launches_by_path', {})[label] = by_kind
    return out, dict(steps=steps, wall_s=wall,
                     loop_ms_per_step=summary.globals['fdlike'].time * 1e3
                     / steps, launches_by_kind=by_kind,
                     launches_by_design=designs, held_bytes=held,
                     max_memory_allocated=peak)


def solvers(device, sizes, record, gen):
    """Phase 11, the other solvers (elastic, viscoelastic, viscoacoustic,
    self-adjoint) and the geometry's sinc and precomputed interpolation:
    (1) every operator of the phase lowered first and all their K1 units
    built at once; (2) each solver at full width driven with every count
    at 0 just before and read just after, each launch at that shape held
    against its plain version (``launch_ms``) and, but for the elastic
    forward, a cell's, timed warm and split under profiling='measured'
    (``measured``); (3) each at sol_cmp_n^3,
    with the other five viscoacoustic kernels (forward and adjoint) and
    the sinc and precomputed elastic forwards, against the plain versions
    on the CPU; (4) the fp64 dot tests through the kernels; (5) sinc and
    precomputed receivers on the elastic forward at full width beside
    linear's. Adds the full-width launches to K1's ``record``."""
    from devito_tpu_torch import (NODE, TensorTimeFunction, TimeFunction,
                                  switchconfig)
    from devito_tpu_torch.builtins import inner, norm
    from devito_tpu_torch.kernels import stencil as K
    from concurrent.futures import ThreadPoolExecutor
    on_card = device.type == 'cuda'
    res = record['solvers'] = {}
    release(device)
    if on_card:
        res['held_at_start'] = torch.cuda.memory_allocated(device)
        log(f"[sol] device memory allocated at the start of phase 11: "
            f"{res['held_at_start'] / 1e9:.2f} GB")
    n, nbl, h = sizes['sol_n'], sizes['sol_nbl'], sizes['sol_spacing']
    steps, cn, csteps = sizes['sol_steps'], sizes['sol_cmp_n'], \
        sizes['sol_cmp_steps']
    shape, cshape = (n,) * 3, (cn,) * 3
    small_kinds = [k for k in SOLVERS if k != 'viscoacoustic sls-2'] + [
        f'viscoacoustic {r}-{o}' for r, o in VISCO]

    def so_of(kind):
        return 8 if kind == 'self-adjoint' else 4

    # -- (1) every operator of the phase, and all their K1 units built --
    tic = time.perf_counter()
    full = {k: solver_for(k, shape, so, nbl, steps, h)
            for k, so in SOLVERS.items()}
    emodel = full['elastic'].model
    interp = {i: solver_for('elastic', shape, 4, nbl, steps, h,
                            interpolation=i, model=emodel)
              for i in ('sinc', 'precomputed')}
    small = {k: solver_for(k, cshape, so_of(k), nbl, csteps, h)
             for k in small_kinds}
    small.update({f'elastic {i}': solver_for('elastic', cshape, 4, nbl,
                                             csteps, h, interpolation=i)
                  for i in ('sinc', 'precomputed')})
    # the dot tests' models, as tests/test_viscoacoustic.py and
    # tests/test_self_adjoint.py build them
    dots = {f'viscoacoustic {r}-{o}': solver_for(
        f'viscoacoustic {r}-{o}', sizes['sol_dot_shape'], 4, nbl, None, 20.,
        np.float64, tn=sizes['sol_dot_tn']) for r, o in VISCO}
    dots['self-adjoint'] = solver_for(
        'self-adjoint', sizes['sa_dot_shape'], 8, nbl, None, 10., np.float64,
        tn=sizes['sa_dot_tn'])
    ops = {}
    for k, s in full.items():
        ops[f'{k} forward'] = s.op_fwd(None)
        if hasattr(s, 'op_adj'):
            ops[f'{k} adjoint'] = s.op_adj()
    for i, s in interp.items():
        ops[f'elastic forward, {i} receivers'] = s.op_fwd(None)
    for k, s in small.items():
        ops[f'{cn}^3 {k} forward'] = s.op_fwd(None)
        if hasattr(s, 'op_adj'):
            ops[f'{cn}^3 {k} adjoint'] = s.op_adj()
    for k, s in dots.items():
        ops[f'fp64 {k} forward'] = s.op_fwd(None)
        ops[f'fp64 {k} adjoint'] = s.op_adj()
    lower_s = time.perf_counter() - tic
    kinds = {lab: tti_kinds(op) for lab, op in ops.items()}
    for lab, ks in kinds.items():
        check_tti_plans(lab, ks)
    # the point design of each streaming equation at full width, timed
    # beside it
    alts = {id(p): K.plan_for(eq, _design='point') for k in SOLVERS
            for _, eq, p in kinds[f'{k} forward'] if p.design == 'stream'}
    # each fused unit's equations on their own units, timed beside it
    apart = {id(p): [K.plan_for(e) for e in p.eqs] for k in SOLVERS
             for _, _, p in units(kinds[f'{k} forward']) if p.nt > 1}
    uniq = list({p.key: p for p in [p for ks in kinds.values()
                                    for _, _, p in ks] + list(alts.values())
                 + [q for ps in apart.values() for q in ps]}.values())
    nvcc_s, build_wall = 0., 0.
    if on_card:
        tic = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(K.build, uniq))
        build_wall = time.perf_counter() - tic
        nvcc_s = sum(K.build_seconds.get(p.key, 0.) for p in uniq)
    nuniq = len(uniq)
    del uniq            # its plans would keep every operator's temporaries
    neqs = sum(len(ks) for ks in kinds.values())
    log(f"[sol-build] {len(ops)} operators, {neqs} dense equations, every "
        f"one on K1 (0 in the translator); {nuniq} K1 units in "
        f"{build_wall:.2f} s wall (nvcc {nvcc_s:.2f} s); lowering took "
        f"{lower_s:.2f} s")
    res.update(n_ops=len(ops), n_equations=neqs, n_units=nuniq,
               build_wall_s=build_wall, nvcc_s=nvcc_s, lower_s=lower_s,
               units=log_units('sol', [
                   (lab, None) for lab in ops if lab.startswith((
                       'elastic', 'viscoelastic', 'viscoacoustic sls-2',
                       'self-adjoint'))], kinds))
    release(device)

    def extra(k, grid):
        """New wavefields a forward of ``k`` is given, each run its own:
        forward() returns no memory variable, so one is passed in."""
        if k == 'viscoelastic':
            return {'r': TensorTimeFunction(name='r', grid=grid,
                                            space_order=4, time_order=1)}
        if k.startswith('viscoacoustic'):
            return {'r': TimeFunction(name='r', grid=grid, space_order=4,
                                      time_order=2, staggered=NODE)}
        return {}

    def drop(prefix):
        """Forget the operators labelled ``prefix``..., and with them
        their temporaries' device memory."""
        for lab in [lab for lab in ops if lab.startswith(prefix)]:
            ops.pop(lab)
            for _, _, p in kinds.pop(lab):
                alts.pop(id(p), None)
                apart.pop(id(p), None)
        release(device)

    # -- (2) the full-width runs, and (5) sinc and precomputed receivers --
    # one run's wavefields are held at a time: 18-33 GB a set at 532^3
    nf = tuple(n + 2 * nbl for n in shape)
    for k in list(full):
        s = full.pop(k)
        fop = s.op_fwd(None)
        fk = kinds[f'{k} forward']
        ex = extra(k, s.model.grid)
        out, row = drive_solver(f'{k} forward', lambda: s.forward(**ex),
                                fop, fk, device, record)
        recs = records_of(out)
        rec = out[0]
        if k != 'elastic':
            # a cell times the elastic forward; the others are timed warm
            # here, then split under profiling='measured'
            del out, ex
            release(device)
            row['warm_loop_ms_per_step'] = s.forward(**extra(
                k, s.model.grid))[-1].globals['fdlike'].time * 1e3 / \
                row['steps']
            release(device)
            ex = extra(k, s.model.grid)
            out, row['measured'] = measured(lambda: s.forward(**ex), fop,
                                            row['steps'], device)
        # the run's wavefields: the rows each launch is timed on; a
        # Function's tensor is freed with its class, which the cyclic
        # collector frees (release)
        fields = dict(wavefields(out), **wavefields(ex.values()))
        del out, ex
        per_eq = launch_ms(fop, fk, fields, s.dt, device, gen, alts,
                           apart)
        # every buffer is allocated with its last two axes rounded up to
        # 8 and 128 (types/dense.py _allocated_space)
        f = s.model.damp if getattr(s.model.damp, 'is_Function', False) \
            else s.model.b
        row.update(
            shape=nf, so=SOLVERS[k], nt=s.geometry.nt,
            nrec=s.geometry.nrec,
            rec_norms={nm: float(np.linalg.norm(r))
                       for nm, r in recs.items()},
            launches_per_step=sum(kd != 'hoisted prologue item'
                                  for kd, _, _ in units(fk)),
            per_equation=per_eq,
            unrounded_share=float(np.prod(f.shape_with_halo) /
                                  np.prod(f._allocated_space())))
        res[f'{k} forward'] = row
        log_full(f'{k} forward', row)
        if k == 'elastic':
            rows, first = sparse_ms(fop, fields, s.dt, device)
            res['receivers'] = dict(linear=dict(sparse=rows,
                                                first_call_ms=first))
            log_sparse('linear', rows, first)
        del fields
        release(device)
        if hasattr(s, 'op_adj'):
            aop = s.op_adj()
            aout, arow = drive_solver(f'{k} adjoint', lambda: s.adjoint(rec),
                                      aop, kinds[f'{k} adjoint'], device,
                                      record)
            arecs = records_of(aout)
            fields = wavefields(aout)
            del aout
            release(device)
            arow['warm_loop_ms_per_step'] = s.adjoint(rec)[-1].globals[
                'fdlike'].time * 1e3 / arow['steps']
            release(device)
            arow['measured'] = measured(lambda: s.adjoint(rec), aop,
                                        arow['steps'], device)[1]
            release(device)
            arow.update(rec_norms={nm: float(np.linalg.norm(r))
                                   for nm, r in arecs.items()},
                        per_equation=launch_ms(aop, kinds[f'{k} adjoint'],
                                               fields, s.dt, device, gen))
            res[f'{k} adjoint'] = arow
            log_full(f'{k} adjoint', arow)
            del aop, fields
        del rec, f
        release(device)
        if k == 'elastic':
            # on the same model, the linear run's wavefields dropped
            res['receivers'].update(receivers_phase(interp, kinds, device,
                                                    record))
            interp.clear()
            del emodel
        del s, fop, fk
        drop(k)

    # -- (3) at cn^3 against the plain versions on the CPU -----------------
    cmp = res['compare'] = {}
    lin = None
    for k in list(small):
        s = small.pop(k)
        out = s.forward()
        got = records_of(out)
        kind, _, how = k.partition(' ')
        if k.startswith('viscoacoustic'):
            kind, how = k, ''
        with switchconfig(device='cpu'):
            plain = solver_for(kind, cshape, so_of(kind), nbl, csteps, h,
                               interpolation=how or 'linear')
            pout = plain.forward()
            want = records_of(pout)
            if hasattr(s, 'op_adj'):
                # both adjoints from the same record: the card's
                pout[0].data[:] = out[0].data
                want.update(records_of(plain.adjoint(pout[0])))
        if hasattr(s, 'op_adj'):
            got.update(records_of(s.adjoint(out[0])))
        errs = {}
        for nm, w in want.items():
            err = float(np.abs(got[nm] - w).max())
            tol = RUN_TOL[np.float32] * float(np.abs(w).max())
            if not err <= tol:
                raise AssertionError(f"{k} at {cn}^3: {nm} through the "
                                     f"kernels and the plain version differ "
                                     f"by {err:.3e} > {tol:.3e}")
            errs[nm] = (err, tol)
        if k == 'elastic':
            lin = got
        elif k == 'elastic precomputed':
            # linear weights as precomputed tables: linear's records
            for nm, w in lin.items():
                err = float(np.abs(got[nm] - w).max())
                if not err <= RUN_TOL[np.float32] * float(np.abs(w).max()):
                    raise AssertionError(f"precomputed linear receivers "
                                         f"differ from linear's by {err:.3e}")
        cmp[k] = {nm: dict(max_abs_diff=e, tol=t) for nm, (e, t)
                  in errs.items()}
        log(f"[sol-cmp] {k}, {cn}^3 (+nbl {nbl}), {csteps} steps: through "
            f"the kernels vs the plain version (CPU): " + '; '.join(
                f"{nm} max|diff| {e:.3e} (tolerance {t:.3e})"
                for nm, (e, t) in errs.items()))
        del s, plain, out, pout
    release(device)

    # -- (4) the fp64 dot tests through the kernels -----------------------
    dres = res['dot'] = {}
    for k in list(dots):
        s = dots.pop(k)
        l0 = K.launches
        rec = s.forward()[0]
        srca = s.adjoint(rec)[0]
        t1, t2 = inner(srca, s.geometry.src), norm(rec) ** 2
        dot = float((t1 - t2) / t1)
        launches = K.launches - l0
        dres[k] = dict(shape=s.model.shape, dot=dot, launches=launches)
        log(f"[sol-fp64] {k} {s.model.shape} (+nbl {nbl}) fp64, through "
            f"the kernels ({launches} K1 launches): dot test {dot:.3e} "
            f"(atol 1e-11)")
        if not (abs(dot) <= 1e-11 and launches >= on_card):
            raise AssertionError(f"{k}: fp64 dot test {dot:.3e}")
        del s, rec, srca
    release(device)
    return res


def receivers_phase(interp, kinds, device, record):
    """(5): the elastic forward at full width with sinc (r=4) and with
    precomputed receivers (the solvers of ``interp``), each driven as the
    linear one (counts at 0 just before, read just after), each sparse
    operation then timed alone, and the run split under
    profiling='measured'."""
    out = {}
    for i, si in interp.items():
        lab = f'elastic forward, {i} receivers'
        o, row = drive_solver(lab, lambda: si.forward(), si.op_fwd(None),
                              kinds[lab], device, record)
        recs = records_of(o)
        rows, first = sparse_ms(si.op_fwd(None), wavefields(o), si.dt,
                                device)
        del o
        release(device)
        row.update(sparse=rows, first_call_ms=first,
                   measured=measured(si.forward, si.op_fwd(None),
                                     row['steps'], device)[1],
                   rec_norms={nm: float(np.linalg.norm(r))
                              for nm, r in recs.items()})
        out[i] = row
        log(f"[sol-rec] {lab}: loop {row['loop_ms_per_step']:.3f} ms/step "
            f"over {row['steps']} steps, K1 launches "
            f"{row['launches_by_kind']}, peak device memory "
            + (f"{row['max_memory_allocated'] / 1e9:.2f} GB (held before "
               f"{row['held_bytes'] / 1e9:.2f})"
               if row['max_memory_allocated'] else "not measured"))
        log_sparse(i, rows, first)
        log_measured(lab, row['measured'])
        release(device)
    return out


def log_sparse(label, rows, first):
    log(f"[sol-rec] {label} receivers: each sparse operation alone, CUDA "
        f"events (device time under torch.profiler): " + '; '.join(
            f"{nm} ({p} points) {ms:.4f} ({dev:.4f}) ms"
            for nm, p, ms, dev in rows)
        + f"; sum {sum(r[2] for r in rows):.4f} "
        f"({sum(r[3] for r in rows):.4f}) ms a step; the first call, the "
        f"geometry built, {first:.1f} ms")


def log_full(label, row):
    mem = row['max_memory_allocated']
    log(f"[sol] {label} {row.get('shape', '')} SO={row.get('so', '')}, "
        f"{row['steps']} steps: first run (the main path) loop "
        f"{row['loop_ms_per_step']:.3f} ms/step, wall {row['wall_s']:.2f} s"
        + (f"; warm loop {row['warm_loop_ms_per_step']:.3f} ms/step"
           if 'warm_loop_ms_per_step' in row else "")
        + f"; K1 launches by kind {row['launches_by_kind']}, by design "
        f"{row['launches_by_design']}; peak device memory "
        + (f"{mem / 1e9:.2f} GB (held before {row['held_bytes'] / 1e9:.2f})"
           if mem else "not measured")
        + (f", {row['unrounded_share']:.4f} of it without the (8, 128) "
           f"rounding" if 'unrounded_share' in row else "")
        + f"; records {row['rec_norms']}")
    if 'per_equation' in row:
        log(f"[sol] {label}: each launch by equation on seeded rows at the "
            f"loop's shapes, held against its plain version (max|kernel - "
            f"plain|, TOL x max|plain|) and timed alone (CUDA events): "
            + '; '.join(
                f"{e['kind']} {e['target']} {e['design']} {e['groups']}g "
                f"{e['ms']:.3f} ms, err {e['max_abs_err']:.2e} "
                f"({e['tol']:.2e})"
                + (f" (point design {e['point_ms']:.3f} ms, err "
                   f"{e['point_max_abs_err']:.2e})" if 'point_ms' in e
                   else "") for e in row['per_equation']))
    if 'measured' in row:
        log_measured(label, row['measured'])


# -- phase 12: narrow storage, separable interpolation and the options ------

#: The narrow-storage variants of the headline equation phase 12 runs on K1:
#: (label, opt options).
NARROW = [('bf16 fields', {'storage-dtype': 'bfloat16'}),
          ('bf16 all', {'storage-dtype': 'bfloat16',
                        'storage-dtype-scope': 'all'}),
          ('fp16 fields', {'storage-dtype': 'float16'})]
#: Mantissa bits of each narrow dtype (one ulp at |v| in [2^e, 2^(e+1)) is
#: 2^(e - bits)).
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def narrow_rows(plan, device, gen):
    """``random_rows`` in each row's storage dtype: the values drawn in
    the compute dtype, then rounded to the row's."""
    _, _, ins = random_rows(plan, device, gen)
    ins = [r.to(st) for r, st in zip(ins, plan.storage[1:])]
    out = torch.zeros(plan.eq.target._allocated_space(), device=device,
                      dtype=plan.storage[0])
    return out, ins


def narrow_close(label, got, want):
    """Raise unless every value of ``got`` is within one ulp of the
    narrow storage dtype of ``want``'s, or within TOL[fp32] x max|want|
    (values near zero): the kernel's fp32 sums may contract to FMAs where
    the plain version's do not, and a last-bit difference can move the
    rounded value by one narrow ulp. Returns (max |got - want|, the share
    of values off by an ulp)."""
    w = want.float()
    diff = (got.float() - w).abs()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 1 - MANTISSA[want.dtype])
    top = w.abs().max().item()
    ok = diff <= torch.maximum(ulp, torch.full_like(
        ulp, TOL[np.float32] * top))
    if not (bool(ok.all()) and 0 < top < float('inf')):
        raise AssertionError(f"{label}: {int((~ok).sum())} values beyond a "
                             f"{want.dtype} ulp of the plain version (max "
                             f"|diff| {diff.max().item():.3e})")
    return diff.max().item(), float((diff > 0).float().mean().item())


def plan_bytes(plan):
    """Bytes one update of ``plan`` needs: each row read once, the target
    written once, over the region, at each row's storage size."""
    npts = int(np.prod(plan.extents))
    return npts * sum(torch.empty(0, dtype=s).element_size()
                      for s in plan.storage)


def narrow_phase(device, sizes, records, gen):
    """Phase 12: (1) the phase's new K1 units built at once; (2) K1 on
    narrow rows (bench.py's headline equation at n^3 SO=8 with bf16 rows
    under scope 'fields' and 'all', fp16 under 'fields') against its plain
    version and timed beside the fp32 point and streaming designs; (3)
    bench.py's second row through Operator.apply: 4 steps against the
    plain version, then 100 with one narrow launch a step, its peak memory
    and its drift from the fp32 operator; (4) the elastic forward at full
    width with separable and with gathered receivers, linear and sinc;
    (5) the superstep wave equation at k = 2 and 4 against k steps; (6)
    spatial bounds on the headline operator against the plain version;
    (7) the errctl scan on the forward shot and on a run that blows up;
    (8) the headline operator pickled and rerun, here and in a new
    process; (9) autotune. Every part is driven with K1's counts at 0 just
    before it and read just after; its launches add to K1's main path.
    Appends the narrow-storage record to ``records``."""
    from devito_tpu_torch.kernels import stencil as K
    from concurrent.futures import ThreadPoolExecutor
    on_card = device.type == 'cuda'
    k1 = records[0]
    res = k1['phase12'] = {}
    narrow = dict(name='stencil_update_narrow', route='cuda',
                  source='devito_tpu_torch/csrc/stencil.cuh',
                  replaces='experiments/pallas_backend.py:303', launches=0,
                  point_ms=None, library_ms=None)
    records.append(narrow)
    release(device)
    n = sizes['p12_n']
    tic = time.perf_counter()

    # -- (1) the phase's operators, and their new K1 units built at once ---
    eq32 = operator_for('acoustic', (n,) * 3, 8, np.float32)[0]
    (_, p32), = eq32.kernel_plans
    variants = {}
    for lab, o in NARROW:
        op = operator_for('acoustic', (n,) * 3, 8, np.float32,
                          ('advanced', o))[0]
        (_, p), = op.kernel_plans
        if p.design != 'point' or not p.narrow:
            raise AssertionError(f"{lab}: the narrow headline equation took "
                                 f"{p.design} ({p.design_reason})")
        variants[lab] = p
        del op
    ss = superstep_ops(sizes)
    all_on_k1([op for _, _, op in ss])
    lower_s = time.perf_counter() - tic
    point32 = K.plan_for(p32.eq, _design='point')
    plans = [p32, point32] + list(variants.values()) + [
        p for _, _, op in ss for _, p in op.kernel_plans]
    uniq = list({p.key: p for p in plans}.values())
    wall = 0.
    if on_card:
        tic = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(K.build, uniq))
        wall = time.perf_counter() - tic
    res['build'] = dict(lower_s=lower_s, wall_s=wall, units=[
        dict(target=p.eq.target.name, design=p.design,
             storage=[str(s) for s in p.storage],
             nvcc_s=K.build_seconds.get(p.key),
             ptxas=ptxas(K.build_log.get(p.key, ''))) for p in uniq])
    log(f"[p12-build] {len(uniq)} K1 units in {wall:.2f} s wall (lowering "
        f"{lower_s:.2f} s, the superstep's sympy included)")
    for u in res['build']['units']:
        log(f"[p12-unit] {u['target']} {u['design']} rows "
            f"{'/'.join(s.replace('torch.', '') for s in u['storage'])}: "
            f"nvcc {u['nvcc_s'] or 0:.2f} s; {u['ptxas'] or 'no ptxas'}")

    # -- (2) K1 on narrow rows, alone ---------------------------------------
    reps = sizes['reps']
    params = {nm: 0.7 for nm in p32.param_names}
    out, _, ins = random_rows(p32, device, gen)
    times = dict(stream=time_ms(lambda: K.stencil_update(p32, (out, ins),
                                                         params), reps,
                                device),
                 point=time_ms(lambda: K.stencil_update(point32, (out, ins),
                                                        params), reps,
                               device))
    del out, ins
    alone = res['narrow_k1'] = {}
    for lab, p in variants.items():
        out, ins = narrow_rows(p, device, gen)
        ref = out.clone()
        K.stencil_update_reference(p, (ref, ins), params)
        K.stencil_update(p, (out, ins), params)
        sync(device)
        err, off = narrow_close(f"K1 {lab}", out, ref)
        ms = time_ms(lambda: K.stencil_update(p, (out, ins), params), reps,
                     device)
        plain = time_ms(lambda: K.stencil_update_reference(
            p, (ref, ins), params), sizes['plain_reps'], device)
        row = dict(ms=ms, plain_ms=plain, max_abs_err=err, ulp_share=off,
                   fp32_stream_ms=times['stream'],
                   fp32_point_ms=times['point'],
                   ptxas=ptxas(K.build_log.get(p.key, '')))
        set_bound(row, plan_bytes(p), K.point_flops(p) *
                  int(np.prod(p.extents)))
        alone[lab] = row
        log(f"[p12-k1] {lab} at {n}^3 SO=8 (point design, {p.design_reason}"
            f"): {ms:.4f} ms, bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']} ({row['bound_bytes'] / 1e9:.3f} GB) = "
            f"{100 * row['share_of_bound']:.1f} %; fp32 streaming "
            f"{times['stream']:.4f}, fp32 point {times['point']:.4f}; plain "
            f"{plain:.3f} ms; against the plain version max|diff| {err:.3e},"
            f" {100 * off:.4f} % of the values one ulp off; {row['ptxas']}")
        del out, ins, ref
    release(device)
    first = alone['bf16 fields']
    narrow.update(ms=first['ms'], plain_ms=first['plain_ms'],
                  max_abs_err=max(r['max_abs_err'] for r in alone.values()),
                  bound_ms=first['bound_ms'], bound_by=first['bound_by'],
                  point_ms=first['ms'], variants=alone,
                  ptxas=first['ptxas'])

    def count(fn):
        """fn() with K1's counts at 0 just before it; (its result,
        launches by design), read just after; the launches add to K1's
        main path."""
        K.launches = 0
        K.launches_by_design.update(point=0, stream=0)
        probe_launches(zero=True)
        out = fn()
        sync(device)
        by = dict(K.launches_by_design)
        if any(probe_launches().values()):
            raise AssertionError("phase 12 launched a probe kernel")
        k1['launches'] += K.launches
        k1['launches_main_path'] = k1['launches']
        return out, by

    # -- (3) bench.py's second row through Operator.apply ------------------
    res['second_row'] = second_row(device, sizes, narrow, count)
    release(device)
    # -- (4) separable interpolation at full width -----------------------
    res['separable'] = separable_phase(device, sizes, count)
    release(device)
    # -- (5) superstepping ----------------------------------------------
    res['superstep'] = superstep_phase(device, sizes, ss, count)
    del ss
    release(device)
    # -- (6)-(9) the options on the headline operator ---------------------
    res.update(options_phase(device, sizes, count))
    release(device)
    return res


def second_row(device, sizes, narrow, count):
    """bench.py's second row, ('advanced', {'storage-dtype': 'bfloat16',
    'storage-dtype-scope': 'fields'}), on the headline state: 4 steps
    against the plain version on the same rows, then ``p12_steps`` steps
    through Operator.apply with one narrow K1 launch a step, their peak
    device memory and loop time, and the drift of u from the fp32
    operator's after as many steps from the same state."""
    from devito_tpu_torch.compiler.executor import plan_rows
    from devito_tpu_torch.kernels import stencil as K
    n, steps, ntc = sizes['p12_n'], sizes['p12_steps'], sizes['head_compare']
    on_card = device.type == 'cuda'
    dt_ = 0.6 * 10.0 / 1.5 / (3 ** 0.5) / 4   # bench.py's dt
    op, fns = headline_operator(n, device, ('advanced', {
        'storage-dtype': 'bfloat16', 'storage-dtype-scope': 'fields'}))
    (_, plan), = op.kernel_plans
    u = fns['u']
    bufs, hp = op.arguments(time_m=1, time_M=ntc, dt=dt_)
    snap = bufs['u'].clone()
    if snap.dtype != torch.bfloat16 or bufs['vp'].dtype != torch.float32:
        raise AssertionError(f"second row: u stored {snap.dtype}, vp "
                             f"{bufs['vp'].dtype}")
    op.apply(time_m=1, time_M=ntc, dt=dt_)
    got = u._device_array().clone()
    bufs, hp = op.arguments(time_m=1, time_M=ntc, dt=dt_)
    bufs['u'].copy_(snap)
    for t in range(1, ntc + 1):
        K.stencil_update_reference(plan, plan_rows(plan, bufs, t, hp), hp)
    sync(device)
    # a step's rounding may differ by a bf16 ulp where the fp32 sums differ
    # in their last bit, and the next steps carry it: 4 steps are held to
    # 8 bf16 ulps at max |plain|
    top = bufs['u'].float().abs().max().item()
    err = (got.float() - bufs['u'].float()).abs().max().item()
    tol = 8 * 2. ** (np.floor(np.log2(top)) - 7)
    if not err <= tol:
        raise AssertionError(f"second row: kernel and plain runs differ by "
                             f"{err:.3e} > {tol:.3e}")
    u._device_array().copy_(snap)
    del got, bufs
    plan.launches = 0
    held = torch.cuda.memory_allocated(device) if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    summary, by = count(lambda: op.apply(time_m=1, time_M=steps, dt=dt_))
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    if by != {'point': on_card * steps, 'stream': 0} or \
            plan.launches != on_card * steps:
        raise AssertionError(f"second row launched K1 {by}, its narrow plan "
                             f"{plan.launches} times, for {steps} steps")
    narrow['launches'] += plan.launches
    narrow['launches_main_path'] = narrow['launches']
    bf = u._device_array().float()
    if not bool(torch.isfinite(bf).all()):
        raise AssertionError("second row: non-finite wavefield")
    loop = summary.globals['fdlike'].time * 1e3 / steps
    del op, fns, u
    release(device)
    op32, f32 = headline_operator(n, device)
    op32.apply(time_m=1, time_M=steps, dt=dt_)
    w = f32['u']._device_array()
    drift = ((bf - w).abs().max() / w.abs().max()).item()
    del op32, f32, w, bf
    row = dict(steps=steps, loop_ms_per_step=loop, compare_steps=ntc,
               compare_err=err, compare_tol=tol, launches=by,
               max_memory_allocated=peak, held_bytes=held,
               drift_from_fp32=drift,
               gpoints_s=n ** 3 / (loop * 1e-3) / 1e9)
    log(f"[p12-row2] bench.py's second row (bf16 fields) at {n}^3: {ntc} "
        f"steps against the plain version max|diff| {err:.3e} (tolerance "
        f"{tol:.3e}); {steps} steps through Operator.apply "
        f"{loop:.4f} ms/step ({row['gpoints_s']:.2f} GPts/s), K1 {by} "
        f"(one narrow launch a step), peak device memory "
        + (f"{peak / 1e9:.2f} GB (held before {held / 1e9:.2f})" if peak
           else "not measured")
        + f"; drift of u from the fp32 operator after {steps} steps "
        f"{drift:.3e} x max")
    return row


def all_on_k1(ops, allow=()):
    """Raise when a dense equation of ``ops`` runs in the torch
    translator (K1 declined it) for a reason not in ``allow``."""
    from devito_tpu_torch.kernels import stencil as K
    bad = [(op.name, eq.target.name, K.decline_reason(eq))
           for op in ops for eq, p in op.kernel_plans
           if p is None and K.decline_reason(eq) not in allow]
    if bad:
        raise AssertionError(f"equations in the torch translator: {bad}")


def build_units(ops, device, allow=()):
    """Build every K1 unit of ``ops`` at once (8 nvcc at a time), so that
    no run of the phase compiles inside its loop; the seconds it took.
    Raises when a dense equation of ``ops`` runs in the torch translator
    for a reason not in ``allow``."""
    from devito_tpu_torch.kernels import stencil as K
    from concurrent.futures import ThreadPoolExecutor
    all_on_k1(ops, allow)
    if device.type != 'cuda':
        return 0.
    uniq = {p.key: p for op in ops for _, p in op.kernel_plans if p}
    tic = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(K.build, uniq.values()))
    return time.perf_counter() - tic


def separable_phase(device, sizes, count):
    """The elastic forward at full width (``sol_n``^3 + nbl, a receiver at
    every surface node) with linear and with sinc (r=4) receivers, each
    with the separable path (the default) and with it off: the records
    agree within 1e-5 x max (fp32: the sums run in other orders); each
    way's first loop ms a step and the separable set-up's ms, and a warm
    run under profiling='measured' (``measured``): its sparse and loop ms
    a step."""
    from devito_tpu_torch import switchconfig
    n, nbl, h, steps = (sizes['sol_n'], sizes['sol_nbl'],
                        sizes['sol_spacing'], sizes['sol_steps'])
    shape = (n,) * 3
    out = {}
    model = None
    for interp in ('linear', 'sinc'):
        s = solver_for('elastic', shape, 4, nbl, steps, h,
                       interpolation=interp, model=model)
        model = s.model
        op = s.op_fwd(None)
        build_units([op], device)
        nsteps = loop_steps(op)
        rows = {}
        for way, on in (('separable', True), ('gather', False)):
            with switchconfig(separable=on):
                fo, by = count(lambda: s.forward())
                recs = records_of(fo)
                first = fo[-1].globals['fdlike'].time * 1e3 / nsteps
                del fo
                release(device)
                split = measured(lambda: s.forward(), op, nsteps,
                                 device)[1]
            sparse = sum(v for k, v in split['items'].items()
                         if not k.startswith('K1'))
            rows[way] = dict(recs=recs, launches=by, measured=split,
                             sparse_ms_per_step=sparse,
                             loop_ms_per_step=split['loop_ms'],
                             first_loop_ms_per_step=first,
                             setup_ms=op.separable_seconds * 1e3)
            release(device)
        errs = {}
        for nm, w in rows['gather']['recs'].items():
            got = rows['separable']['recs'][nm]
            err = float(np.abs(got - w).max())
            tol = 1e-5 * float(np.abs(w).max())
            if not err <= tol:
                raise AssertionError(f"{interp} receivers: {nm} separable "
                                     f"and gathered differ by {err:.3e} > "
                                     f"{tol:.3e}")
            errs[nm] = (err, tol)
        for r in rows.values():
            r.pop('recs')
        out[interp] = dict(rows, max_abs_diff=errs, nrec=s.geometry.nrec)
        log(f"[p12-sep] elastic {interp} receivers ({s.geometry.nrec}), "
            f"{n}^3 + nbl {nbl}, {nsteps} steps: " + '; '.join(
                f"{way}: loop {r['loop_ms_per_step']:.3f} ms/step (first run "
                f"{r['first_loop_ms_per_step']:.3f}), sparse "
                f"{r['sparse_ms_per_step']:.4f} ms/step of device time, the "
                f"separable set-up {r['setup_ms']:.2f} ms, K1 "
                f"{r['launches']}"
                for way, r in rows.items())
            + "; records separable - gathered: " + '; '.join(
                f"{nm} {e:.3e} (tolerance {t:.3e})"
                for nm, (e, t) in errs.items()))
        del s, op
        release(device)
    return out


def superstep_ops(sizes):
    """[(k, state, operator)] of the superstep wave equation (a fp32 SO
    ``p12_ss_so`` wave equation at ``p12_ss_n``^3, velocity 1.5, half the
    CFL dt) for each k of ``p12_ss_ks``, built by superstep_generator from
    a Gaussian pulse at the centre; k = 0 is the one-step operator."""
    from devito_tpu_torch import (Grid, TimeFunction, Eq, Operator, solve,
                                  clear_cache)
    from devito_tpu_torch.timestepping import superstep_generator
    n, so = sizes['p12_ss_n'], sizes['p12_ss_so']
    grid = Grid(shape=(n,) * 3, extent=(10. * (n - 1),) * 3)
    # a pulse of width n / 12, so that it is zero to fp32 at the edges: the
    # composed stencil reads the halo where k single steps would have
    # written zeros
    x = (np.arange(n, dtype=np.float32) - n / 2) ** 2
    pulse = np.exp(-(x[:, None, None] + x[None, :, None] + x[None, None, :])
                   / (2 * (n / 12.) ** 2))
    dtv = 0.5 * 10. / 1.5 / np.sqrt(3) / 2
    out = []
    for k in (0,) + tuple(sizes['p12_ss_ks']):
        clear_cache()
        u = TimeFunction(name='u', grid=grid, time_order=2, space_order=so)
        u.data[0] = pulse
        u.data[1] = pulse
        st = solve(u.dt2 - 1.5 ** 2 * u.laplace, u.forward).subs(
            grid.spacing_map).subs({grid.time_dim.spacing: dtv})
        if k == 0:
            out.append((0, dict(u=u, dt=dtv), Operator(Eq(u.forward, st))))
            continue
        uss, ussp, eq1, eq2 = superstep_generator(u, st, k, nt=1)
        out.append((k, dict(u=uss, dt=dtv), Operator([eq1, eq2])))
    return out


def superstep_phase(device, sizes, ss, count):
    """Each superstep operator of ``ss`` (k >= 1) one apply from the pulse
    against k steps of the one-step operator from it, over the domain:
    within RUN_TOL x max (fp32); its launches per superstep and ms per
    advanced step (warm) beside the one-step operator's ms a step."""
    from devito_tpu_torch.kernels import stencil as K

    def domain(fn, row):
        return fn._device_array()[row][tuple(
            slice(h, h + m) for (h, _), m in zip(fn.halo, fn.shape[1:]))]
    (_, s0, op0), *rest = ss
    u0 = s0['u']
    snap = u0._device_array().clone()
    res = {}
    for k, st, op in rest:
        u0._device_array().copy_(snap)
        op0.apply(time_m=1, time_M=k, dt=s0['dt'])
        ref = domain(u0, (k + 1) % 3).clone()
        uss = st['u']
        ssnap = uss._device_array().clone()
        _, by = count(lambda: op.apply(time_m=1, time_M=1, dt=st['dt']))
        got = domain(uss, 2)
        err = (got - ref).abs().max().item()
        tol = RUN_TOL[np.float32] * ref.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"superstep k={k}: {err:.3e} > {tol:.3e} "
                                 f"against {k} steps")
        uss._device_array().copy_(ssnap)
        ms = op.apply(time_m=1, time_M=1, dt=st['dt']).globals[
            'fdlike'].time * 1e3
        plans = [p for _, p in op.kernel_plans]
        res[k] = dict(err=err, tol=tol, launches=by, ms_per_superstep=ms,
                      ms_per_step=ms / k,
                      designs=[p.design for p in plans],
                      taps=[p.source.count('DTPU_LD') for p in plans],
                      flops_per_point=[K.point_flops(p) for p in plans])
        del got, ref, ssnap
    u0._device_array().copy_(snap)
    one = op0.apply(time_m=1, time_M=4, dt=s0['dt']).globals[
        'fdlike'].time * 1e3 / 4
    for k, r in res.items():
        r['single_step_ms'] = one
        log(f"[p12-ss] superstep k={k} at {sizes['p12_ss_n']}^3 SO="
            f"{sizes['p12_ss_so']} fp32: against {k} single steps max|diff| "
            f"{r['err']:.3e} (tolerance {r['tol']:.3e}); K1 {r['launches']} "
            f"a superstep ({'/'.join(r['designs'])}, taps {r['taps']}, "
            f"flops a point {r['flops_per_point']}); {r['ms_per_superstep']:.3f}"
            f" ms a superstep = {r['ms_per_step']:.3f} ms an advanced step, "
            f"against {one:.3f} ms a single step")
    return res


#: The new process of phase 12's pickling check: it loads the pickled
#: operator, applies it and prints the sha256 of u's rows, the nvcc builds
#: it made and its K1 launches.
PICKLED_RUN = """
import hashlib, json, pickle, sys, torch
from devito_tpu_torch import switchconfig
from devito_tpu_torch.kernels import stencil as K
with switchconfig(device=sys.argv[2]):
    op = pickle.load(open(sys.argv[1], 'rb'))
    op.apply(time_m=1, time_M=int(sys.argv[3]), dt=float(sys.argv[4]))
    u = op._reads['u']._device_array()
    print(json.dumps({'sha': hashlib.sha256(
        u.cpu().contiguous().numpy().tobytes()).hexdigest(),
        'builds': len(K.build_seconds), 'launches': K.launches}))
"""


def sha(t):
    import hashlib
    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()


def options_phase(device, sizes, count):
    """(6) spatial bounds on the headline operator: an interior box given
    as x_m/x_M, y_m/y_M, z_m/z_M and again as the bare x= (x_m at 0), each
    over ``p12_bound_steps`` steps against the same bounded runner on the
    plain version, the points outside the box untouched; then the whole
    domain; (7) the errctl scan on the forward shot (``fwd_n``, 412 steps)
    beside the same shot without it, and on the headline operator with a
    zero velocity, which raises ExecutionError at the first check after
    the blow-up; (8) the headline operator pickled, then rerun here and in
    a new process, bit-equal to the original, with no nvcc build; (9)
    autotune='basic' launching what the untuned run launches."""
    import pickle
    import tempfile
    from devito_tpu_torch import Operator, ExecutionError
    from devito_tpu_torch.compiler.executor import plan_rows
    from devito_tpu_torch.kernels import stencil as K
    on_card = device.type == 'cuda'
    n = sizes['p12_n']
    dt_ = 0.6 * 10.0 / 1.5 / (3 ** 0.5) / 4
    res = {}
    op, fns = headline_operator(n, device)
    u = fns['u']
    snap = u._device_array().clone()
    (_, whole), = op.kernel_plans

    # -- (6) spatial bounds -------------------------------------------------
    nb = sizes['p12_bound_steps']
    (xa, xb), (ya, yb), (za, zb) = sizes['p12_box']
    boxes = {'x_m/x_M': dict(x_m=xa, x_M=xb, y_m=ya, y_M=yb, z_m=za, z_M=zb),
             'bare x=': dict(x=xb, y_m=ya, y_M=yb, z_m=za, z_M=zb)}
    bres = res['bounds'] = {}
    for lab, kw in boxes.items():
        u._device_array().copy_(snap)
        _, by = count(lambda: op.apply(time_m=1, time_M=nb, dt=dt_, **kw))
        got = u._device_array().clone()
        sb = {d: (kw.get(f'{d}_m'), kw.get(f'{d}_M', kw.get(d)))
              for d in 'xyz'}
        runner = op._bounded_runner(sb)
        (eq, plan), = runner.plans
        bufs, hp = op.arguments(time_m=1, time_M=nb, dt=dt_)
        bufs['u'].copy_(snap)
        for t in range(1, nb + 1):
            K.stencil_update_reference(plan, plan_rows(plan, bufs, t, hp),
                                       hp)
        sync(device)
        box = (slice(None),) + tuple(slice(8 + a, 8 + b) for a, b in
                                     eq.region)
        err = (got[box] - bufs['u'][box]).abs().max().item()
        tol = RUN_TOL[np.float32] * bufs['u'][box].abs().max().item()
        changed = got != snap
        changed[box] = False
        untouched = not bool(changed.any())
        del changed
        if not (err <= tol and untouched and
                by == {plan.design: on_card * nb, 'stream' if
                       plan.design == 'point' else 'point': 0}):
            raise AssertionError(f"bounds {lab}: max|kernel - plain| "
                                 f"{err:.3e} (tolerance {tol:.3e}), the "
                                 f"outside untouched: {untouched}, K1 {by}")
        bres[lab] = dict(region=eq.region, design=plan.design,
                         reason=plan.design_reason, err=err, tol=tol,
                         launches=by, same_unit=plan.key == whole.key,
                         tx=(plan.tile or {}).get('tx'))
        log(f"[p12-bounds] {lab} {kw}: region {eq.region} on the "
            f"{plan.design} design (x-chunk {bres[lab]['tx']}: "
            f"{(eq.region[0][1] - eq.region[0][0])} x-planes), the same unit "
            f"as the whole domain's: {plan.key == whole.key}; {nb} steps "
            f"against the plain version max|diff| {err:.3e} (tolerance "
            f"{tol:.3e}), outside the box untouched; K1 {by}")
        del got, bufs
    u._device_array().copy_(snap)
    _, by = count(lambda: op.apply(time_m=1, time_M=nb, dt=dt_))
    if by != {whole.design: on_card * nb,
              'stream' if whole.design == 'point' else 'point': 0}:
        raise AssertionError(f"the whole domain after the boxes: K1 {by}")
    bres['whole'] = dict(launches=by)
    log(f"[p12-bounds] then the whole domain: K1 {by}")

    # -- (8) pickling ------------------------------------------------------
    u._device_array().copy_(snap)
    nps = sizes['p12_pickle_steps']
    builds = len(K.build_seconds)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / 'headline.pkl'
        tic = time.perf_counter()
        with open(path, 'wb') as f:
            pickle.dump(op, f, protocol=pickle.HIGHEST_PROTOCOL)
        dump_s = time.perf_counter() - tic
        op.apply(time_m=1, time_M=nps, dt=dt_)
        want = sha(u._device_array())
        tic = time.perf_counter()
        with open(path, 'rb') as f:
            op2 = pickle.load(f)
        load_s = time.perf_counter() - tic
        _, by = count(lambda: op2.apply(time_m=1, time_M=nps, dt=dt_))
        here = sha(op2._reads['u']._device_array())
        del op2
        release(device)
        proc = subprocess.run(
            [sys.executable, '-c', PICKLED_RUN, str(path), device.type,
             str(nps), repr(dt_)], capture_output=True, text=True,
            timeout=600, cwd=str(Path(__file__).resolve().parent))
        if proc.returncode != 0:
            raise AssertionError(f"the pickled operator in a new process: "
                                 f"{proc.stderr[-2000:]}")
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        size = path.stat().st_size
    if not (here == want == fresh['sha'] and fresh['builds'] == 0 and
            len(K.build_seconds) == builds and
            fresh['launches'] == on_card * nps):
        raise AssertionError(f"pickling: rerun here {here == want}, in a new "
                             f"process {fresh['sha'] == want}, nvcc builds "
                             f"there {fresh['builds']}, here "
                             f"{len(K.build_seconds) - builds}")
    res['pickle'] = dict(bytes=size, dump_s=dump_s, load_s=load_s,
                         launches=by, fresh=fresh, bit_equal=True)
    log(f"[p12-pickle] the headline operator pickled ({size / 1e9:.2f} GB, "
        f"its functions' data in; dump {dump_s:.1f} s, load {load_s:.1f} s):"
        f" {nps} steps here and in a new process bit-equal to the original "
        f"(sha256 {want[:16]}), no nvcc build in either, K1 {by} here, "
        f"{fresh['launches']} there")

    # -- (9) autotune -------------------------------------------------------
    _, untuned = count(lambda: op.apply(time_m=1, time_M=nps, dt=dt_))
    _, tuned = count(lambda: op.apply(time_m=1, time_M=nps, dt=dt_,
                                      autotune='basic'))
    if tuned != untuned:
        raise AssertionError(f"autotune='basic' launched {tuned}, untuned "
                             f"{untuned}")
    res['autotune'] = dict(untuned=untuned, tuned=tuned)
    log(f"[p12-autotune] autotune='basic' accepted (no tuner: runs "
        f"untuned): K1 {tuned}, as untuned {untuned}")

    # -- (7) errctl ----------------------------------------------------------
    bad = Operator(fns['eq'], subs=op._grid.spacing_map,
                   opt=('advanced', {'errctl': 'max'}))
    u._device_array().copy_(snap)
    vp = fns['vp']._device_array()
    keep = vp[8 + n // 2, 8 + n // 2, 8 + n // 2].item()
    vp[8 + n // 2, 8 + n // 2, 8 + n // 2] = 0.

    def attempt():
        try:
            bad.apply(time_m=1, time_M=sizes['p12_err_steps'], dt=dt_)
        except ExecutionError as e:
            return str(e)
    raised, _ = count(attempt)
    blow = K.launches
    vp[8 + n // 2, 8 + n // 2, 8 + n // 2] = keep
    if raised is None or 'at step 100' not in raised or \
            blow != on_card * 100:
        raise AssertionError(f"errctl: a zero velocity raised {raised!r} "
                             f"after {blow} K1 launches")
    del bad, op, fns, u, snap, vp
    release(device)
    res['errctl'] = dict(raised=raised, launches_before_halt=blow,
                         shot=errctl_shot(device, sizes, count))
    log(f"[p12-errctl] a zero velocity at the centre: {raised!r} after "
        f"{blow} K1 launches (u is non-finite from step 1; slot 0 holds it "
        f"at the check of step 100)")
    return res


def errctl_shot(device, sizes, count):
    """The forward shot (phase 5's, 412 steps) with errctl='max' and
    without, each run twice (the second warm): their warm loop ms a step,
    the scan's checks, and records equal to the bit."""
    from devito_tpu_torch.compiler import executor as E
    from devito_tpu_torch.models.seismic import AcousticWaveSolver
    base = forward_solver(sizes['fwd_n'], sizes['fwd_nbl'], sizes['fwd_tn'],
                          sizes['fwd_nrec'])
    checks = []
    orig = E._unstable

    def spy(b, names):
        checks.append(names)
        return orig(b, names)
    out = {}
    E._unstable = spy
    try:
        for lab, opt in (('errctl', ('advanced', {'errctl': 'max'})),
                         ('plain', None)):
            s = AcousticWaveSolver(base.model, base.geometry, space_order=8,
                                   opt=opt)
            build_units([s.op_fwd(None)], device)
            checks.clear()
            (rec, _, summ), by = count(lambda: s.forward())
            nsteps = s.geometry.nt - 2
            first = summ.globals['fdlike'].time * 1e3 / nsteps
            ncheck = len(checks)
            warm = s.forward()[2].globals['fdlike'].time * 1e3 / nsteps
            out[lab] = dict(rec=np.array(rec.data), first_ms=first,
                            warm_ms=warm, checks=ncheck, launches=by,
                            steps=nsteps)
            del s, rec, summ
            release(device)
    finally:
        E._unstable = orig
    same = np.array_equal(out['errctl'].pop('rec'), out['plain'].pop('rec'))
    want = out['errctl']['steps'] // 100      # t = 100, 200, ... of 1..
    if not same or out['errctl']['checks'] != want or out['plain']['checks']:
        raise AssertionError(f"errctl shot: records equal {same}, checks "
                             f"{out['errctl']['checks']} (want {want})")
    e, p = out['errctl'], out['plain']
    log(f"[p12-errctl] forward shot {sizes['fwd_n']}^3 + nbl "
        f"{sizes['fwd_nbl']}, {e['steps']} steps: with errctl='max' warm "
        f"{e['warm_ms']:.4f} ms/step (first {e['first_ms']:.4f}), "
        f"{e['checks']} checks; without {p['warm_ms']:.4f} ms/step (first "
        f"{p['first_ms']:.4f}); the scan's cost "
        f"{e['warm_ms'] - p['warm_ms']:.4f} ms/step; records equal to the "
        f"bit")
    del base
    return out


def mem_available():
    """The host's MemAvailable in bytes (/proc/meminfo)."""
    with open('/proc/meminfo') as f:
        for ln in f:
            if ln.startswith('MemAvailable:'):
                return int(ln.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def rss():
    """(the resident set of this process, its peak so far) in bytes:
    /proc/self/status VmRSS and getrusage's ru_maxrss."""
    import resource
    with open('/proc/self/status') as f:
        now = next(int(ln.split()[1]) * 1024 for ln in f
                   if ln.startswith('VmRSS:'))
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def rows_solver(model, rows, sizes):
    """The forward shot's solver on ``model`` with a time axis of
    ``rows`` samples: a save=True wavefield of ``rows`` rows, rows - 2
    steps."""
    s = forward_solver(sizes['p13_n'], sizes['fwd_nbl'],
                       (rows - 1.5) * float(model.critical_dt),
                       sizes['fwd_nrec'], model=model)
    if s.geometry.nt != rows:
        raise AssertionError(f"a time axis of {s.geometry.nt} samples, "
                             f"not {rows}")
    return s


def chunk_lines(label, op, link):
    """Log and return ``op``'s last streamed apply, a chunk a line: the
    ms and GB/s of its host-to-staging, staging-to-device, compute,
    device-to-staging and staging-to-host parts, beside the host link's
    data-sheet rate ``link`` (bytes/s)."""
    rows = []
    for r in op._stream_log:
        row = {'steps': list(r['steps'])}
        parts = []
        for p in ('pin', 'h2s', 's2d', 'compute', 'd2s', 's2h'):
            if p not in r:
                continue
            ms, nb = r[p]
            row[p] = dict(ms=ms, bytes=nb,
                          gbs=nb / ms / 1e6 if nb and ms > 0 else None)
            parts.append(f"{p} {ms:.2f} ms" + (
                f" ({nb / ms / 1e6:.2f} GB/s)" if nb and ms > 0 else ''))
        rows.append(row)
        log(f"[p13-chunk] {label} steps {r['steps'][0]}-{r['steps'][1]}: "
            + ', '.join(parts) + f"; host link {link / 1e9:.0f} GB/s a "
            f"direction (data sheet)")
    return rows


def streaming_phase(device, sizes, record):
    """Phase 13: host streaming of save wavefields, measured profiling and
    the platform row on the forward shot's model (``p13_n``^3 + nbl, SO=8,
    fp32). (1) ``p13_rows`` saved rows, resident ('off') and streamed
    ('on', a budget of ``p13_K`` + 2 rows; ``both_fit``); (2) the smallest
    save above 1.2 x the card's memory, capped at ``p13_host_share`` of
    the host's MemAvailable, under the default 'auto' and budget
    (``larger``); (3) ``p13_prof_steps`` steps of the shot under
    profiling='measured' with a profile-dir (``measured``); (4) the
    platform row (``platform``). Every drive has K1's counts at 0 just
    before it and read just after; its launches add to K1's main path.
    Returns the phase's record (also ``record['phase13']``)."""
    from devito_tpu_torch.arch import get_platform
    from devito_tpu_torch.kernels import stencil as K
    on_card = device.type == 'cuda'
    tic0 = time.perf_counter()
    res = record['phase13'] = {}
    release(device)
    avail = mem_available()
    card = sizes.get('p13_card_bytes') or (
        torch.cuda.get_device_properties(device).total_memory if on_card
        else None)
    plat = get_platform(device)
    res['start'] = dict(mem_available=avail, card_bytes=card,
                        platform=plat.name, rss=rss()[0])
    log(f"[p13] host MemAvailable {avail / 1e9:.2f} GB, card memory "
        + (f"{card / 1e9:.2f} GB" if card else 'none')
        + f", process RSS {rss()[0] / 1e9:.2f} GB; "
        + (smi() if on_card else 'cpu'))

    def count(fn):
        """fn() with K1's counts at 0 just before it; (its result, its
        launches by design), read just after; they add to K1's main
        path."""
        K.launches = 0
        K.launches_by_design.update(point=0, stream=0)
        probe_launches(zero=True)
        out = fn()
        sync(device)
        by = dict(K.launches_by_design)
        if any(probe_launches().values()):
            raise AssertionError("phase 13 launched a probe kernel")
        record['launches'] += K.launches
        record['launches_main_path'] = record['launches']
        return out, by

    model = forward_solver(sizes['p13_n'], sizes['fwd_nbl'], 10.,
                           sizes['fwd_nrec']).model
    res['both_fit'] = both_fit(device, sizes, model, count)
    release(device)
    empty_host_cache()
    res['larger'] = larger_than_card(device, sizes, model, count, card)
    release(device)
    empty_host_cache()
    res['measured'] = measured_profile(device, sizes, model, count, plat)
    release(device)
    res['platform'] = platform_row(device, record, plat)
    res['seconds'] = time.perf_counter() - tic0
    log(f"[p13] phase 13 in {res['seconds']:.1f} s")
    return res


def empty_host_cache():
    """Give the pinned blocks torch's host allocator keeps cached back to
    the host, where this torch has the call."""
    if torch.cuda.is_available() and hasattr(torch._C, '_host_emptyCache'):
        torch._C._host_emptyCache()


def with_peak(fn, count, device):
    """(fn()'s result, its launches, the peak device memory in it, the
    memory held before it); the peaks are None off the card."""
    on_card = device.type == 'cuda'
    held = torch.cuda.memory_allocated(device) if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    out, by = count(fn)
    top = torch.cuda.max_memory_allocated(device) if on_card else None
    return out, by, top, held


def drive_row(op, summary, steps, by, wall, peak, held, est, link,
              label):
    """A streamed or resident run's record: loop ms a step (CUDA events),
    wall seconds, K1 launches, peak and held device memory, the
    operator's ``estimate_memory(layers=True)`` and, when it streamed,
    its plan and each chunk (``chunk_lines``)."""
    plan = op._stream_plan
    row = dict(loop_ms_per_step=summary.globals['fdlike'].time * 1e3 /
               steps, wall_s=wall, launches=by, peak=peak, held=held,
               estimate=est, K=plan and plan['K'],
               rows=plan and plan['rows'])
    if plan is not None:
        row['chunks'] = chunk_lines(label, op, link)
    log(f"[p13] {label}: loop {row['loop_ms_per_step']:.4f} ms/step, wall "
        f"{wall:.2f} s, K1 {by}"
        + (f", K {row['K']} ({len(row['chunks'])} chunks, windows of "
           f"{row['rows']} rows)" if plan is not None else '')
        + "; peak device memory "
        + (f"{peak / 1e9:.2f} GB, {(peak - held) / 1e9:.2f} above the "
           f"{held / 1e9:.2f} held before" if peak is not None else
           'not measured')
        + (f"; estimate_memory(layers=True) device {est['device'] / 1e9:.2f}"
           f" GB, host {est['host'] / 1e9:.2f} GB" if est else ''))
    return row


def both_fit(device, sizes, model, count):
    """Phase 13 (1): ``p13_rows`` saved rows, resident ('off') then
    streamed ('on', a budget of ``p13_K`` + 2 rows: K = ``p13_K`` for the
    forward, + 2 for the gradient, which reads u at t alone), after a
    first resident run that takes the units' first launches: the forward's
    rows and record and the gradient bit-equal both ways, one K1 launch a
    step, no new unit."""
    from devito_tpu_torch import switchconfig, configuration
    from devito_tpu_torch.arch import platform_registry
    from devito_tpu_torch.kernels import stencil as K
    on_card = device.type == 'cuda'
    link = platform_registry['nvidia-h100-sxm'].host_bw
    rows = sizes['p13_rows']
    s = rows_solver(model, rows, sizes)
    fop, gop = s.op_fwd(True), s.op_grad()
    build_s = build_units([fop, gop, s.op_fwd(None), s.op_grad(save=False)],
                          device, ('increment',))
    u_fn = fop._reads['u']
    row_bytes = int(np.prod(u_fn.shape_allocated[1:])) * 4
    steps = rows - 2
    out = dict(rows=rows, row_bytes=row_bytes, build_s=build_s)
    log(f"[p13] (1) {sizes['p13_n']}^3 + nbl {sizes['fwd_nbl']}: a saved "
        f"row {row_bytes / 1e9:.4f} GB ({u_fn.shape_allocated[1:]} fp32), "
        f"{rows} rows = {rows * row_bytes / 1e9:.2f} GB; K1 units built in "
        f"{build_s:.1f} s")
    with switchconfig(**{'save-streaming': 'off'}):
        (rec, u, fsum), _ = count(lambda: s.forward(save=True))
        (g, gsum), _ = count(lambda: s.jacobian_adjoint(rec, u))
    out['first'] = dict(
        forward_ms_per_step=fsum.globals['fdlike'].time * 1e3 / steps,
        gradient_ms_per_step=gsum.globals['fdlike'].time * 1e3 / steps)
    del rec, u, g
    release(device)
    nbuilds = len(K.build_seconds)
    keep = {}
    budget = (sizes['p13_K'] + 2) * row_bytes
    for way, mode, bud in (('resident', 'off', configuration['save-budget']),
                           ('streamed', 'on', budget)):
        with switchconfig(**{'save-streaming': mode, 'save-budget': bud}):
            est = (fop.estimate_memory(layers=True),
                   gop.estimate_memory(layers=True))
            tic = time.perf_counter()
            (rec, u, fsum), fby, fpeak, fheld = with_peak(
                lambda: s.forward(save=True), count, device)
            fwall = time.perf_counter() - tic
            r = np.array(rec.data)
            frow = drive_row(fop, fsum, steps, fby, fwall, fpeak, fheld,
                             est[0], link, f"(1) {way} forward")
            empty_host_cache()
            tic = time.perf_counter()
            (g, gsum), gby, gpeak, gheld = with_peak(
                lambda: s.jacobian_adjoint(rec, u), count, device)
            grow = drive_row(gop, gsum, steps, gby, time.perf_counter() - tic,
                             gpeak, gheld, est[1], link, f"(1) {way} gradient")
            empty_host_cache()
        want = {'stream': on_card * steps, 'point': 0}
        if fby != want or gby != want or \
                (frow['K'] is None) != (mode == 'off') or \
                (grow['K'] is None) != (mode == 'off'):
            raise AssertionError(f"(1) {way}: K1 launched {fby} (forward), "
                                 f"{gby} (gradient) for {steps} steps; K "
                                 f"{frow['K']}, {grow['K']}")
        out[way] = dict(forward=frow, gradient=grow)
        keep[way] = (r, u, g)
    if len(K.build_seconds) != nbuilds:
        raise AssertionError("(1) a timed run built a K1 unit")
    (r0, u0, g0), (r1, u1, g1) = keep.pop('resident'), keep.pop('streamed')
    dev0, host1 = u0._device_array(), type(u1)._host_buf
    same_rows = all(torch.equal(dev0[i], torch.from_numpy(host1[i]).to(
        device)) for i in range(rows))
    gdiff = (g0._device_array() - g1._device_array()).abs().max().item()
    same = dict(rows=same_rows, rec=bool(np.array_equal(r0, r1)),
                gradient=gdiff == 0)
    out.update(bit_equal=same, gradient_max_abs_diff=gdiff)
    first = out['first']
    log(f"[p13] (1) streamed against resident: {rows} u rows bit-equal "
        f"{same_rows}, record bit-equal {same['rec']}, gradient max|diff| "
        f"{gdiff:.3e}; first resident run "
        f"{first['forward_ms_per_step']:.4f} (forward), "
        f"{first['gradient_ms_per_step']:.4f} (gradient) ms/step")
    if not all(same.values()):
        raise AssertionError(f"(1) streamed and resident differ: {same}")
    return out


def larger_than_card(device, sizes, model, count, card):
    """Phase 13 (2): the smallest save above 1.2 x the card's memory,
    capped at ``p13_host_share`` of the host's MemAvailable (read here),
    forward and gradient under the default 'auto' and budget (or
    ``p13_auto_budget`` where there is no card): the plan engages by
    itself; the record bit-equal to the save=False forward's (within TOL x
    max where the two take other K1 designs), the gradient within TOL x
    max of the checkpointed one."""
    from devito_tpu_torch import switchconfig, configuration
    from devito_tpu_torch.arch import platform_registry
    link = platform_registry['nvidia-h100-sxm'].host_bw
    on_card = device.type == 'cuda'
    tic0 = time.perf_counter()
    avail = mem_available()
    s = rows_solver(model, 8, sizes)
    row_bytes = int(np.prod(s.op_fwd(True)._reads['u'].shape_allocated[1:])) \
        * 4
    want_rows = int(1.2 * card // row_bytes) + 1 if card else None
    cap = int(sizes['p13_host_share'] * avail // row_bytes)
    rows = min(want_rows, cap) if want_rows else cap
    why = None
    if want_rows is None or cap < want_rows:
        why = (f"the host holds {cap} rows ({cap * row_bytes / 1e9:.1f} GB, "
               f"{100 * sizes['p13_host_share']:.0f} % of MemAvailable "
               f"{avail / 1e9:.1f} GB), fewer than the {want_rows} rows "
               f"above 1.2 x the card"
               + (f" ({1.2 * card / 1e9:.1f} GB)" if card else ''))
        log(f"[p13] (2) {why}: the largest save it holds instead")
    out = dict(rows=rows, wanted_rows=want_rows, cap_rows=cap,
               mem_available=avail, save_bytes=rows * row_bytes, reason=why)
    s = rows_solver(model, rows, sizes)
    steps = rows - 2
    fop, gop = s.op_fwd(True), s.op_grad()
    build_units([fop, gop, s.op_fwd(None), s.op_grad(save=False)], device,
                ('increment',))
    cfg = {}
    if sizes.get('p13_auto_budget'):
        cfg['save-budget'] = sizes['p13_auto_budget']
    elif configuration['save-budget'] != 4 << 30 or \
            configuration['save-streaming'] != 'auto':
        raise AssertionError("(2) runs under the default save-streaming "
                             "'auto' and save-budget 4 GiB")
    with switchconfig(**cfg):
        tic = time.perf_counter()
        (rec, u, fsum), fby, fpeak, fheld = with_peak(
            lambda: s.forward(save=True), count, device)
        out['forward'] = drive_row(fop, fsum, steps, fby,
                                   time.perf_counter() - tic, fpeak, fheld,
                                   None, link, f"(2) {rows} rows forward")
        r_str = np.array(rec.data)
        out['rss_after_forward'] = rss()[0]
        empty_host_cache()
        tic = time.perf_counter()
        (g, gsum), gby, gpeak, gheld = with_peak(
            lambda: s.jacobian_adjoint(rec, u), count, device)
        out['gradient'] = drive_row(gop, gsum, steps, gby,
                                    time.perf_counter() - tic, gpeak, gheld,
                                    None, link, f"(2) {rows} rows gradient")
        g_str = g._device_array().clone()
        empty_host_cache()
    out['rss_peak'] = rss()[1]
    want = {'stream': on_card * steps, 'point': 0}
    if fby != want or gby != want or out['forward']['K'] is None or \
            out['gradient']['K'] is None or \
            min(len(out[p]['chunks']) for p in ('forward', 'gradient')) < 3:
        raise AssertionError(f"(2) K1 launched {fby}, {gby} for {steps} "
                             f"steps; the plans engaged: "
                             f"{out['forward']['K']}, {out['gradient']['K']}")
    del g
    release(device)
    (rec0, _, _), _ = count(lambda: s.forward(save=False))
    r_ref = np.array(rec0.data)
    designs = {'save=True': [p.design for _, p in fop.kernel_plans],
               'save=False': [p.design for _, p in
                              s.op_fwd(None).kernel_plans]}
    same_design = designs['save=True'] == designs['save=False']
    rerr = float(np.abs(r_str - r_ref).max())
    rtol = TOL[np.float32] * float(np.abs(r_ref).max())
    if not (rerr == 0 or (not same_design and rerr <= rtol)):
        raise AssertionError(f"(2) the streamed record differs from the "
                             f"save=False forward's by {rerr:.3e} (designs "
                             f"{designs})")
    (gck, _), _ = count(lambda: s.jacobian_adjoint(rec0, None,
                                                   checkpointing=True))
    g_ck = gck._device_array()
    gerr = (g_str - g_ck).abs().max().item()
    gtol = TOL[np.float32] * g_ck.abs().max().item()
    if not gerr <= gtol:
        raise AssertionError(f"(2) streamed gradient against the "
                             f"checkpointed one: {gerr:.3e} > {gtol:.3e}")
    out.update(rec_max_abs_diff=rerr, rec_tol=rtol, same_design=same_design,
               designs=designs, grad_max_abs_diff=gerr, grad_tol=gtol,
               seconds=time.perf_counter() - tic0)
    log(f"[p13] (2) {rows} rows ({rows * row_bytes / 1e9:.2f} GB): record "
        f"against the save=False forward's max|diff| {rerr:.3e} (K1 designs "
        f"{designs}); gradient against the checkpointed one max|diff| "
        f"{gerr:.3e} (tolerance {gtol:.3e}); host RSS after the forward "
        f"{out['rss_after_forward'] / 1e9:.2f} GB, the process's peak "
        f"{out['rss_peak'] / 1e9:.2f} GB; {out['seconds']:.1f} s")
    return out


def measured_profile(device, sizes, model, count, plat):
    """Phase 13 (3): ``p13_prof_steps`` steps of the forward shot
    (save=False) under profiling='measured' with a profile-dir: the trace
    file parses, every body section has device time (on the card), the
    busy time is within 1.02 x the loop's CUDA-event time; beside it the
    unattributed events, and the loop ms a step with no profiler (the
    program's spans closed) and under the profiler; apply's roofline line
    names ``plat``."""
    import logging
    import tempfile
    from devito_tpu_torch import switchconfig
    from devito_tpu_torch.logger import logger
    on_card = device.type == 'cuda'
    steps = sizes['p13_prof_steps']
    s = rows_solver(model, steps + 2, sizes)
    op = s.op_fwd(None)
    build_units([op], device)
    s.forward()
    basic = s.forward()[2].globals['fdlike'].time * 1e3 / steps
    msgs = []

    class Keep(logging.Handler):
        def emit(self, r):
            msgs.append(r.getMessage())
    keep = Keep()
    logger.addHandler(keep)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with switchconfig(**{'profiling': 'measured', 'profile-dir': tmp,
                                 'log-level': 'PERF'}):
                (_, _, summary), by = count(lambda: s.forward())
            traces = sorted(Path(tmp).glob('*.pt.trace.json'))
            if len(traces) != 1:
                raise AssertionError(f"(3) {len(traces)} trace files")
            with open(traces[0]) as f:
                nev = len(json.load(f)['traceEvents'])
            tbytes = traces[0].stat().st_size
    finally:
        logger.removeHandler(keep)
    if by != {'stream': on_card * steps, 'point': 0}:
        raise AssertionError(f"(3) K1 launched {by}")
    secs = op._measured_secs
    if on_card and secs is None:
        raise AssertionError("(3) measured profiling on the card: no device "
                             "event in the trace")
    loop = summary.globals['fdlike'].time
    per = {lab: (secs or {}).get(f'dtpu_sec{i}', 0.) * 1e3 / steps
           for i, (lab, *_) in enumerate(op._sections)}
    other = op._measured_other
    busy = sum((secs or {}).values()) + other
    lost = op._measured_unattributed
    cats = {k: v * 1e3 / steps for k, v in
            (op._measured_cats or {}).items()}
    if on_card and (min(per.values()) <= 0 or busy > 1.02 * loop):
        raise AssertionError(f"(3) sections {per} ms/step, busy {busy:.4f} "
                             f"s against the loop's {loop:.4f} s")
    roof = [m for m in msgs if 'HBM roofline' in m]
    if not roof or f"of {plat.name} HBM roofline" not in roof[0]:
        raise AssertionError(f"(3) no roofline of {plat.name} in the log: "
                             f"{roof}")
    out = dict(
        steps=steps, sections_ms_per_step=per,
        other_ms_per_step=other * 1e3 / steps,
        busy_ms_per_step=busy * 1e3 / steps,
        loop_ms_per_step=loop * 1e3 / steps,
        unattributed=lost, categories=cats,
        basic_ms_per_step=basic,
        trace_events=nev, trace_bytes=tbytes,
        log_line=roof[0].replace('\x1b[32m', '').replace('\x1b[0m', ''))
    log(f"[p13] (3) {steps} steps under profiling='measured': "
        + ', '.join(f"{lab} {v:.4f}" for lab, v in per.items())
        + f" ms/step of device time, outside the sections "
        f"{out['other_ms_per_step']:.4f}; busy {out['busy_ms_per_step']:.4f} "
        f"against the loop's {out['loop_ms_per_step']:.4f} ms/step (CUDA "
        f"events); {out['unattributed']} device events unattributed; "
        f"categories " + ', '.join(f"{k} {v:.4f}" for k, v in
                                   out['categories'].items() if v)
        + f"; the trace {nev} events, {tbytes / 1e6:.1f} MB")
    log(f"[p13] (3) loop ms/step with no profiler (the spans closed) "
        f"{basic:.4f}")
    log(f"[p13] (4) apply's line: {out['log_line']}")
    return out


def platform_row(device, record, plat):
    """Phase 13 (4): ``plat`` (get_platform of the card) is the registry
    row of the card's name, and the bounds (``set_bound``) read their
    peaks from the nvidia-h100-sxm row: K1's bound unchanged."""
    from devito_tpu_torch.arch import (_classify, platform_registry,
                                       CPU_GENERIC)
    from devito_tpu_torch.experiments import (bound_ms, HBM_BYTES_S,
                                              FP32_FLOP_S)
    on_card = device.type == 'cuda'
    name = torch.cuda.get_device_name(device) if on_card else 'cpu'
    sxm = platform_registry['nvidia-h100-sxm']
    again = bound_ms(record['bound_bytes'], record['bound_flops'])
    if plat is not _classify(name) or (on_card and plat is CPU_GENERIC) or \
            (HBM_BYTES_S, FP32_FLOP_S) != (sxm.hbm_bw, sxm.fp32_flops) or \
            again != (record['bound_ms'], record['bound_by']):
        raise AssertionError(f"(4) platform {plat.name} for {name!r}; "
                             f"bounds from {HBM_BYTES_S}, {FP32_FLOP_S}")
    log(f"[p13] (4) get_platform: {plat.name} for {name!r}; set_bound reads "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s and {FP32_FLOP_S / 1e12:.0f} TFLOP/s "
        f"from nvidia-h100-sxm: K1's bound {record['bound_ms']:.4f} ms "
        f"({record['bound_by']}), as before")
    return dict(device_name=name, row=plat._asdict(),
                k1_bound_ms=record['bound_ms'])


def set_topology(grid, topology):
    """Attach a mesh of ``topology`` over the default mesh's devices
    (``mesh-devices`` shards) to ``grid``, or detach it (None)."""
    from devito_tpu_torch.parallel.distributor import Distributor
    grid._distributor = None if topology is None else \
        Distributor(grid, topology=topology)


def shot_solver(model, steps, sizes):
    """The forward shot's solver on ``model``: ``steps`` steps (a time axis
    of steps + 2 samples), its own operators."""
    s = forward_solver(sizes['p14_n'], sizes['fwd_nbl'],
                       (steps + 0.5) * float(model.critical_dt),
                       sizes['fwd_nrec'], model=model)
    if s.geometry.nt != steps + 2:
        raise AssertionError(f"{s.geometry.nt - 2} steps, not {steps}")
    return s


def shard_launches(op, steps):
    """(K1 launches a sharded apply of ``steps`` steps makes: the shard-
    local items K1 plans, once a step for the body's and once for the
    prologue's and epilogue's; the shard-local items by target, design and
    reason)."""
    hr = op._halo_runner
    body = {id(it) for it in hr.local_schedule.body}
    per = once = 0
    designs = {}
    for _, it, eq, plan in hr.runner.shard_plans:
        key = (eq.target.name, plan.design if plan else 'torch',
               plan.design_reason if plan else 'declined')
        designs[key] = designs.get(key, 0) + 1
        if plan is None:
            continue
        if id(it) in body:
            per += 1
        else:
            once += 1
    return per * steps + once, [dict(target=t, design=d, reason=r, items=n)
                                for (t, d, r), n in sorted(designs.items())]


def domain_tensor(fn):
    """The device view of ``fn``'s domain (its whole tensor between
    applies, sharded or not)."""
    dev = fn._device_array()
    return dev[fn._leading_slices() + tuple(
        slice(hl, hl + n) for n, (hl, hr) in
        zip(type(fn)._space_shape, fn.halo))]


def held_against(label, got, want, rec, rec_want):
    """(wavefield max|diff| / max, bit-equal, record max|diff| / max) of a
    run against the unsharded one; raises beyond RUN_TOL (fp32)."""
    scale = want.abs().max().item()
    err = (got - want).abs().max().item() / scale
    rerr = float(np.abs(rec - rec_want).max() / np.abs(rec_want).max())
    if not (err <= RUN_TOL[np.float32] and rerr <= RUN_TOL[np.float32]):
        raise AssertionError(f"(1) {label}: wavefield {err:.3e}, record "
                             f"{rerr:.3e} x max from the unsharded run")
    return err, bool(torch.equal(got, want)), rerr


def p14_shot(device, sizes, model, topology, count, label, ref=None):
    """Phase 14 (1): the forward shot on ``topology`` (None: unsharded),
    a first and a warm run; the warm run's wavefield and record, checked
    against ``ref`` (the unsharded run's) when given."""
    from devito_tpu_torch.kernels import stencil as K
    steps = sizes['p14_steps']
    set_topology(model.grid, topology)
    s = shot_solver(model, steps, sizes)
    op = s.op_fwd(None)
    build_units([op], device)
    tic = time.perf_counter()
    _, by1 = count(lambda: s.forward())
    first_wall = time.perf_counter() - tic
    nbuilds = len(K.build_seconds)
    tic = time.perf_counter()
    (rec, u, summ), by, peak, held = with_peak(lambda: s.forward(), count,
                                               device)
    wall = time.perf_counter() - tic
    if len(K.build_seconds) != nbuilds:
        raise AssertionError(f"(1) {label}: the warm run built a K1 unit")
    row = dict(topology=topology, first_wall_s=first_wall, wall_s=wall,
               loop_ms_per_step=summ.globals['fdlike'].time * 1e3 / steps,
               launches=sum(by.values()), by_design=by, peak=peak,
               held=held, first_launches=sum(by1.values()))
    hr = op._halo_runner
    if topology is None:
        want_launches = steps
        if hr is not None:
            raise AssertionError("(1) the unsharded shot is sharded")
    else:
        if hr is None:
            raise AssertionError(f"(1) {label}: gathered ({op.halo_decline})")
        want_launches, designs = shard_launches(op, steps)
        step = hr.exchange['step_copies'], hr.exchange['step_bytes']
        moved = op.last_exchange
        row.update(shards=len(hr.shards), designs=designs,
                   exchange_copies_per_step=moved['copies'] / steps,
                   exchange_bytes_per_step=moved['bytes'] / steps,
                   plan_copies_per_step=step[0], plan_bytes_per_step=step[1])
        if (moved['copies'], moved['bytes']) != (steps * step[0],
                                                 steps * step[1]):
            raise AssertionError(f"(1) {label}: the exchange moved {moved}, "
                                 f"the plan's slabs {step} a step")
    if row['launches'] != (device.type == 'cuda') * want_launches:
        raise AssertionError(f"(1) {label}: K1 launched {by}, not "
                             f"{want_launches}")
    r = np.array(rec.data)
    if not (np.isfinite(r).all() and np.abs(r).max() > 0):
        raise AssertionError(f"(1) {label}: the record is not finite and "
                             f"non-zero")
    out = domain_tensor(u).clone() if ref is None else None
    if ref is not None:
        row['err'], row['bit_equal'], row['rec_err'] = held_against(
            label, domain_tensor(u), ref[0], r, ref[1])
    log(f"[p14] (1) {label}: loop {row['loop_ms_per_step']:.4f} ms/step "
        f"(first run's wall {first_wall:.2f} s); K1 {by} = "
        f"{want_launches} expected; peak device memory "
        + (f"{peak / 1e9:.2f} GB ({held / 1e9:.2f} held before the run)"
           if peak is not None else 'not measured')
        + ('' if topology is None else
           f"; {row['shards']} shards; exchange {row['exchange_copies_per_step']:g}"
           f" copies, {row['exchange_bytes_per_step'] / 1e6:.3f} MB a step "
           f"= the plan's {step[0]}, {step[1] / 1e6:.3f} MB; wavefield "
           f"{row['err']:.3e} x max from the unsharded (bit-equal "
           f"{row['bit_equal']}), record {row['rec_err']:.3e}"))
    if topology is not None:
        for d in designs:
            log(f"[p14-design] {label} {d['target']}: {d['items']} shard-"
                f"local items on {d['design']} ({d['reason']})")
    return row, (out, r)


def overlap_us(a, b):
    """Microseconds in which an interval of ``a`` overlaps one of ``b``
    (each a list of (start, end) whose members do not overlap)."""
    return sum(max(0., min(y, t) - max(x, s)) for x, y in a for s, t in b)


def p14_measured(device, sizes, model, topology, count):
    """Phase 14 (1): ``p14_prof_steps`` steps of the shot on ``topology``
    under profiling='measured': K1's device ms a step (every shard), the
    exchange's (its copies, the 'dtpu_exchange' range) and the other
    sections', and the microseconds in which the exchange's copies run
    beside a K1 launch."""
    import tempfile
    from devito_tpu_torch import switchconfig
    from devito_tpu_torch.operator.trace_profile import section_events
    steps = sizes['p14_prof_steps']
    set_topology(model.grid, topology)
    s = shot_solver(model, steps, sizes)
    s.forward()
    with tempfile.TemporaryDirectory() as tmp:
        with switchconfig(**{'profiling': 'measured', 'profile-dir': tmp}):
            (_, _, summ), by = count(lambda: s.forward())
        evs = section_events(tmp) or []
    loop = summ.globals['fdlike'].time * 1e3 / steps
    k1 = [(a, b) for _, cat, a, b, _, _ in evs if cat == 'stencil']
    ex = [(a, b) for name, _, a, b, _, _ in evs if name == 'dtpu_exchange']
    secs = {}
    for name, _, a, b, _, _ in evs:
        secs[name or 'other'] = secs.get(name or 'other', 0.) + (b - a)
    ms = {k: v / 1e3 / steps for k, v in secs.items()}
    both = overlap_us(ex, k1)
    ex_ms = sum(b - a for a, b in ex) / 1e3 / steps
    out = dict(steps=steps, loop_ms_per_step=loop, sections_ms=ms,
               k1_ms_per_step=sum(b - a for a, b in k1) / 1e3 / steps,
               exchange_ms_per_step=ex_ms,
               exchange_events=len(ex), k1_events=len(k1),
               overlap_ms_per_step=both / 1e3 / steps,
               overlaps=both > 0, launches=by)
    if device.type == 'cuda' and not (k1 and ex):
        raise AssertionError(f"(1) measured: {len(k1)} K1 and {len(ex)} "
                             f"exchange device events in the trace")
    log(f"[p14-profile] {topology}, {steps} steps under profiling="
        f"'measured': loop {loop:.4f} ms/step; K1 "
        f"{out['k1_ms_per_step']:.4f} ms/step of device time over "
        f"{len(k1)} launches, the exchange {ex_ms:.4f} ({len(ex)} device "
        f"events); the exchange overlaps K1 for "
        f"{out['overlap_ms_per_step']:.4f} ms/step (overlaps: "
        f"{out['overlaps']}); by section " + ', '.join(
            f"{k} {v:.4f}" for k, v in sorted(ms.items())))
    return out


def p14_gradient(device, sizes, model, count):
    """Phase 14 (2): the checkpointed FWI gradient (jacobian_adjoint,
    checkpointing=True) of ``p14_grad_steps`` steps, the unsharded shot's
    record as the residual, unsharded and on ``p14_grad_topology``; the
    sharded gradient against the unsharded one."""
    steps = sizes['p14_grad_steps']
    set_topology(model.grid, None)
    s = shot_solver(model, steps, sizes)
    resid = np.array(s.forward()[0].data)
    out, ref = {}, None
    for topo in (None, sizes['p14_grad_topology']):
        set_topology(model.grid, topo)
        s = shot_solver(model, steps, sizes)
        rec = s.geometry.rec
        rec.data[:] = resid
        build_units([s.op_fwd(save=False), s.op_grad(save=False)], device,
                    ('increment',))
        tic = time.perf_counter()
        (g, _), by, peak, held = with_peak(
            lambda: s.jacobian_adjoint(rec, None, checkpointing=True),
            count, device)
        wall = time.perf_counter() - tic
        row = dict(wall_s=wall, launches=by, peak=peak, held=held,
                   sharded=s.op_grad(save=False)._halo_runner is not None)
        if row['sharded'] != (topo is not None):
            raise AssertionError(f"(2) {topo}: sharded {row['sharded']}")
        gd = domain_tensor(g)
        if ref is None:
            ref = gd.clone()
        else:
            row['err'] = (gd - ref).abs().max().item() / \
                ref.abs().max().item()
            row['bit_equal'] = bool(torch.equal(gd, ref))
            if not row['err'] <= RUN_TOL[np.float32]:
                raise AssertionError(f"(2) the sharded gradient is "
                                     f"{row['err']:.3e} x max from the "
                                     f"unsharded one")
        out[str(topo)] = row
        log(f"[p14-grad] {topo}: checkpointed gradient of {steps} steps in "
            f"{wall:.2f} s, K1 {by}, peak device memory "
            + (f"{peak / 1e9:.2f} GB" if peak is not None else
               'not measured')
            + ('' if topo is None else
               f"; against the unsharded {row['err']:.3e} x max "
               f"(bit-equal {row['bit_equal']})"))
        del g, gd
        release(device)
    return out


def p14_streaming(device, sizes, count):
    """Phase 14 (3): a ``p14_stream_rows``-row save at ``p14_stream_n``^3 +
    nbl on ``p14_grad_topology``, resident then streamed (save-streaming
    'on', K = ``p14_stream_K``) through the sharded runner: the rows and
    the record bit-equal."""
    from devito_tpu_torch import switchconfig
    rows = sizes['p14_stream_rows']
    model = forward_solver(sizes['p14_stream_n'], sizes['fwd_nbl'], 10.,
                           sizes['fwd_nrec']).model
    set_topology(model.grid, sizes['p14_grad_topology'])
    sz = dict(sizes, p14_n=sizes['p14_stream_n'])
    s = shot_solver(model, rows - 2, sz)
    op = s.op_fwd(True)
    build_units([op], device)
    u_fn = op._reads['u']
    row_bytes = int(np.prod(u_fn.shape_allocated[1:])) * 4
    keep = {}
    for way, mode, bud in (('resident', 'off', 4 << 40),
                           ('streamed', 'on',
                            (sizes['p14_stream_K'] + 2) * row_bytes)):
        with switchconfig(**{'save-streaming': mode, 'save-budget': bud}):
            (rec, u, summ), by = count(lambda: s.forward(save=True))
        if op._halo_runner is None or (op._stream_plan is None) != \
                (mode == 'off'):
            raise AssertionError(f"(3) {way}: sharded "
                                 f"{op._halo_runner is not None}, plan "
                                 f"{op._stream_plan}")
        keep[way] = (np.array(rec.data), np.array(u.data))
        del rec, u
    same = (np.array_equal(keep['resident'][0], keep['streamed'][0]) and
            np.array_equal(keep['resident'][1], keep['streamed'][1]))
    log(f"[p14-stream] {sizes['p14_stream_n']}^3 + nbl {sizes['fwd_nbl']}, "
        f"{rows} rows on {sizes['p14_grad_topology']}: streamed in "
        f"{len(op._stream_log)} chunks of K = {op._stream_plan['K']} through "
        f"the sharded runner, rows and record bit-equal to the resident "
        f"sharded run: {same}")
    if not same:
        raise AssertionError("(3) streamed and resident sharded runs differ")
    set_topology(model.grid, None)
    return dict(rows=rows, chunks=len(op._stream_log), bit_equal=same)


def p14_gathered(device, sizes, count):
    """Phase 14 (5): ``Eq(u.forward, u + b.dx)`` with b's halo written by
    the user (``data_with_halo``): explicit_halo_eligible rejects it, so
    under halo='auto' it runs gathered; its reason printed, its result
    bit-equal to the unsharded run."""
    from devito_tpu_torch import (Grid, TimeFunction, Function, Eq,
                                  Operator, switchconfig)
    n, steps = sizes['p14_gather_n'], sizes['p14_gather_steps']
    out = []
    for topo in (None, sizes['p14_grad_topology']):
        grid = Grid(shape=(n,) * 3, extent=(10. * (n - 1),) * 3)
        set_topology(grid, topo)
        u = TimeFunction(name='ug', grid=grid, space_order=8)
        b = Function(name='bg', grid=grid, space_order=8)
        rng = np.random.default_rng(SEED)
        b.data_with_halo[:] = rng.random(b.data_with_halo.shape,
                                         dtype=np.float32)
        u.data[0] = rng.random((n,) * 3, dtype=np.float32)
        op = Operator(Eq(u.forward, u + 1e-3 * b.dx), name='gathered')
        with switchconfig(halo='auto'):
            _, by = count(lambda: op.apply(time_M=steps - 1, dt=1.))
        out.append((op, domain_tensor(u).clone(), by))
    (_, u0, _), (op, u1, by) = out
    if op._halo_runner is not None or not op.halo_decline or \
            op.gathered_applies != 1:
        raise AssertionError("(5) the ineligible schedule did not run "
                             "gathered")
    same = bool(torch.equal(u0, u1))
    log(f"[p14-gathered] {n}^3 on {sizes['p14_grad_topology']}: runs "
        f"gathered ({op.halo_decline}); {op.gathered_applies} apply "
        f"counted; K1 {by}; bit-equal to the unsharded run: {same}")
    if not same:
        raise AssertionError("(5) the gathered run differs from the "
                             "unsharded one")
    return dict(reason=op.halo_decline, bit_equal=same, launches=by)


def one_shard_a_card(device, sizes, model, ref, count):
    """Phase 14, on a host with more than one card: the forward shot with
    one shard a card (``mesh-devices`` None, topology ('*', '*', 1)), the
    exchange's copies peer copies between the cards, against the
    unsharded run ``ref``, and under profiling='measured'. On one card:
    'not run', logged and counted as not run."""
    from devito_tpu_torch import switchconfig
    ncard = torch.cuda.device_count() if device.type == 'cuda' else 0
    if ncard < 2:
        log(f"[p14] one shard a card: not run ({ncard or 'no'} CUDA device "
            f"visible beside this one); counted as not run")
        return 'not run'
    with switchconfig(**{'mesh-devices': None}):
        row, _ = p14_shot(device, sizes, model, ('*', '*', 1), count,
                          f"one shard a card ({ncard} cards)", ref)
        row['measured'] = p14_measured(device, sizes, model, ('*', '*', 1),
                                       count)
    row['cards'] = ncard
    release(device)
    return row


def sharded_phase(device, sizes, record):
    """Phase 14: multi-device through the port with ``p14_shards`` shards
    on ``device`` (``mesh-devices``): (1) the forward shot unsharded and on
    each of ``p14_topologies``, and the first one under measured
    profiling; (2) the checkpointed gradient; (3) streaming through the
    sharded runner; (4) the uneven topology; (5) a gathered schedule;
    the one-shard-a-card branch where the host has more than one card.
    Every drive has K1's counts at 0 just before it and read just after,
    its launches added to K1's main path. Returns the phase's record (also
    ``record['phase14']``)."""
    from devito_tpu_torch import switchconfig
    from devito_tpu_torch.kernels import stencil as K
    tic0 = time.perf_counter()
    res = record['phase14'] = {}
    release(device)

    def count(fn):
        K.launches = 0
        K.launches_by_design.update(point=0, stream=0)
        probe_launches(zero=True)
        out = fn()
        sync(device)
        by = dict(K.launches_by_design)
        if any(probe_launches().values()):
            raise AssertionError("phase 14 launched a probe kernel")
        record['launches'] += K.launches
        record['launches_main_path'] = record['launches']
        return out, by

    log(f"[p14] {sizes['p14_shards']} shards on {device}: "
        + (smi() if device.type == 'cuda' else 'cpu'))
    model = forward_solver(sizes['p14_n'], sizes['fwd_nbl'], 10.,
                           sizes['fwd_nrec']).model
    with switchconfig(**{'mesh-devices': sizes['p14_shards']}):
        res['unsharded'], ref = p14_shot(device, sizes, model, None, count,
                                         'unsharded')
        for topo in sizes['p14_topologies']:
            res[str(topo)] = p14_shot(device, sizes, model, topo, count,
                                      str(topo), ref)[0]
            release(device)
        res['measured'] = p14_measured(device, sizes, model,
                                       sizes['p14_topologies'][0], count)
    uneven = sizes['p14_uneven']
    with switchconfig(**{'mesh-devices': int(np.prod(uneven))}):
        res['uneven'] = p14_shot(device, sizes, model, uneven, count,
                                 f"{uneven} uneven", ref)[0]
    res['one_shard_a_card'] = one_shard_a_card(device, sizes, model, ref,
                                               count)
    set_topology(model.grid, None)
    del ref, model
    release(device)
    with switchconfig(**{'mesh-devices': sizes['p14_shards']}):
        model = forward_solver(sizes['p14_n'], sizes['fwd_nbl'], 10.,
                               sizes['fwd_nrec']).model
        res['gradient'] = p14_gradient(device, sizes, model, count)
        del model
        release(device)
        res['streaming'] = p14_streaming(device, sizes, count)
        release(device)
        res['gathered'] = p14_gathered(device, sizes, count)
        release(device)
    res['seconds'] = time.perf_counter() - tic0
    log(f"[p14] phase 14 in {res['seconds']:.1f} s")
    return res


# -- phase 15: devito_tpu's examples through the port ------------------------

#: Every example function phase 15 runs, by module of
#: devito_tpu_torch/examples: each at devito_tpu's defaults (FULL's
#: ``p15_args`` may give smaller arguments), multichip's with
#: ``p15_shards`` shards. ``linalg`` runs demo() and the three products
#: demo() leaves out, on demo()'s matrices (``linalg_products``).
EXAMPLES = [
    ('userapi', ('dsl_overview', 'apply_and_arguments', 'subdomains_demo',
                 'boundary_conditions_demo', 'conditional_dimension_demo',
                 'sparse_operations_demo', 'staggered_interpolation_demo',
                 'fd_evaluation_demo')),
    ('cfd', ('linear_convection', 'diffusion', 'burgers', 'poisson',
             'nonlinear_convection', 'laplace', 'cavity_flow',
             'shallow_water', 'darcy_flow')),
    ('seismic_abc', ('reflecting', 'damping_abc', 'pml_abc', 'habc')),
    ('seismic_fwi', ('run_fwi',)),
    ('linalg', ('products',)),
    ('finance', ('black_scholes',)),
    ('compiler_tour', ('lowering_tour', 'introspection_tour')),
    ('multichip', ('sharded_diffusion', 'topologies_demo',
                   'halo_modes_demo'))]
#: Example against its plain version on the CPU, x max|plain|, by dtype.
EX_TOL = {np.dtype(np.float32): 1e-4, np.dtype(np.float64): 1e-10}
#: The dtype an example computes in where its results are wider: run_fwi's
#: objective history is a float64 array of fp32 misfits.
EX_DTYPE = {'seismic_fwi.run_fwi': np.dtype(np.float32)}


def linalg_products(n=8):
    """linalg.demo(n), then transpose_mat_vec, mat_mat and mat_mat_sum on
    its A, B, C and x, into new outputs: every product of the module."""
    from devito_tpu_torch.examples import linalg as L
    A, B, C, D, E, F, x, b = L.demo(n)
    i, j = A.dimensions
    k = B.dimensions[1]
    bt = L.transpose_mat_vec(A, x, L.make_vec('bt', n, i))
    AB = L.mat_mat(A, B, L.make_mat('AB', (n, n), (i, k)))
    ABC = L.mat_mat_sum(A, B, C, L.make_mat('ABC', (n, n), (i, k)))
    return A, B, C, D, E, F, x, b, bt, AB, ABC


def flat(out, key='', acc=None):
    """{key: ndarray, int or str} of an example's result: each function's
    data, each array, number and string, by its path in the result; a
    performance summary (times) is left out, a seismic model gives its
    velocity."""
    import sympy
    acc = {} if acc is None else acc
    if type(out).__name__ == 'PerformanceSummary':
        return acc
    if isinstance(out, dict):
        for k, v in out.items():
            flat(v, f'{key}/{k}', acc)
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            flat(v, f'{key}/{i}', acc)
    elif isinstance(out, np.ndarray):
        acc[key] = out.copy()
    elif hasattr(out, 'vp') and hasattr(out, 'grid'):
        acc[key + '/vp'] = np.array(out.vp.data)
    elif hasattr(out, 'data') and hasattr(out, 'grid'):
        acc[key] = np.array(out.data)
    elif isinstance(out, (bool, int, np.integer)):
        acc[key] = int(out)
    elif isinstance(out, (float, np.floating)):
        acc[key] = np.array(out)
    elif isinstance(out, (str, sympy.Basic)):
        acc[key] = str(out)
    return acc


def run_example(mod, name, kwargs, shards):
    """The example ``mod.name(**kwargs)`` on the configured device,
    flattened (``flat``); multichip's with ``shards`` shards."""
    from devito_tpu_torch import switchconfig
    m = importlib.import_module(f'devito_tpu_torch.examples.{mod}')
    fn = linalg_products if (mod, name) == ('linalg', 'products') else \
        getattr(m, name)
    with switchconfig(**({'mesh-devices': shards} if mod == 'multichip'
                         else {})):
        return flat(fn(**kwargs))


def examples_on_cpu(path, spec):
    """Every example of ``spec`` (JSON: {'args': {name: kwargs}, 'shards':
    n}) through the port on the CPU, its plain versions, pickled into
    ``path`` as {'mod.name': flat result}: phase 15's reference, run in a
    child process beside the card's runs."""
    import pickle
    from devito_tpu_torch import switchconfig
    spec = json.loads(spec)
    # two threads: the card's process and nvcc share the host's cores
    torch.set_num_threads(2)
    out = {}
    with switchconfig(device='cpu'):
        for mod, names in EXAMPLES:
            for name in names:
                key = f'{mod}.{name}'
                out[key] = run_example(mod, name, spec['args'].get(key, {}),
                                       spec['shards'])
    with open(path, 'wb') as f:
        pickle.dump(out, f)


class built_operators:
    """The Operators built inside the ``with`` block, in ``ops``, and the
    number of them applied, in ``applied``."""

    def __enter__(self):
        from devito_tpu_torch.operator.operator import Operator
        self.ops, self.ran = [], set()
        self._saved = init, apply = Operator.__init__, Operator.apply
        ops, ran = self.ops, self.ran

        def record(op, *a, **k):
            init(op, *a, **k)
            ops.append(op)

        def applied(op, **k):
            ran.add(id(op))
            return apply(op, **k)
        Operator.__init__, Operator.apply = record, applied
        return self

    def __exit__(self, *exc):
        from devito_tpu_torch.operator.operator import Operator
        Operator.__init__, Operator.apply = self._saved

    @property
    def applied(self):
        return [op for op in self.ops if id(op) in self.ran]


def all_plans(op):
    """Every (eq, plan or None) of ``op``'s runner, of its sharded runner
    and of the runners it made for overrides of another layout."""
    out = list(op.kernel_plans)
    hr = getattr(op, '_halo_runner', None)
    if hr is not None:
        out += list(hr.runner.plans)
    for rel in getattr(op, '_layout_ops', {}).values():
        out += all_plans(rel)
    return out


def held_example(key, got, want):
    """The card's flat result against the CPU's: every array within
    EX_TOL x max|CPU's| of its dtype (EX_DTYPE's where the example names
    one), every other value equal. Returns the worst ratio of error to
    tolerance; raises with every value that differs."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{key}: results {sorted(got)} against the "
                             f"CPU's {sorted(want)}")
    worst, bad = 0., []
    for k, g in got.items():
        w = want[k]
        if isinstance(w, np.ndarray) and w.dtype.kind == 'f':
            tol = EX_TOL[EX_DTYPE.get(key, w.dtype)] * max(
                float(np.abs(w).max()), 1e-30)
            err = float(np.abs(g - w).max()) if w.size else 0.
            if not (g.shape == w.shape and g.dtype == w.dtype and
                    np.isfinite(g).all() and err <= tol):
                bad.append(f"{k}: {err:.3e} from the CPU's, tolerance "
                           f"{tol:.3e}")
            worst = max(worst, err / tol)
        elif not (np.array_equal(g, w) if isinstance(w, np.ndarray)
                  else g == w):
            bad.append(f"{k}: {g!r} against the CPU's {w!r}")
    if bad:
        raise AssertionError(f"{key}: " + '; '.join(bad))
    return worst


def example_facts(key, res, kwargs):
    """What devito_tpu's own example tests assert, on the result ``res`` of
    the example ``key`` called with ``kwargs``; returns the facts checked,
    as text."""
    if key == 'finance.black_scholes':
        from devito_tpu_torch.examples.finance import call_value_bs
        v, s_axis, nt = res['/0'], res['/1'], res['/2']
        sl = slice(20, -20)
        T = (nt - 1) * kwargs.get('dt0', 0.0005)
        truth = call_value_bs(s_axis[sl], 100.0, T, 0.12, 0.1)
        rms = float(np.sqrt(np.mean((truth - v[nt - 1][sl]) ** 2)))
        if not rms < 0.1:
            raise AssertionError(f"Black-Scholes: RMS {rms} from the closed "
                                 f"form")
        return f"RMS {rms:.4f} from the closed form (< 0.1)"
    if key == 'linalg.products':
        A, B, C, D, E, F, x, b, bt, AB, ABC = (
            res[f'/{i}'].astype(np.float64) for i in range(11))
        checks = [(b, A @ x), (D, A @ B + A @ C), (F, D @ E), (bt, A.T @ x),
                  (AB, A @ B), (ABC, A @ B + A @ C)]
        err = max(float(np.abs(g - w).max() / np.abs(w).max())
                  for g, w in checks)
        if not err < 1e-5:
            raise AssertionError(f"linalg: {err} x max from numpy")
        return f"six products within {err:.2e} x max of numpy's"
    if key == 'seismic_fwi.run_fwi':
        h = res['/0'].ravel()
        if not (h[1] < h[0] and h[-1] < h[0]):
            raise AssertionError(f"FWI: the objective {h} does not decrease")
        return "objective " + ", ".join(f"{v:.6g}" for v in h)
    return ''


def examples_on_card(device, sizes, count, record):
    """Phase 15 (1) and (2): every example at ``p15_args`` on the card,
    each with K1's counts at 0 just before it and read just after; its
    operators' plans and declines; each K1 launch by design, equal to the
    launches its plans counted; no probe kernel. Returns ({key: flat
    result}, {key: log row})."""
    from devito_tpu_torch.kernels import stencil as K
    from devito_tpu_torch.kernels.stencil import decline_reason
    results, rows = {}, {}
    for mod, names in EXAMPLES:
        for name in names:
            key = f'{mod}.{name}'
            tic = time.perf_counter()
            with built_operators() as b:
                res, by = count(lambda: run_example(
                    mod, name, sizes['p15_args'].get(key, {}),
                    sizes['p15_shards']))
            wall = time.perf_counter() - tic
            plans = [pl for op in b.ops for pl in all_plans(op)]
            # a fused unit's plan is each of its equations' (its count once)
            planned = sum(p.launches for p in {
                id(p): p for _, p in plans if p is not None}.values())
            launches = sum(by.values())
            # on the card an applied operator with a plan launches K1
            due = device.type == 'cuda' and any(
                p is not None for op in b.applied for _, p in all_plans(op))
            if launches != planned or due != (launches > 0):
                raise AssertionError(f"{key}: K1 launched {by}, its plans "
                                     f"count {planned} (due: {due})")
            declined = {}
            for eq, p in plans:
                if p is None:
                    why = decline_reason(eq)
                    declined[why] = declined.get(why, 0) + 1
            results[key] = res
            rows[key] = dict(wall_s=wall, launches=by, operators=len(b.ops),
                             plans=sum(p is not None for _, p in plans),
                             declined=declined,
                             applied=len(b.applied),
                             facts=example_facts(
                                 key, res,
                                 sizes['p15_args'].get(key, {})))
            log(f"[p15] {key}: {wall:.2f} s on {device}, {len(b.ops)} "
                f"operators ({len(b.applied)} applied), "
                f"{rows[key]['plans']} K1 plans, K1 {by}; "
                f"declined: " + (', '.join(f'{n} x {w}' for w, n in
                                           declined.items()) or 'none')
                + (f"; {rows[key]['facts']}" if rows[key]['facts'] else ''))
    return results, rows


def energy_order(results):
    """seismic_abc: each treated boundary leaves under a quarter of the
    reflecting run's interior energy (tests/test_abc_methods.py)."""
    from devito_tpu_torch.examples.seismic_abc import interior_energy

    class U:
        def __init__(self, d):
            self.data = d
    e = {n: interior_energy(U(results[f'seismic_abc.{n}']['']))
         for n in ('reflecting', 'damping_abc', 'pml_abc', 'habc')}
    for n in ('damping_abc', 'pml_abc', 'habc'):
        if not e[n] < 0.25 * e['reflecting']:
            raise AssertionError(f"{n}: interior energy {e[n]} against the "
                                 f"reflecting {e['reflecting']}")
    log("[p15] seismic_abc interior energy: " + ', '.join(
        f"{n} {v:.6g}" for n, v in e.items()))
    return e


class fwi_taps:
    """Inside the ``with`` block: each outermost Operator.apply's loop ms a
    step, by kind ('forward', 'save-forward', 'gradient'); the wall clock
    at each model update (``update_with_box``, once an iteration), whose
    step is scaled by ``step``; and the first gradient repeated twice on
    fresh functions, bit-equal."""

    def __init__(self, device, step=1.):
        self.device, self.loops, self.stamps = device, {}, []
        self.repeat, self.step = None, step

    def __enter__(self):
        from devito_tpu_torch.operator.operator import Operator
        from devito_tpu_torch.models.seismic import AcousticWaveSolver
        from devito_tpu_torch.examples import seismic_fwi as F
        self._saved = (Operator.apply, AcousticWaveSolver.jacobian_adjoint,
                       F.update_with_box)
        apply, jadj, update = self._saved
        depth = [0]
        tap = self

        def timed_apply(op, **kw):
            depth[0] += 1
            try:
                summ = apply(op, **kw)
            finally:
                depth[0] -= 1
            if depth[0] == 0 and op._schedule.body:
                tm, tM = op._default_time_bounds()
                steps = kw.get('time_M', tM) - kw.get('time_m', tm) + 1
                kind = 'gradient' if op.name == 'Gradient' else \
                    'save-forward' if op._save_spans else 'forward'
                ms, n = tap.loops.get(kind, (0., 0))
                tap.loops[kind] = (ms + summ.globals['fdlike'].time * 1e3,
                                   n + steps)
            return summ

        def repeated(solver, rec, u, **kw):
            if tap.repeat is None:
                g = [jadj(solver, rec, u, vp=kw.get('vp'))[0] for _ in (0, 1)]
                a, b = (domain_tensor(x) for x in g)
                tap.repeat = dict(bit_equal=bool(torch.equal(a, b)),
                                  max_abs=float(a.abs().max()))
                del g, a, b
            return jadj(solver, rec, u, **kw)

        def stamped(vp, alpha, dm, *a, **k):
            update(vp, alpha * tap.step, dm, *a, **k)
            sync(tap.device)
            tap.stamps.append(time.perf_counter())
        Operator.apply = timed_apply
        AcousticWaveSolver.jacobian_adjoint = repeated
        F.update_with_box = stamped
        return self

    def __exit__(self, *exc):
        from devito_tpu_torch.operator.operator import Operator
        from devito_tpu_torch.models.seismic import AcousticWaveSolver
        from devito_tpu_torch.examples import seismic_fwi as F
        (Operator.apply, AcousticWaveSolver.jacobian_adjoint,
         F.update_with_box) = self._saved


def fwi_survey(device, sizes, count):
    """Phase 15 (3): seismic_fwi.run_fwi on ``p15_fwi``'s survey (601^2,
    4 shots, 151 receivers, 2 iterations at FULL) with its model update's
    step scaled by ``p15_fwi_step``: loop ms a step of the forward,
    save-forward and gradient (CUDA events), wall seconds an iteration,
    peak device memory, K1's launches; the objective must decrease and
    the first shot's gradient, repeated, must be bit-equal."""
    from devito_tpu_torch.examples import seismic_fwi as F
    args = sizes['p15_fwi']
    tap = fwi_taps(device, sizes['p15_fwi_step'])
    tic = time.perf_counter()
    with tap:
        (hist, model0), by, peak, held = with_peak(
            lambda: F.run_fwi(**args), count, device)
    wall = time.perf_counter() - tic
    hist = np.asarray(hist).ravel()
    starts = [tic] + tap.stamps[:-1]
    iters = [b - a for a, b in zip(starts, tap.stamps)]
    loops = {k: ms / n for k, (ms, n) in tap.loops.items()}
    steps = {k: n for k, (_, n) in tap.loops.items()}
    vp = np.array(model0.vp.data)
    out = dict(args={k: list(v) if isinstance(v, tuple) else v
                     for k, v in args.items()}, step=tap.step,
               objective=hist.tolist(), wall_s=wall, iteration_s=iters,
               ms_per_step=loops, steps=steps, launches=by, peak=peak,
               held=held, repeat=tap.repeat,
               save_bytes=None)
    nt = steps.get('save-forward', 0) // max(args['nshots'] *
                                             args['fwi_iterations'], 1)
    shape = model0.grid.shape
    out['save_bytes'] = int(nt * np.prod(shape) * 4)
    log(f"[p15-fwi] run_fwi {args}, step x{tap.step:g} of the example's: "
        f"{nt} steps a shot on {shape} "
        f"(save {out['save_bytes'] / 1e9:.2f} GB of domain); loop ms a "
        f"step " + ', '.join(f"{k} {v:.4f}" for k, v in loops.items())
        + f"; wall {wall:.2f} s, a iteration " + ', '.join(
            f"{s:.2f}" for s in iters)
        + f" s; peak device memory "
        + (f"{peak / 1e9:.2f} GB ({held / 1e9:.2f} held before the run)"
           if peak is not None else 'not measured')
        + f"; K1 {by}; objective " + ', '.join(f"{v:.6g}" for v in hist)
        + f"; first gradient repeated bit-equal {tap.repeat['bit_equal']}")
    if not (hist[-1] < hist[0] and np.all(np.diff(hist) < 0)):
        raise AssertionError(f"FWI survey: the objective {hist} does not "
                             f"decrease")
    if not (np.isfinite(vp).all() and tap.repeat['bit_equal'] and
            tap.repeat['max_abs'] > 0):
        raise AssertionError(f"FWI survey: model finite "
                             f"{np.isfinite(vp).all()}, repeated gradient "
                             f"{tap.repeat}")
    if len(iters) != args['fwi_iterations']:
        raise AssertionError(f"FWI survey: {len(iters)} iterations timed")
    return out


def born_override(sizes, so, data):
    """Born's record of a dm of space order ``so`` holding ``data``, on the
    acoustic solver at ``p15_born_n``^2 + nbl 20, SO=4, fp32; and Born's
    Operator."""
    from devito_tpu_torch import Function
    from devito_tpu_torch.models.seismic import acoustic_setup
    n = sizes['p15_born_n']
    s = acoustic_setup(shape=(n, n), spacing=(10., 10.),
                       tn=sizes['p15_born_tn'], nbl=20, space_order=4)
    dm = Function(name='dm', grid=s.model.grid, space_order=so)
    dm.data[:] = data
    return np.array(s.jacobian(dm)[0].data), s.op_born()


def written_override(sizes, so, u0):
    """``p15_diff_steps`` steps of 2-D diffusion on ``p15_diff_n``^2 by an
    Operator built for u of space order 2, writing u (``so`` 2) or an
    override of space order ``so``: its rows, and the Operator."""
    from devito_tpu_torch import Grid, TimeFunction, Eq, Operator, solve
    dn, steps = sizes['p15_diff_n'], sizes['p15_diff_steps']
    g = Grid(shape=(dn, dn), extent=(1., 1.))
    u = TimeFunction(name='u', grid=g, space_order=2)
    op = Operator(Eq(u.forward, solve(u.dt - 0.5 * u.laplace, u.forward)))
    w = u if so == 2 else TimeFunction(name='u', grid=g, space_order=so)
    w.data[0] = u0
    op.apply(time_M=steps - 1, dt=0.2 / (dn - 1) ** 2,
             **({} if w is u else {'u': w}))
    return np.array(w.data), op


def override_runs(device, sizes, count):
    """Phase 15 (4): overrides of another halo on the card. Born's record
    of a dm of space order 1 bound to Born's dm of space order 0
    (``born_override``), and a diffusion that writes a TimeFunction of
    space order 8 into an Operator built for space order 2
    (``written_override``): each against the same run on the CPU
    (RUN_TOL x max) and against the card's run with the Operator's own
    layout (bit-equal); the relaid plans' launches counted."""
    from devito_tpu_torch import switchconfig
    n, dn = sizes['p15_born_n'], sizes['p15_diff_n']
    rng = np.random.default_rng(SEED)
    out = {}
    for label, fn, relaid_so, own_so, data in (
            ('born dm', born_override, 1, 0,
             rng.standard_normal((n + 40,) * 2)),
            ('written u', written_override, 8, 2,
             rng.standard_normal((dn,) * 2))):
        (got, op), by = count(lambda: fn(sizes, relaid_so, data))
        relaid = sum(p.launches for p in {
            id(p): p for rel in op._layout_ops.values()
            for _, p in rel.kernel_plans if p is not None}.values())
        own, _ = fn(sizes, own_so, data)
        with switchconfig(device='cpu'):
            plain, _ = fn(sizes, relaid_so, data)
        err = float(np.abs(got - plain).max() / np.abs(plain).max())
        row = dict(launches=by, relaid_launches=relaid,
                   relayouts=op.relayouts, err=err,
                   bit_equal_own=bool(np.array_equal(got, own)))
        log(f"[p15-override] {label}: space order {relaid_so} into "
            f"{own_so}: {op.relayouts} relaid runner, K1 {by} of which "
            f"{relaid} on its plans; {err:.3e} x max from the CPU's run; "
            f"bit-equal to the Operator's own layout: {row['bit_equal_own']}")
        if not (err <= RUN_TOL[np.float32] and row['bit_equal_own'] and
                relaid == (device.type == 'cuda') * sum(by.values())):
            raise AssertionError(f"{label}: {row}")
        out[label] = row
    return out


def prebuild_examples(device, sizes):
    """Phase 15's K1 units, handed to nvcc before its runs: every example,
    the FWI survey and the overrides lowered on the CPU with
    Operator.apply stubbed out (nothing runs, results are dropped), each
    new unit submitted to a pool of 8 builds as soon as its Operator is
    built. The card's runs then wait only for the units they launch, in
    the order they were submitted. Returns (the units' keys, seconds of
    lowering,
    the pool's futures, the pool, the build stamps: the wall clock as
    each build ends)."""
    from concurrent.futures import ThreadPoolExecutor
    from devito_tpu_torch import switchconfig
    from devito_tpu_torch.examples import seismic_fwi as F
    from devito_tpu_torch.kernels import stencil as K
    from devito_tpu_torch.operator.operator import Operator
    from devito_tpu_torch.operator.profiling import PerformanceSummary
    keys, futs, stamps = set(), [], []
    pool = ThreadPoolExecutor(8)
    saved = Operator.__init__, Operator.apply

    def init(op, *a, **k):
        saved[0](op, *a, **k)
        for _, p in op.kernel_plans:
            if p is not None and p.key not in keys:
                keys.add(p.key)
                if device.type == 'cuda':
                    futs.append(pool.submit(K.build, p))
                    futs[-1].add_done_callback(
                        lambda f: stamps.append(time.perf_counter()))

    def nothing(op, **k):
        summ = PerformanceSummary(device='cpu')
        summ.add_glb(1e-9)
        return summ
    tic = time.perf_counter()
    Operator.__init__, Operator.apply = init, nothing
    try:
        with switchconfig(device='cpu'), np.errstate(all='ignore'):
            for mod, names in EXAMPLES:
                for name in names:
                    key = f'{mod}.{name}'
                    run_example(mod, name, sizes['p15_args'].get(key, {}),
                                sizes['p15_shards'])
            F.run_fwi(**sizes['p15_fwi'])
            n, dn = sizes['p15_born_n'], sizes['p15_diff_n']
            born_override(sizes, 0, np.zeros((n + 40,) * 2))
            written_override(sizes, 2, np.zeros((dn,) * 2))
    finally:
        Operator.__init__, Operator.apply = saved
    return keys, time.perf_counter() - tic, futs, pool, stamps


def multichip_checks(device, sizes, results, count):
    """Phase 15 (5): with ``p15_shards`` shards on the card, the sharded
    diffusion and both halo modes against the unsharded run, to the
    bit."""
    from devito_tpu_torch import switchconfig
    from devito_tpu_torch.examples import multichip as M
    from devito_tpu_torch.exceptions import InvalidArgument
    args = sizes['p15_args'].get('multichip.sharded_diffusion', {})
    (u1, _), by = count(lambda: M.sharded_diffusion(
        **dict(args, topology=None)))
    # halo_modes_demo's problem: 64^2, its steps
    (u20, _), _ = count(lambda: M.sharded_diffusion(
        shape=(64, 64), topology=None, steps=sizes['p15_args'].get(
            'multichip.halo_modes_demo', {}).get('steps', 20)))
    sharded = results['multichip.sharded_diffusion']['/0']
    modes = results['multichip.halo_modes_demo']
    out = dict(sharded_bit_equal=bool(np.array_equal(sharded,
                                                     np.array(u1.data))),
               auto_bit_equal=bool(np.array_equal(modes['/auto'],
                                                  np.array(u20.data))),
               explicit_bit_equal=bool(np.array_equal(modes['/explicit'],
                                                      np.array(u20.data))),
               topologies={k: v for k, v in
                           results['multichip.topologies_demo'].items()})
    out['refused'] = None
    try:
        with switchconfig(halo='gspmd'):
            pass
    except InvalidArgument as e:
        out['refused'] = type(e).__name__
    log(f"[p15-multichip] {sizes['p15_shards']} shards on {device}: sharded "
        f"diffusion bit-equal to the unsharded {out['sharded_bit_equal']}; "
        f"halo 'auto' {out['auto_bit_equal']}, 'explicit' "
        f"{out['explicit_bit_equal']}; 'gspmd' refused "
        f"({out['refused']})")
    if not (out['sharded_bit_equal'] and out['auto_bit_equal'] and
            out['explicit_bit_equal'] and out['refused']):
        raise AssertionError(f"multichip: {out}")
    return out


def examples_phase(device, sizes, record):
    """Phase 15: devito_tpu's examples through the port. Its K1 units are
    handed to nvcc first (``prebuild_examples``); then a child process
    runs every example on the CPU (the plain versions) while this one
    runs (1) every example on ``device``, each held against the CPU's
    result (EX_TOL x max) and the facts devito_tpu's tests assert, (2)
    with its K1 launches by design and its declines' reasons; then (3) the
    601^2 FWI survey, (4) the overrides of another halo and (5) the
    sharded examples against their unsharded runs. Every drive has K1's
    counts at 0 just before it and read just after, its launches added to
    K1's main path. Returns the phase's record (also
    ``record['phase15']``)."""
    import pickle
    import tempfile
    from devito_tpu_torch.kernels import stencil as K
    tic0 = time.perf_counter()
    res = record['phase15'] = {}
    release(device)

    def count(fn):
        K.launches = 0
        K.launches_by_design.update(point=0, stream=0)
        probe_launches(zero=True)
        out = fn()
        sync(device)
        by = dict(K.launches_by_design)
        if any(probe_launches().values()):
            raise AssertionError("phase 15 launched a probe kernel")
        record['launches'] += K.launches
        record['launches_main_path'] = record['launches']
        return out, by

    log(f"[p15] devito_tpu's examples on {device}: "
        + (smi() if device.type == 'cuda' else 'cpu'))
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / 'cpu.pkl')
        spec = json.dumps({'args': sizes['p15_args'],
                           'shards': sizes['p15_shards']})
        child = None
        try:
            before = set(K.build_seconds)
            keys, lower, futs, pool, stamps = prebuild_examples(device,
                                                                sizes)
            log(f"[p15-build] {len(keys)} K1 units of the phase lowered in "
                f"{lower:.2f} s on the CPU, handed to nvcc")
            # the plain versions, on the CPU beside the card's runs
            child = subprocess.Popen(
                [sys.executable, '-c', 'import sys, chip_smoke as C; '
                 'C.examples_on_cpu(sys.argv[1], sys.argv[2])', path, spec],
                cwd=str(Path(__file__).resolve().parent))
            results, res['examples'] = examples_on_card(device, sizes, count,
                                                        record)
            res['energy'] = energy_order(results)
            # the CPU's runs end before the timed survey starts: its loop
            # is host-paced, and shares no core with them
            tic = time.perf_counter()
            rc = child.wait(timeout=900)
            res['cpu_wait_s'] = time.perf_counter() - tic
            if rc != 0:
                raise AssertionError(f"the examples on the CPU exited {rc}")
            with open(path, 'rb') as f:
                plain = pickle.load(f)
            for f in futs:
                f.result()
            pool.shutdown()
            late = [k for k in K.build_seconds
                    if k not in before and k not in keys]
            res['build'] = dict(
                units=len(keys), lower_s=lower, late=len(late),
                wall_s=(max(stamps) - tic0) if stamps else 0.,
                nvcc_s=sum(K.build_seconds.get(k, 0.) for k in keys))
            log(f"[p15-build] the {len(futs)} builds (nvcc "
                f"{res['build']['nvcc_s']:.2f} s) ended "
                f"{res['build']['wall_s']:.2f} s into the phase; "
                f"{len(late)} units built outside them")
        finally:
            if child is not None and child.poll() is None:
                child.kill()
                child.wait()
    worst, bad = {}, []
    for key, got in results.items():
        try:
            worst[key] = held_example(key, got, plain[key])
        except AssertionError as e:
            bad.append(str(e))
            continue
        res['examples'][key]['tol_ratio'] = worst[key]
    if bad:
        raise AssertionError("examples on the card against the CPU: "
                             + ' | '.join(bad))
    res['worst'] = max(worst.items(), key=lambda kv: kv[1])
    log(f"[p15] every example on {device} against the CPU: worst "
        f"{res['worst'][1]:.3e} of its tolerance ({res['worst'][0]}); the "
        f"CPU's runs kept this process waiting {res['cpu_wait_s']:.1f} s")
    release(device)
    res['fwi'] = fwi_survey(device, sizes, count)
    release(device)
    res['override'] = override_runs(device, sizes, count)
    res['multichip'] = multichip_checks(device, sizes, results, count)
    res['seconds'] = time.perf_counter() - tic0
    log(f"[p15] phase 15 in {res['seconds']:.1f} s")
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: "
                         "torch.cuda.is_available() is False")
    import devito_tpu_torch  # noqa: F401  (fails outside the repository)
    card = smi()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tic = time.perf_counter()
    kind, records = smoke(torch.device('cuda', 0), FULL)
    log(f"[smoke] phases 2-15 in {time.perf_counter() - tic:.1f} s")
    print(json.dumps({'kernels': records}))
    print(smi())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
