"""The ``shots`` job driver: a seismic survey's forward shots, one a job.

Each job is a shot from a new source position (``sources`` of the mix's
file, drawn from the seed by the general generator) into the receivers
of the configuration, on the program of the configuration's ``problem``
(``gpubench/solvers/<problem>.py``). Warm-up is a short shot, the first
``warmup_steps`` time steps from a position of its own stream.

The check holds the compared shots' records, and the last shot's final
wavefields, against the plain reference (``gpubench/reference/
<problem>.py``) run from the same inputs: ``{name: {'value', 'limit'}}``,
the relative errors max|program - reference| / max|reference|.

``FAULTS`` break the timed path underneath, for the check's own tests:
each takes the driver's ``Jobs`` before its warm-up.
"""

import importlib
import math
import time

import numpy as np

from gpubench import generator
from gpubench.harness import NoResult
from gpubench.reference.common import no_tf32, ricker, time_axis

__all__ = ['Jobs', 'FAULTS']


def _rel_err(torch, got, want, device):
    """max |got - want| / max |want|, in float64 on ``device``; None where
    either holds a value that is not finite, or ``want`` is all zero and
    ``got`` is not."""
    g = torch.as_tensor(np.asarray(got), device=device).double()
    w = torch.as_tensor(want, device=device).double()
    diff, scale = float((g - w).abs().max()), float(w.abs().max())
    if not (math.isfinite(diff) and math.isfinite(scale)):
        return None
    if scale == 0:
        return 0.0 if diff == 0 else None
    return diff / scale


class Jobs:
    """The shots of one run: the inputs and the program are made here."""

    def __init__(self, config, traffic, seed, control=False):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.fields = generator.model_fields(config, seed)
        self.dt = generator.time_step(config)
        self.nt, self.times = time_axis(config['t0'], config['tn'], self.dt)
        self.recpos = generator.receivers(config)
        self.positions = generator.sources(
            traffic['sources'], config, seed, traffic['positions'])
        problem = importlib.import_module(
            f"gpubench.solvers.{config['problem']}")
        self.prog = problem.Program(config, self.fields, self.dt,
                                    traffic['f0_khz'], self.recpos,
                                    control=control)
        self.records = {}
        self.final = None

    def build(self):
        """Lower the program's Operators; the time axes have to agree."""
        self.prog.build()
        if self.prog.nt != self.nt:
            raise NoResult(f"the program's time axis has {self.prog.nt} "
                           f"samples, the benchmark's {self.nt}")

    @property
    def plans(self):
        return self.prog.plans

    def warm_up(self):
        pos = generator.sources(self.traffic['sources'], self.config,
                                self.seed, 1, generator.WARMUP)[0]
        self.prog.shot(pos, steps=self.traffic['warmup_steps'])

    def run(self, i):
        """Shot ``i``: (its loop seconds from the program's summary, its
        time steps). Its record is kept for the check."""
        rec, loop_s, steps = self.prog.shot(
            self.positions[i % len(self.positions)])
        self.records[i] = rec
        return loop_s, steps

    def finish(self):
        """Keep the last shot's final wavefields; drop the program."""
        self.final = self.prog.final()
        self.prog.close()
        self.prog = None

    def check(self, torch, limits, done, device, log):
        cfg = self.config
        ref = importlib.import_module(f"gpubench.reference.{cfg['problem']}")
        no_tf32()
        rdtype = getattr(torch, cfg['dtype'])      # the configuration's own
        model = {k: torch.as_tensor(v, device=device)
                 for k, v in self.fields.items()}
        model.update(spacing=cfg['spacing'], nbl=cfg['nbl'],
                     space_order=cfg['space_order'])
        wavelet = ricker(self.times, self.traffic['f0_khz'])
        idx = generator.sample(self.seed, done, limits['shots_compared'])
        rec_err = wave_err = None
        missing = False
        tic = time.perf_counter()
        for j in idx:
            pos = self.positions[j % len(self.positions)]
            shot = {'src': pos, 'rec': self.recpos, 'wavelet': wavelet}
            rrec, rfin = ref.forward(model, shot, self.dt, self.nt,
                                     dtype=rdtype)
            got = self.records.get(j)
            e = None if got is None else _rel_err(torch, got, rrec, device)
            if e is None:
                missing = True
            else:
                rec_err = e if rec_err is None else max(rec_err, e)
            log(f"shot {j}: source {pos.tolist()}, reference record max "
                f"{float(rrec.abs().max())!r}, error {e!r}")
            if j == done - 1:
                errs = [_rel_err(torch, self.final[k], rfin[k], device)
                        for k in rfin]
                wave_err = None if None in errs else max(errs)
                log(f"shot {j}: final wavefields " + ", ".join(
                    f"{k} max {float(rfin[k].abs().max())!r} error {x!r}"
                    for k, x in zip(rfin, errs)))
            del rrec, rfin
        log(f"reference: shots {idx} of {done} in "
            f"{time.perf_counter() - tic:.2f} s ({cfg['dtype']})")
        if missing:
            rec_err = None      # a compared shot gave no record, or one
            #                     where the reference's is all zero
        return {name: {'value': value, 'limit': limits[name]['limit']}
                for name, value in (('rec_err', rec_err),
                                    ('wave_err', wave_err))}


def no_steps(jobs):
    """Every shot's time loop returns its state unchanged: no step runs."""
    prog = jobs.prog
    forward = prog._forward
    prog._forward = lambda **kw: forward(time_m=1, time_M=0)


def half_the_steps(jobs):
    """Half of each shot's time steps left out."""
    prog = jobs.prog
    forward = prog._forward
    prog._forward = lambda **kw: forward(time_m=1,
                                         time_M=(prog.nt - 2) // 2)


def one_sample_altered(jobs):
    """One sample of each record altered where the program writes it: the
    record's largest sample set to zero."""
    prog = jobs.prog
    forward = prog._forward

    def broken(**kw):
        out = forward(**kw)
        data = prog.rec.data
        data.flat[np.abs(data).argmax()] = 0.0
        return out
    prog._forward = broken


def src_elsewhere(jobs):
    """The source injected one grid point deeper than asked."""
    prog = jobs.prog
    shot = prog.shot

    def broken(position, **kw):
        moved = np.array(position, dtype=np.float64)
        moved[..., -1] += prog.model.spacing[-1]
        return shot(moved, **kw)
    prog.shot = broken


FAULTS = {f.__name__: f for f in (no_steps, half_the_steps,
                                  one_sample_altered, src_elsewhere)}
