"""The elastic survey program: ``ElasticWaveSolver.forward`` of the program
under test (velocity-stress on a staggered grid, ``bcs='mask'``), on
caller-held wavefields ``v`` (a ``VectorTimeFunction``) and ``tau`` (a
``TensorTimeFunction``), with two receiver sets: ``rec1`` on tau_zz and
``rec2`` on div(v).

The inputs get the preset's vs and b, derived from vp by the plain
reference's own ``parameters``. A shot's record is both receiver sets
stacked as the reference's ``records`` weighs them, rec1 first; ``rec`` is
rec1, the record the check's faults alter. ``final`` adds to the last
shot's nine components the nine of the probe shot, which it runs then,
from the reference's ``probe`` position below the water, so that the
check holds the shear terms, which the survey's shots in the water never
reach."""

import numpy as np
from torch.profiler import record_function

from gpubench.reference.elastic import parameters, probe, records

from .base import SurveyProgram

__all__ = ['Program']


class Program(SurveyProgram):

    def __init__(self, config, inputs, dt, f0, rec_positions, control=False):
        vs, b = parameters(np.array(inputs['vp']))
        super().__init__(config, dict(inputs, vs=vs, b=b), dt, f0,
                         rec_positions, control=control)
        self.rec = self.geometry.new_rec(name='rec1')
        self.rec2 = self.geometry.new_rec(name='rec2')
        self.v = self.tau = None
        self.probe = probe(inputs['vp'], config['spacing'])

    def _solver(self, config, kwargs):
        from devito_tpu_torch.models.seismic import ElasticWaveSolver
        return ElasticWaveSolver(self.model, self.geometry,
                                 space_order=config['space_order'], **kwargs)

    def _forward(self, **kwargs):
        """The solver's forward on the caller-held fields: its summary."""
        return self.solver.forward(src=self.src, rec1=self.rec,
                                   rec2=self.rec2, v=self.v, tau=self.tau,
                                   dt=self.dt, **kwargs)[-1]

    def build(self):
        """Lower the forward Operator (the solver memoizes it), make the
        caller-held v and tau and the one Operator that zeroes their nine
        components."""
        dtt = self._dtt
        from devito_tpu_torch.types.tensor import (TensorTimeFunction,
                                                   VectorTimeFunction)
        self.solver.op_fwd(None)
        kw = dict(grid=self.model.grid, space_order=self.solver.space_order,
                  time_order=self.rows - 1)
        self.v = VectorTimeFunction(name='v', **kw)
        self.tau = TensorTimeFunction(name='tau', **kw)
        unique = {c.name: c for c in self.tau.values()}
        self.waves = list(self.v.components) + list(unique.values())
        self._zero = dtt.Operator([dtt.Eq(w, 0.) for w in self.waves],
                                  name='zero_wavefields')

    def shot(self, position, steps=None):
        """One shot from ``position`` (1, ndim), as the base's, whose
        record is both receiver sets (``records``): (2, nt, nrec). A whole
        shot runs the time steps 0 .. nt-2 (first order in time: the step
        at t reads level t alone), nt - 1 of them."""
        with record_function('gpubench::zero'):
            self.zero()
        self.src.coordinates = np.asarray(position, dtype=np.float64)
        kw = {} if steps is None else {'time_m': 1, 'time_M': steps}
        with record_function('gpubench::forward'):
            summary = self._forward(**kw)
        with record_function('gpubench::record_to_host'):
            record = records(np.array(self.rec.data),
                             np.array(self.rec2.data))
        return (record, summary.globals['fdlike'].time,
                self.nt - 1 if steps is None else steps)

    def final(self):
        """The last shot's nine final components, then the probe shot run
        and its nine final components (``'probe.<name>'``)."""
        out = super().final()
        self.shot(self.probe)
        out.update((f'probe.{k}', a) for k, a in super().final().items())
        return out

    def close(self):
        super().close()
        self.rec2 = self.v = self.tau = None
