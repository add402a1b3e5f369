"""What every survey program shares: the model, the acquisition and the
shot call, through the public API of the program under test.

A problem's module (``acoustic.py``, ``tti.py``) names its solver and its
wavefields; this class builds the model from the benchmark's own input
fields, with the benchmark's time step, the receivers and one source
whose position each shot sets. The caller holds the wavefields, the
source and the receivers: a shot zeroes the wavefields on the device,
moves the source, calls the solver's ``forward`` and copies the receiver
record to the host.
"""

import numpy as np
from torch.profiler import record_function

__all__ = ['SurveyProgram', 'CONTROL_OPT']

#: the program's own narrow path: wavefields stored in bfloat16, the
#: precision below the configuration's float32 (the check's control)
CONTROL_OPT = ('advanced', {'storage-dtype': 'bfloat16'})


class SurveyProgram:
    """One configuration's forward shots on the program under test.

    ``config``: the configuration file's contents; ``inputs``: the
    physical parameter fields (numpy, the configuration's physical shape);
    ``dt``: the time step; ``f0``: the Ricker wavelet's peak frequency
    (kHz); ``rec_positions``: (nrec, ndim) metres; ``control``: run the
    program's narrow path (``CONTROL_OPT``) in place of its default."""

    #: names of the wavefields a shot produces, in the solver's order
    fields = ()

    def __init__(self, config, inputs, dt, f0, rec_positions, control=False):
        import devito_tpu_torch as dtt
        from devito_tpu_torch.models.seismic import (SeismicModel,
                                                     AcquisitionGeometry)
        self._dtt = dtt
        self.dt = float(dt)
        dtype = np.dtype(config['dtype']).type
        params = {k: v for k, v in inputs.items() if k != 'vp'}
        self.model = SeismicModel(
            origin=tuple(config['origin']), spacing=tuple(config['spacing']),
            shape=tuple(config['shape']), space_order=config['space_order'],
            vp=inputs['vp'], nbl=config['nbl'], dtype=dtype, bcs='damp',
            dt=dtype(dt), **params)
        first = np.zeros((1, len(config['shape'])))
        self.geometry = AcquisitionGeometry(
            self.model, rec_positions, first, config['t0'], config['tn'],
            f0=f0, src_type='Ricker')
        self.nt = self.geometry.nt
        kwargs = {'opt': CONTROL_OPT} if control else {}
        self.solver = self._solver(config, kwargs)
        self.src = self.geometry.new_src()
        self.rec = self.geometry.new_rec()
        # a wavefield buffers time_order + 1 levels, step t in row t mod rows
        self.rows = config['time_order'] + 1
        self.waves = None
        self._zero = None

    def _solver(self, config, kwargs):
        raise NotImplementedError

    def _forward(self, **kwargs):
        """The solver's forward on the caller-held fields: its summary."""
        kw = dict(zip(self.fields, self.waves))
        kw.update(kwargs)
        return self.solver.forward(src=self.src, rec=self.rec, dt=self.dt,
                                   **kw)[-1]

    def build(self):
        """Lower the forward Operator (the solver memoizes it), make the
        caller-held wavefields and the Operator that zeroes them."""
        dtt = self._dtt
        self.solver.op_fwd(None)
        self.waves = [dtt.TimeFunction(name=n, grid=self.model.grid,
                                       time_order=self.rows - 1,
                                       space_order=self.solver.space_order)
                      for n in self.fields]
        self._zero = dtt.Operator([dtt.Eq(w, 0.) for w in self.waves],
                                  name='zero_wavefields')

    @property
    def plans(self):
        """The K1 plans of the dense equations of every Operator a shot
        runs (the zeroing one and the forward)."""
        ops = (self._zero, self.solver.op_fwd(None))
        return [p for op in ops for _, p in op.kernel_plans if p is not None]

    def zero(self):
        """Zero every time level of the caller-held wavefields, on the
        device."""
        self._zero.apply(time_m=0, time_M=self.rows - 1)

    def shot(self, position, steps=None):
        """One shot from ``position`` (1, ndim): the wavefields zeroed, the
        source moved, the forward run (its first ``steps`` time steps
        only, where given). Returns (the receiver record, a host copy,
        (nt, nrec); the loop's seconds from the returned summary; the time
        steps run)."""
        with record_function('gpubench::zero'):
            self.zero()
        self.src.coordinates = np.asarray(position, dtype=np.float64)
        kw = {} if steps is None else {'time_m': 1, 'time_M': steps}
        with record_function('gpubench::forward'):
            summary = self._forward(**kw)
        with record_function('gpubench::record_to_host'):
            record = np.array(self.rec.data)
        return (record, summary.globals['fdlike'].time,
                self.nt - 2 if steps is None else steps)

    def final(self):
        """A host copy of each wavefield's last level, nt - 1, over the
        padded grid."""
        row = (self.nt - 1) % self.rows
        return {w.name: np.array(w.data[row]) for w in self.waves}

    def close(self):
        """Drop every object of the program this instance holds."""
        self.solver = self.model = self.geometry = None
        self.src = self.rec = self.waves = self._zero = None
