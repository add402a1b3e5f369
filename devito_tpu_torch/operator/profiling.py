"""Performance summary.

Reference parity: devito/operator/profiling.py (PerformanceSummary:432,
PerfEntry:28 — time/gflopss/gpointss/oi per section and global). Flop
counts come from compile-time symbolic op counting (estimate_cost), i.e.
the same methodology the reference documents in FAQ.md:858-872. Times are
measured with CUDA events on a card and with the host clock on the CPU;
``device`` names which, and ``platform`` is the arch.py registry row the
apply's roofline shares were taken against.
"""

from collections import OrderedDict, namedtuple

PerfEntry = namedtuple('PerfEntry',
                       'time gflopss gpointss oi ops itershapes')


class PerformanceSummary(OrderedDict):

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = device
        self.platform = None
        self.globals = {}
        self.labels = {}   # section -> human label (target/sparse op)

    def add(self, name, time, flops=0, points=0, traffic=0, itershapes=None):
        gflopss = flops / time / 1e9 if time > 0 else 0.0
        gpointss = points / time / 1e9 if time > 0 else 0.0
        oi = flops / traffic if traffic > 0 else 0.0
        self[name] = PerfEntry(time, gflopss, gpointss, oi, flops,
                               itershapes or ())

    def add_glb(self, time, flops=0, points=0, traffic=0):
        gflopss = flops / time / 1e9 if time > 0 else 0.0
        gpointss = points / time / 1e9 if time > 0 else 0.0
        oi = flops / traffic if traffic > 0 else 0.0
        self.globals['fdlike'] = PerfEntry(time, gflopss, gpointss, oi,
                                           flops, ())

    @property
    def gflopss(self):
        return {k: v.gflopss for k, v in self.items()}

    @property
    def oi(self):
        return {k: v.oi for k, v in self.items()}

    @property
    def timings(self):
        return {k: v.time for k, v in self.items()}
