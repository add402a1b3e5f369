"""shot_s.p90: the 90th percentile (linear between order statistics) of
the wall seconds of every job (a shot) of the window, from the call until
its receiver record is in host memory."""

import numpy as np


def read(ctx):
    walls = [j['wall'] for j in ctx.jobs]
    return float(np.percentile(walls, 90)) if walls else None
