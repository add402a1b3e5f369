"""K1's units in a traced window, by the equation each ran.

The program names each generated unit's point struct after the target of
its equation (``devito_tpu_torch/kernels/stencil.py``: ``Point_<target>``,
``Point_temporary`` for the temporaries of CIRE, of the hoisting pass and
of an interpolation), and the struct is the last argument of the kernel
template, so a K1 device event's name carries it, e.g.
``dtpu::stencil_kernel<float, float, 3, 5, 2, (anonymous
namespace)::Point_v_x>(...)``. A program that does not name its units
(every struct ``Point``) gives no unit here, and the readers that split
K1 by unit give no number.
"""

import re

__all__ = ['unit', 'seconds_by_unit', 'ms_per_step']

_POINT = re.compile(r'::Point_(\w+)')


def unit(name):
    """The target a K1 event's ``name`` ran, or None when the name carries
    none."""
    m = _POINT.search(name)
    return m.group(1) if m else None


def seconds_by_unit(tr):
    """{target: device seconds} of the traced window's K1 events (the
    stencil category) whose name carries their target."""
    out = {}
    for name, cat, a, b in tr.device:
        label = unit(name) if cat == 'stencil' else None
        if label is not None:
            out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def ms_per_step(ctx, pick):
    """Device milliseconds a traced step of the K1 units whose target
    ``pick(target)`` accepts; None without a trace, a traced step or a
    named unit."""
    tr = ctx.trace
    if tr is None or not ctx.traced_steps:
        return None
    units = seconds_by_unit(tr)
    if not units:
        return None
    secs = sum(s for label, s in units.items() if pick(label))
    return 1e3 * secs / ctx.traced_steps
