"""k1_stress_ms_per_step: device milliseconds a step of the traced jobs'
K1 units whose target is a component of the stress ``tau`` (its six:
``tau_xx`` .. ``tau_zz``), by the target each K1 event names
(``units.py``)."""

from gpubench.units import ms_per_step


def read(ctx):
    return ms_per_step(ctx, lambda target: target.startswith('tau_'))
