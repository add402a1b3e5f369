"""k1_velocity_ms_per_step: device milliseconds a step of the traced jobs'
K1 units whose target is a component of the velocity ``v`` (``v_x``,
``v_y``, ``v_z``), by the target each K1 event names (``units.py``)."""

from gpubench.units import ms_per_step


def read(ctx):
    return ms_per_step(ctx, lambda target: target.startswith('v_'))
