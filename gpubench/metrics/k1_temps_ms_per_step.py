"""k1_temps_ms_per_step: device milliseconds a step of the traced jobs'
other K1 units, neither velocity nor stress: the temporaries (CIRE's
div(v), the hoisted means of mu and the receivers' dense div(v), each
named ``temporary``), by the target each K1 event names (``units.py``).
With k1_velocity_ms_per_step and k1_stress_ms_per_step it splits every
named K1 event of the window."""

from gpubench.units import ms_per_step


def read(ctx):
    return ms_per_step(ctx, lambda target: not target.startswith(
        ('v_', 'tau_')))
