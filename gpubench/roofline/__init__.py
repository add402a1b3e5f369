"""The benchmark's own roofline: the H100's published peaks
(``peaks.json``) and, per configuration, the bytes and operations a grid
point of a time step needs (``<config>.json``, each count derived there).
The bound of a step is the larger of its bytes over the memory bandwidth
and its operations over the float32 rate."""

import json
from pathlib import Path

__all__ = ['peaks', 'counts', 'bound_ms_per_step']

_HERE = Path(__file__).resolve().parent


def peaks():
    return json.loads((_HERE / 'peaks.json').read_text())


def counts(config_name):
    """The configuration's counts, or None when it has none."""
    path = _HERE / f'{config_name}.json'
    return json.loads(path.read_text()) if path.exists() else None


def bound_ms_per_step(config_name, points):
    """(bound ms of one step over ``points`` grid points, 'bytes' or
    'flops': which of the two binds), or None without counts."""
    c = counts(config_name)
    if c is None:
        return None
    p = peaks()
    by_bytes = c['bytes_per_point'] * points / p['hbm_bytes_per_s']
    by_flops = c['flops_per_point'] * points / p['fp32_flops_per_s']
    if by_bytes >= by_flops:
        return by_bytes * 1e3, 'bytes'
    return by_flops * 1e3, 'flops'
