"""Global configuration.

Reference parity: devito/parameters.py (``configuration`` dict with
accepted-value validation, env-var init from ``DEVITO_*``, ``switchconfig``
context manager). The PyTorch build reads ``DEVITO_TPU_TORCH_*`` env vars.

``device`` names where every Function's tensor lives and where operators
run: ``'cuda'`` (the default) or ``'cpu'``. Asking for ``'cuda'`` on a
machine without CUDA raises at the first allocation; nothing moves to the
CPU behind the user's back.
"""

import os

from .exceptions import InvalidArgument
from .logger import set_log_level

__all__ = ['configuration', 'switchconfig']


class Parameters(dict):
    """A dictionary with accepted-value validation and update callbacks."""

    def __init__(self):
        super().__init__()
        self._accepted = {}
        self._callbacks = {}
        self._defaults = {}
        self._refused = {}

    def add(self, key, default, accepted=None, callback=None, refused=None):
        self._accepted[key] = accepted
        self._defaults[key] = default
        if callback is not None:
            self._callbacks[key] = callback
        if refused:
            self._refused[key] = refused
        self[key] = default

    def __setitem__(self, key, value):
        why = self._refused.get(key, {}).get(value)
        if why is not None:
            raise InvalidArgument(f"{key}={value!r} is not supported: {why}")
        accepted = self._accepted.get(key)
        if accepted is not None and value not in accepted:
            raise InvalidArgument(
                f"Illegal configuration value {value!r} for key {key!r}; "
                f"accepted: {accepted}")
        super().__setitem__(key, value)
        cb = self._callbacks.get(key)
        if cb is not None:
            cb(value)


configuration = Parameters()

configuration.add('log-level', 'INFO',
                  accepted=['DEBUG', 'PERF', 'INFO', 'WARNING', 'ERROR'],
                  callback=set_log_level)
# Lowering mode: 'advanced' runs the CIRE and invariant-hoisting passes
# (ir/cire.py, ir/optimize.py), 'noop' neither.
configuration.add('opt', 'advanced', accepted=['noop', 'advanced'])
# CIRE (derivative temporaries) under 'advanced'; False turns it off.
configuration.add('cire', True, accepted=[True, False])
# Where Function tensors live and operators run.
configuration.add('device', 'cuda', accepted=['cuda', 'cpu'])
configuration.add('develop-mode', False, accepted=[True, False])
configuration.add('ignore-unknowns', False, accepted=[True, False])
# Default floating dtype name used when a Grid does not specify one.
configuration.add('dtype', 'float32', accepted=['float32', 'float64'])
# Separable interpolation (operations/separable.py): a linear or sinc
# interpolation of 1024 points or more whose coordinates form a tensor
# product contracts per axis instead of gathering; False always gathers.
configuration.add('separable', True, accepted=[True, False])
# Operator.apply's autotune default. Accepted as devito_tpu's values; this
# package has no tuner and runs untuned (logged once an operator).
configuration.add('autotuning', 'off', accepted=['off', 'basic', 'aggressive'])
# Host streaming of save=nt wavefields (Operator._apply_streamed): 'auto'
# streams when the save buffers exceed `save-budget` bytes of device
# memory, 'on' always streams, 'off' keeps them whole on the device.
# devito_tpu's values and default budget, so that both plan alike.
configuration.add('save-streaming', 'auto', accepted=['auto', 'on', 'off'])
configuration.add('save-budget', 4 << 30)
# 'measured' runs apply's loop under torch.profiler and gives each section
# its device time (operator/trace_profile.py); 'basic' and 'advanced'
# share the loop's time out by each section's flops and bytes.
configuration.add('profiling', 'basic',
                  accepted=['basic', 'advanced', 'measured'])
# A directory: apply's loop runs under torch.profiler and its Chrome trace
# is written there (it opens in Perfetto).
configuration.add('profile-dir', None)
# Multi-device runs (parallel/halo.py): 'auto' runs a schedule on the
# explicit halo path when explicit_halo_eligible allows it and gathered
# (the shards' interiors joined on the mesh's first device, the unsharded
# runner there, the result scattered back) otherwise; 'explicit' raises
# InvalidArgument for an ineligible schedule. devito_tpu's third value,
# 'gspmd', names XLA's SPMD partitioner, which has no counterpart here.
configuration.add('halo', 'auto', accepted=['auto', 'explicit'], refused={
    'gspmd': "XLA's SPMD partitioner has no counterpart in devito_tpu_torch "
             "(ROADMAP.md, 'Do not port': the GSPMD fallback runner); "
             "halo='auto' runs an ineligible schedule gathered instead"})
# The shards of a distributed Grid's mesh (parallel/distributor.py): None
# puts one on each visible device of `device`; an integer N makes N,
# placed in turn on those devices (on the CPU all on 'cpu'), as XLA's
# virtual device count makes N devices of one host.
configuration.add('mesh-devices', None)

_ENV_MAP = {
    'DEVITO_TPU_TORCH_LOG_LEVEL': 'log-level',
    'DEVITO_TPU_TORCH_OPT': 'opt',
    'DEVITO_TPU_TORCH_CIRE': 'cire',
    'DEVITO_TPU_TORCH_DEVICE': 'device',
    'DEVITO_TPU_TORCH_DEVELOP': 'develop-mode',
    'DEVITO_TPU_TORCH_DTYPE': 'dtype',
    'DEVITO_TPU_TORCH_SEPARABLE': 'separable',
    'DEVITO_TPU_TORCH_AUTOTUNING': 'autotuning',
    'DEVITO_TPU_TORCH_SAVE_STREAMING': 'save-streaming',
    'DEVITO_TPU_TORCH_SAVE_BUDGET': 'save-budget',
    'DEVITO_TPU_TORCH_PROFILING': 'profiling',
    'DEVITO_TPU_TORCH_PROFILE_DIR': 'profile-dir',
    'DEVITO_TPU_TORCH_HALO': 'halo',
    'DEVITO_TPU_TORCH_MESH_DEVICES': 'mesh-devices',
}

#: Keys whose environment value is a count of bytes.
_INT_KEYS = ('save-budget', 'mesh-devices')


def init_configuration():
    for env, key in _ENV_MAP.items():
        if env in os.environ:
            val = os.environ[env]
            if val in ('0', 'False', 'false'):
                val = False
            elif val in ('1', 'True', 'true'):
                val = True
            if key in _INT_KEYS:
                val = int(os.environ[env])
            configuration[key] = val


init_configuration()


def torch_device():
    """The ``torch.device`` named by ``configuration['device']``; raises
    when CUDA is asked for and absent."""
    import torch
    from .exceptions import DevitoTpuError
    name = configuration['device']
    if name == 'cuda' and not torch.cuda.is_available():
        raise DevitoTpuError(
            "configuration['device'] is 'cuda' but torch.cuda.is_available() "
            "is False; set configuration['device'] = 'cpu' to run on the CPU")
    return torch.device(name)


class switchconfig:
    """Context manager/decorator to temporarily override configuration.

    Keys may be given with '_' in place of '-' (reference behavior).
    """

    def __init__(self, **params):
        self.params = {k.replace('_', '-'): v for k, v in params.items()}

    def __enter__(self):
        self.previous = {k: configuration[k] for k in self.params}
        for k, v in self.params.items():
            configuration[k] = v
        return self

    def __exit__(self, *args):
        for k, v in self.previous.items():
            configuration[k] = v

    def __call__(self, func):
        from functools import wraps

        @wraps(func)
        def wrapper(*args, **kwargs):
            with self:
                return func(*args, **kwargs)
        return wrapper
