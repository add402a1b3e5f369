"""GPU platform registry: the data-sheet peaks of each card the port runs on.

Ports devito_tpu/arch.py (``platform_registry``, ``get_platform``,
``roofline_gpts``, ``roofline_fraction``, ``CPU_GENERIC``; reference
analog: devito/arch/archinfo.py:765-1239). The rows are NVIDIA's H100
data sheet; they feed apply's "% of <platform> HBM roofline" log line,
``PerformanceSummary.platform`` and the kernel bounds of
``experiments.bound_ms``.
"""

from collections import namedtuple

__all__ = ['GpuPlatform', 'platform_registry', 'get_platform',
           'roofline_gpts', 'roofline_fraction', 'CPU_GENERIC']

GpuPlatform = namedtuple(
    'GpuPlatform',
    [
        'name',          # canonical name, e.g. 'nvidia-h100-sxm'
        'hbm_bw',        # device memory bandwidth, bytes/s
        'fp32_flops',    # fp32 FLOP/s outside the tensor cores
        'tensor_flops',  # dense bf16 tensor-core FLOP/s
        'smem_bytes',    # shared memory per SM
        'hbm_bytes',     # device memory capacity
        'link_bw',       # NVLink bytes/s, one direction, all links
        'host_bw',       # host link (PCIe Gen5 x16) bytes/s, one direction
    ])

# NVIDIA H100 Tensor Core GPU data sheet: SXM5 at 700 W, PCIe at 350 W.
# Tensor-core figures are the dense ones (the sheet's "with sparsity" are
# twice these); NVLink and PCIe are the sheet's bidirectional totals
# halved.
platform_registry = {
    'nvidia-h100-sxm': GpuPlatform('nvidia-h100-sxm', 3.35e12, 67e12,
                                   989.5e12, 228 * 1024, 80 * 2**30,
                                   450e9, 64e9),
    'nvidia-h100-pcie': GpuPlatform('nvidia-h100-pcie', 2.0e12, 51e12,
                                    756e12, 228 * 1024, 80 * 2**30,
                                    300e9, 64e9),
}

# CPU / unknown device: devito_tpu's stated 100 GB/s host figure, so that
# the roofline share still prints off the card.
CPU_GENERIC = GpuPlatform('cpu-generic', 100e9, 1e12, 2e12, 32 * 2**20,
                          64 * 2**30, 10e9, 100e9)


def _classify(kind):
    """The registry row of a device name (``torch.cuda.get_device_name``),
    or CPU_GENERIC for any other name."""
    k = (kind or '').lower()
    if 'h100' not in k or 'nvl' in k:
        return CPU_GENERIC
    return platform_registry['nvidia-h100-pcie' if 'pcie' in k
                             else 'nvidia-h100-sxm']


def get_platform(device=None):
    """The platform of ``device`` (a torch.device, a device string, or a
    device name); by default of the device ``configuration['device']``
    names (reference: get_platform, devito/arch/archinfo.py:722)."""
    import torch
    if device is None:
        from .parameters import configuration
        device = configuration['device']
    if isinstance(device, str) and device.split(':')[0] in ('cuda', 'cpu'):
        device = torch.device(device)
    if isinstance(device, torch.device):
        if device.type != 'cuda' or not torch.cuda.is_available():
            return CPU_GENERIC
        device = torch.cuda.get_device_name(device)
    return _classify(device)


def roofline_gpts(platform, bytes_per_point):
    """Device-memory roofline in GPts/s of a memory-bound stencil moving
    ``bytes_per_point`` per grid point per step."""
    if isinstance(platform, str):
        platform = _classify(platform)
    return platform.hbm_bw / bytes_per_point / 1e9


def roofline_fraction(platform, traffic_bytes, seconds):
    """Achieved share of the device-memory roofline of a section that
    moved ``traffic_bytes`` (cost-model estimate) in ``seconds``."""
    if seconds <= 0 or traffic_bytes <= 0:
        return None
    if isinstance(platform, str):
        platform = _classify(platform)
    return (traffic_bytes / seconds) / platform.hbm_bw
