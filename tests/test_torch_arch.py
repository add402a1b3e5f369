"""The GPU platform registry of devito_tpu_torch (arch.py), as
tests/test_arch.py holds devito_tpu's: device-name classification, the
roofline math on the H100 row, apply's roofline log line and
``summary.platform``, and the kernel bounds reading the H100 SXM row."""

import logging

import pytest
import torch

import devito_tpu_torch as dt
from devito_tpu_torch.arch import (platform_registry, get_platform,
                                   _classify, roofline_gpts,
                                   roofline_fraction, CPU_GENERIC)
from devito_tpu_torch.logger import logger

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)


def test_registry_entries_sane():
    for name, p in platform_registry.items():
        assert p.name == name and name.startswith('nvidia-h100')
        assert p.hbm_bw >= 2e12 and p.hbm_bytes == 80 * 2**30
        assert p.tensor_flops > p.fp32_flops > 40e12
        assert p.smem_bytes == 228 * 1024
        assert p.link_bw > p.host_bw > 0
    sxm = platform_registry['nvidia-h100-sxm']
    assert (sxm.hbm_bw, sxm.fp32_flops) == (3.35e12, 67e12)


@pytest.mark.parametrize('kind,expect', [
    ('NVIDIA H100 80GB HBM3', 'nvidia-h100-sxm'),
    ('NVIDIA H100 SXM5 80GB', 'nvidia-h100-sxm'),
    ('NVIDIA H100 PCIe', 'nvidia-h100-pcie'),
    ('NVIDIA H100 NVL', 'cpu-generic'),
    ('NVIDIA A100-SXM4-80GB', 'cpu-generic'),
    ('cpu', 'cpu-generic'),
    ('', 'cpu-generic'),
    (None, 'cpu-generic'),
])
def test_classify(kind, expect):
    assert _classify(kind).name == expect


def test_get_platform_by_name_and_device(monkeypatch):
    assert get_platform('NVIDIA H100 PCIe').name == 'nvidia-h100-pcie'
    assert get_platform(torch.device('cpu')) is CPU_GENERIC
    assert get_platform('cpu') is CPU_GENERIC
    assert get_platform() is CPU_GENERIC      # configuration['device']
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda d=None: 'NVIDIA H100 80GB HBM3')
    assert get_platform(torch.device('cuda', 0)).name == 'nvidia-h100-sxm'
    assert get_platform('cuda:0').name == 'nvidia-h100-sxm'


def test_roofline_math():
    # 5 fp32 streams a point on the H100 SXM: 3.35e12 / 20 bytes
    assert abs(roofline_gpts('NVIDIA H100 80GB HBM3', 20) - 3350 / 20) \
        < 1e-9
    p = platform_registry['nvidia-h100-sxm']
    # moved half the bandwidth-seconds -> 50%
    assert abs(roofline_fraction(p, p.hbm_bw / 2, 1.0) - 0.5) < 1e-12
    assert roofline_fraction(p, 0, 1.0) is None
    assert roofline_fraction(p, 100, 0.0) is None
    assert roofline_gpts('NVIDIA H100 PCIe', 10) == pytest.approx(
        2 * roofline_gpts('NVIDIA H100 PCIe', 20), rel=1e-12)
    assert roofline_gpts('unknown accelerator', 20) == pytest.approx(5.0)


def test_apply_log_reports_roofline(caplog):
    grid = dt.Grid(shape=(16, 16))
    u = dt.TimeFunction(name='u', grid=grid, space_order=2)
    op = dt.Operator(dt.Eq(u.forward, u + 0.1 * u.laplace),
                     subs=grid.spacing_map)
    with caplog.at_level(logging.DEBUG, logger=logger.name):
        summary = op.apply(time_M=3, dt=0.01)
    msgs = [r.getMessage() for r in caplog.records]
    assert any('% of cpu-generic HBM roofline' in m for m in msgs)
    assert any('section0 (u)' in m and 'roofline' in m for m in msgs)
    assert summary.platform.name in ([p.name for p in
                                      platform_registry.values()]
                                     + [CPU_GENERIC.name])


def test_bounds_read_the_sxm_row():
    from devito_tpu_torch.experiments import (HBM_BYTES_S, FP32_FLOP_S,
                                              bound_ms)
    sxm = platform_registry['nvidia-h100-sxm']
    assert (HBM_BYTES_S, FP32_FLOP_S) == (sxm.hbm_bw, sxm.fp32_flops)
    # K1's headline bound: 0.809 ms (PERF.md §6), unchanged
    n = 512
    nbytes = 4 * (n ** 3 + 6 * 4 * n ** 2 + 4 * n ** 3)
    ms, by = bound_ms(nbytes, 76 * n ** 3)
    assert by == 'bytes' and ms == pytest.approx(0.8088, abs=1e-4)
