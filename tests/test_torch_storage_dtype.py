"""Narrow wavefield storage (opt 'storage-dtype') through devito_tpu_torch.

The cases of tests/test_storage_dtype.py and of tests/test_fp16.py's
storage rows that need no sharding, in the port: the device tensor of the
written TimeFunctions (every dense function under scope 'all') is stored
as bfloat16 or float16 while the arithmetic stays in the compute dtype;
the mode is the operator's and reversible; the errors against the fp32
run, and the inverse problem's dot test and gradients, hold the bounds
devito_tpu's tests hold. Against devito_tpu under the same option, from
the same seeded state: within one narrow ulp of max |devito_tpu| (they
are bit-equal here). K1's plain version on narrow rows equals a hand
computation: widen, fp32 arithmetic, round to nearest even (numpy bit
arithmetic for bfloat16, numpy's float16 cast).
"""

import numpy as np
import pytest
import torch

import jax
jax.config.update("jax_enable_x64", True)

import devito_tpu as dj  # noqa: E402
import devito_tpu_torch as dt  # noqa: E402
from devito_tpu_torch.kernels import stencil as K  # noqa: E402

dt.configuration['device'] = 'cpu'
torch.set_num_threads(1)

BF16 = ('advanced', {'storage-dtype': 'bfloat16'})
#: mantissa bits of each narrow dtype: one ulp at v is 2^(floor(log2 v) - m)
MANT = {'bfloat16': 7, 'float16': 10}


@pytest.fixture(autouse=True)
def clear_port_cache():
    yield
    dt.clear_cache()


def ulp(v, sdt):
    return 2.0 ** (np.floor(np.log2(v)) - MANT[sdt])


def diffusion(pkg, opt, nt=100, shape=(64, 64), coeff=False):
    """The last row of a 2-D diffusion's ``nt`` steps under ``opt``, the
    function and the operator; each of the last two has run, and
    ``storage`` (below) reads the device tensors' dtypes as they stood
    after the run."""
    grid = pkg.Grid(shape=shape, extent=(1., 1.))
    u = pkg.TimeFunction(name='u', grid=grid, space_order=2)
    xx, yy = np.meshgrid(np.linspace(0, 1, shape[0]),
                         np.linspace(0, 1, shape[1]), indexing='ij')
    u0 = np.exp(-((xx - .5) ** 2 + (yy - .5) ** 2) / 0.01)
    u.data[0] = u0
    u.data[1] = u0
    c = 0.1
    if coeff:
        c = pkg.Function(name='c', grid=grid)
        c.data[:] = 0.1 + 0.05 * np.random.default_rng(1).random(shape)
    eq = pkg.Eq(u.forward, pkg.solve(pkg.Eq(u.dt, c * u.laplace),
                                     u.forward))
    op = pkg.Operator([eq], opt=opt)
    op.apply(time_M=nt, dt=1e-5)
    if pkg is dt:
        # before .data hands the host buffer out, which drops the tensor
        op.storage_after = {n: type(f)._dev_buf.dtype
                            for n, f in op._reads.items()}
    return np.asarray(u.data[(nt + 1) % 2], dtype=np.float64), u, op


class TestStorageDtype:

    def test_error_bounded_vs_fp32(self):
        a, _, _ = diffusion(dt, 'advanced')
        b, _, _ = diffusion(dt, BF16)
        rel = np.abs(a - b).max() / np.abs(a).max()
        # eps_bf16 ~ 2^-8; a random walk over 100 steps ~ 4e-2
        assert 0 < rel < 0.08

    def test_device_buffer_is_narrow_compute_is_wide(self):
        _, u, op = diffusion(dt, BF16, nt=2, shape=(32, 32))
        assert op.storage_after['u'] == torch.bfloat16
        assert np.asarray(u.data).dtype == np.float32
        assert u.storage_dtype == torch.bfloat16
        # K1 reads and writes bf16 rows and computes in fp32
        (eq, plan), = op.kernel_plans
        assert set(plan.storage) == {torch.bfloat16} and plan.narrow
        assert 'using T = float;' in plan.source
        assert 'using SO = __nv_bfloat16;' in plan.source
        assert 'dtpu::at<__nv_bfloat16>(a, o, 0)' in plan.source

    def test_scope_all_narrows_coefficients(self):
        opt = ('advanced', {'storage-dtype': 'bfloat16',
                            'storage-dtype-scope': 'all'})
        _, u, op = diffusion(dt, opt, nt=3, shape=(32, 32), coeff=True)
        assert op.storage_after == {'u': torch.bfloat16, 'c': torch.bfloat16}
        assert np.asarray(op._reads['c'].data).dtype == np.float32
        # 'fields' leaves the coefficient in fp32
        _, _, op2 = diffusion(dt, BF16, nt=3, shape=(32, 32), coeff=True)
        assert op2.storage_after['c'] == torch.float32
        plan = op2.kernel_plans[0][1]
        assert {g['fn'].name: st for g, st in zip(
            plan.groups, plan.storage[1:])} == {'u': torch.bfloat16,
                                                'c': torch.float32}

    def test_mode_is_per_operator_and_reversible(self):
        # running the same function through a plain operator afterwards
        # restores fp32 storage, keeping the (rounded) values
        _, u, op = diffusion(dt, BF16, nt=4)
        assert op.storage_after['u'] == torch.bfloat16
        val = np.asarray(u.data[0]).copy()
        dt.Operator([dt.Eq(u.forward, u)]).apply(time_m=0, time_M=0)
        assert type(u)._dev_buf.dtype == torch.float32
        assert u.storage_dtype == np.float32
        assert np.array_equal(np.asarray(u.data[0]), val)

    def test_source_injection_and_receivers(self):
        """The acoustic forward with bf16 wavefields, source injection and
        receiver interpolation: within 5 % of the fp32 record (devito_tpu's
        bound), and within 1 % of devito_tpu's bf16 record."""
        def run(pkg, opt):
            seis = pkg.models.seismic if pkg is dt else \
                __import__('devito_tpu.models.seismic', fromlist=['x'])
            model = seis.demo_model('layers-isotropic', shape=(61, 61),
                                    spacing=(10., 10.), nbl=10,
                                    space_order=4)
            geometry = seis.AcquisitionGeometry(
                model, np.stack([np.linspace(0, 600, 31),
                                 np.full(31, 20.)], 1),
                np.array([[300., 20.]]), 0., 400., f0=0.010,
                src_type='Ricker')
            solver = seis.AcousticWaveSolver(model, geometry, space_order=4,
                                             opt=opt)
            return np.asarray(solver.forward()[0].data, dtype=np.float64)

        import devito_tpu_torch.models.seismic  # noqa: F401
        r32, r16 = run(dt, 'advanced'), run(dt, BF16)
        den = np.linalg.norm(r32)
        assert den > 1 and np.linalg.norm(r32 - r16) / den < 0.05
        rj = run(dj, BF16)
        assert np.linalg.norm(r16 - rj) / np.linalg.norm(rj) < 0.01

    @pytest.mark.parametrize('sdt,scope', [('bfloat16', 'fields'),
                                           ('bfloat16', 'all'),
                                           ('float16', 'fields'),
                                           ('float16', 'all')])
    def test_port_matches_devito_tpu(self, sdt, scope):
        opt = ('advanced', {'storage-dtype': sdt,
                            'storage-dtype-scope': scope})
        a, _, _ = diffusion(dt, opt, nt=6, coeff=True)
        b, _, _ = diffusion(dj, opt, nt=6, coeff=True)
        assert np.abs(a - b).max() <= ulp(np.abs(b).max(), sdt)


class TestNarrowPlainVersion:
    """K1's plain version on narrow rows against a hand computation."""

    @staticmethod
    def bf16_round(x32):
        """fp32 -> bfloat16 (as fp32 values), round to nearest even, by
        bit arithmetic."""
        b = x32.astype(np.float32).view(np.uint32).astype(np.uint64)
        b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
        return b.astype(np.uint32).view(np.float32)

    @pytest.mark.parametrize('sdt', ['bfloat16', 'float16'])
    def test_widen_compute_round(self, sdt):
        grid = dt.Grid(shape=(6, 7, 8))
        u = dt.TimeFunction(name='u', grid=grid, space_order=2)
        m = dt.Function(name='m', grid=grid, space_order=2)
        op = dt.Operator(dt.Eq(u.forward, 0.37 * u + u.dx / 3 + m * u),
                         subs=grid.spacing_map, opt=('advanced', {'storage-dtype': sdt,
                                           'storage-dtype-scope': 'all'}))
        (eq, plan), = op.kernel_plans
        narrow = torch.bfloat16 if sdt == 'bfloat16' else torch.float16
        assert plan.design == 'point' and \
            plan.design_reason.startswith('narrow storage')
        rng = np.random.default_rng(4)
        rows = [rng.standard_normal(g['fn']._allocated_space()).astype(
            np.float32) for g in plan.groups]
        ins = [torch.from_numpy(r).to(narrow) for r in rows]
        out = torch.zeros(u._allocated_space(), dtype=narrow)
        K.stencil_update(plan, (out, ins), {})
        # by hand: the narrow inputs as fp32, the right-hand side as the
        # lowering prints it, m*u - (1/(3h) - 0.37)*u + 1/(3h)*u[x+1],
        # rounded to the narrow dtype
        w = {g['fn'].name: t.float().numpy() for g, t in zip(plan.groups,
                                                            ins)}
        hl = 2
        sl = tuple(slice(hl, hl + n) for n in grid.shape)
        sx = (slice(hl + 1, hl + 1 + grid.shape[0]),) + sl[1:]
        uu, mm = w['u'], w['m']
        c = 1 / (3 * grid.spacing[0])
        want32 = (mm[sl] * uu[sl] - np.float32(c - 0.37) * uu[sl]
                  + np.float32(c) * uu[sx]).astype(np.float32)
        want = self.bf16_round(want32) if sdt == 'bfloat16' else \
            want32.astype(np.float16).astype(np.float32)
        got = out.float().numpy()[sl]
        # the sum's fp32 order may differ from the translator's by an fp32
        # ulp, which can move the rounded value by one narrow ulp
        diff = np.abs(got - want)
        assert (diff <= ulp(np.abs(want) + 1e-30, sdt)).all()
        assert (diff == 0).mean() > 0.95
        assert (out.float().numpy()[~np.pad(np.ones(grid.shape, bool),
                                             [(2, s - n - 2) for n, s in zip(
                                                 grid.shape, out.shape)])]
                == 0).all()

    def test_streaming_design_declines_narrow_rows(self):
        """The acoustic star that streams in fp32 takes the point design
        on bf16 rows, with the reason logged and counted as a design."""
        grid = dt.Grid(shape=(10, 11, 12), extent=(90., 100., 110.))
        u = dt.TimeFunction(name='u', grid=grid, time_order=2,
                            space_order=4)
        eq = dt.Eq(u.forward, dt.solve(u.dt2 - u.laplace, u.forward))
        before = dict(K.designs)
        wide = dt.Operator(eq, subs=grid.spacing_map)
        narrow = dt.Operator(eq, subs=grid.spacing_map, opt=BF16)
        assert wide.kernel_plans[0][1].design == 'stream'
        p = narrow.kernel_plans[0][1]
        assert p.design == 'point' and 'narrow storage (bfloat16 rows)' in \
            p.design_reason
        assert K.designs['point'] == before['point'] + 1


class TestInverseProblemNarrow:
    """devito_tpu's bounds for the inverse problem under narrow storage
    (tests/test_storage_dtype.py TestInverseProblemBf16, tests/test_fp16.py
    TestInverseProblemFp16): the adjoint dot test within 1e-2 (bf16) and
    5e-3 (fp16), the Taylor slopes 1.0 (rtol 0.1) and >= 1.4, and the
    checkpointed gradient bit-equal to the full-save one."""

    def _setup(self, opt, **kw):
        from devito_tpu_torch.models.seismic import acoustic_setup
        base = dict(shape=(50, 60), spacing=(10., 10.), dtype=np.float64,
                    kernel='OT2', tn=400.0, space_order=4, nbl=40,
                    preset='layers-isotropic', opt=opt)
        base.update(kw)
        return acoustic_setup(**base)

    @pytest.mark.parametrize('sdt,bound', [('bfloat16', 1e-2),
                                           ('float16', 5e-3)])
    def test_adjoint_dot_product(self, sdt, bound):
        from devito_tpu_torch.builtins import inner, norm
        solver = self._setup(('advanced', {'storage-dtype': sdt}),
                             shape=(60, 70), spacing=[15., 15.], nbl=10,
                             tn=250., space_order=8)
        srca = solver.geometry.new_src(name='srca', src_type=None)
        rec = solver.forward(save=False)[0]
        solver.adjoint(rec=rec, srca=srca)
        term1 = inner(srca, solver.geometry.src)
        term2 = norm(rec) ** 2
        assert abs((term1 - term2) / term1) < bound

    @pytest.mark.parametrize('sdt', ['bfloat16', 'float16'])
    def test_gradientFWI_taylor(self, sdt):
        from devito_tpu_torch import Function
        from devito_tpu_torch.builtins import smooth
        from devito_tpu_torch.models.seismic import Receiver
        from devito_tpu_torch.models.seismic.acoustic import \
            AcousticWaveSolver

        wave = self._setup(('advanced', {'storage-dtype': sdt}))
        clean = AcousticWaveSolver(wave.model, wave.geometry, kernel='OT2',
                                   space_order=4)
        vel0 = Function(name='vel0', grid=wave.model.grid, space_order=4)
        smooth(vel0, wave.model.vp)
        v = wave.model.vp.data
        dm = (wave.model.vp.data ** (-2)
              - vel0.data ** (-2)).astype(np.float64)
        rec_true = np.array(clean.forward()[0].data)
        rec = wave.forward()[0]
        rec0, u0 = wave.forward(vp=vel0, save=True)[0:2]
        rec0c = clean.forward(vp=vel0)[0]
        F0 = .5 * np.linalg.norm(np.asarray(rec0c.data) - rec_true) ** 2
        residual = Receiver(name='rec_res', grid=wave.model.grid,
                            data=(np.asarray(rec0.data)
                                  - np.asarray(rec.data)),
                            time_range=wave.geometry.time_axis,
                            coordinates=wave.geometry.rec_positions)
        gradient, _ = wave.jacobian_adjoint(residual, u0, vp=vel0)
        G = np.dot(np.asarray(gradient.data).reshape(-1), dm.reshape(-1))
        H = [0.5, 0.25, .125, 0.0625, 0.0312, 0.015625, 0.0078125]
        error1, error2 = np.zeros(7), np.zeros(7)
        vel0d = np.asarray(vel0.data)
        for i in range(7):
            def initializer(data):
                data[:] = np.sqrt(vel0d ** 2 * v ** 2 /
                                  ((1 - H[i]) * v ** 2 + H[i] * vel0d ** 2))
            vloc = Function(name=f'vloc{i}', grid=wave.model.grid,
                            space_order=4, initializer=initializer)
            d = clean.forward(vp=vloc)[0]
            F_i = .5 * np.linalg.norm(
                (np.asarray(d.data) - rec_true).reshape(-1)) ** 2
            error1[i] = np.absolute(F_i - F0)
            error2[i] = np.absolute(F_i - F0 - H[i] * G)
        p1 = np.polyfit(np.log10(H), np.log10(error1), 1)
        p2 = np.polyfit(np.log10(H), np.log10(error2), 1)
        assert np.isclose(p1[0], 1.0, rtol=0.1), p1
        assert p2[0] >= 1.4, p2

    def test_checkpointed_gradient_bit_equal(self):
        from devito_tpu_torch import Function
        from devito_tpu_torch.builtins import smooth
        from devito_tpu_torch.models.seismic import Receiver

        wave = self._setup(BF16, shape=(40, 45), tn=250.0, nbl=20)
        vel0 = Function(name='vel0', grid=wave.model.grid, space_order=4)
        smooth(vel0, wave.model.vp)
        rec = wave.forward()[0]
        rec0, u0 = wave.forward(vp=vel0, save=True)[0:2]
        residual = Receiver(name='rec_res', grid=wave.model.grid,
                            data=(np.asarray(rec0.data)
                                  - np.asarray(rec.data)),
                            time_range=wave.geometry.time_axis,
                            coordinates=wave.geometry.rec_positions)
        g_full, _ = wave.jacobian_adjoint(residual, u0, vp=vel0)
        gf = np.array(g_full.data)
        g_ck, _ = wave.jacobian_adjoint(residual, u0, vp=vel0,
                                        checkpointing=True)
        assert np.array_equal(gf, np.array(g_ck.data))


def test_fp16_storage_dtype_narrowing():
    """'storage-dtype': 'float16' narrows device storage like bf16."""
    grid = dt.Grid(shape=(16, 16), extent=(15., 15.))
    u = dt.TimeFunction(name='u', grid=grid, space_order=2)
    u.data[0][8, 8] = 1.0
    op = dt.Operator(dt.Eq(u.forward, u + 0.2 * u.laplace),
                     subs=grid.spacing_map,
                     opt=('advanced', {'storage-dtype': 'float16'}))
    op.apply(time_M=4, dt=0.1)
    assert u.storage_dtype == np.float16
    assert type(u)._dev_buf.dtype == torch.float16
    d = np.asarray(u.data[0])
    assert d.dtype == np.float32 and np.isfinite(d).all() and d.max() > 0


def test_norm_of_a_narrow_function_widens():
    """builtins read a narrow tensor in the compute dtype."""
    from devito_tpu_torch.builtins import norm
    _, u, op = diffusion(dt, BF16, nt=2, shape=(16, 16))
    want = np.linalg.norm(np.asarray(u.data, dtype=np.float64))
    u.set_storage_dtype('bfloat16')
    assert u._device_array().dtype == torch.bfloat16
    assert norm(u) == pytest.approx(want, rel=1e-6)


def test_bf16_pulse_stagnates_as_in_devito_tpu():
    """bench.py's update on a smooth pulse, 40 steps at 32^3: stored as
    bf16, the pulse's per-step change is below half an ulp at its peak,
    so the peak stays at 1 while the fp32 run's falls; devito_tpu's bf16
    run does the same, the two within a bf16 ulp of 1 (chip_smoke.py's
    second row shows it at 512^3)."""
    n, steps = 32, 40

    def run(pkg, opt):
        grid = pkg.Grid(shape=(n,) * 3, extent=(10. * (n - 1),) * 3)
        u = pkg.TimeFunction(name='u', grid=grid, time_order=2,
                             space_order=8)
        vp = pkg.Function(name='vp', grid=grid, space_order=8)
        damp = pkg.Function(name='damp', grid=grid, space_order=8)
        rng = np.random.default_rng(1234)
        vp.data[:] = 1.5 + 0.5 * rng.random((n,) * 3, dtype=np.float32)
        damp.data[:] = 0.01 * rng.random((n,) * 3, dtype=np.float32)
        x = (np.arange(n, dtype=np.float32) - n / 2) ** 2
        pulse = np.exp(-(x[:, None, None] + x[None, :, None]
                         + x[None, None, :]) / (2 * 6. ** 2))
        u.data[0] = pulse
        u.data[1] = pulse
        pde = (1 / (vp * vp)) * u.dt2 - u.laplace + damp * u.dt
        op = pkg.Operator(pkg.Eq(u.forward, pkg.solve(pde, u.forward)),
                          subs=grid.spacing_map, opt=opt)
        op.apply(time_m=1, time_M=steps, dt=0.6 * 10.0 / 1.5 / 3 ** 0.5 / 4)
        return np.array(u.data, dtype=np.float64)

    narrow = ('advanced', {'storage-dtype': 'bfloat16'})
    bf, bj = run(dt, narrow), run(dj, narrow)
    wide = run(dt, 'advanced')
    assert np.abs(bf).max() == 1.0 and np.abs(wide).max() < 0.9
    assert np.abs(bf - bj).max() <= 2. ** -7
