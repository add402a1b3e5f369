"""Full-waveform inversion driver.

Reference parity: examples/seismic/inversion/fwi.py + inversion_utils.py —
multi-shot adjoint-state gradient descent on the camembert model with box
constraints. devito_tpu's examples/seismic_fwi.py through the port: the
forward, save-forward and gradient of every shot on K1 (the gradient's
``Inc`` in the torch translator).
"""

import numpy as np

from devito_tpu_torch import Function
from devito_tpu_torch.models.seismic import (AcquisitionGeometry,
                                       AcousticWaveSolver, demo_model)


def compute_residual(residual, d_obs, d_syn):
    """residual = d_syn - d_obs (reference: inversion_utils.py)."""
    residual.data[:] = np.asarray(d_syn.data) - np.asarray(d_obs.data)
    return residual


def update_with_box(vp, alpha, dm, vmin=2.0, vmax=3.5):
    """Box-constrained model update (reference: inversion_utils.py)."""
    vp.data[:] = np.clip(np.asarray(vp.data) + alpha * dm, vmin, vmax)


def run_fwi(shape=(61, 61), nshots=4, nreceivers=31, fwi_iterations=3,
            tn=600., spacing=(10., 10.), nbl=20, space_order=4):
    origin = (0., 0.)
    model = demo_model('circle-isotropic', vp_circle=3.0,
                       vp_background=2.5, origin=origin, shape=shape,
                       spacing=spacing, nbl=nbl, space_order=space_order,
                       r=8)
    model0 = demo_model('circle-isotropic', vp_circle=2.5,
                        vp_background=2.5, origin=origin, shape=shape,
                        spacing=spacing, nbl=nbl, space_order=space_order,
                        r=8, grid=model.grid)

    t0, f0 = 0., 0.010
    src_coordinates = np.empty((1, 2))
    src_coordinates[0, :] = np.array(model.domain_size) * .5
    src_coordinates[0, 0] = 20.

    rec_coordinates = np.empty((nreceivers, 2))
    rec_coordinates[:, 1] = np.linspace(0, model.domain_size[0],
                                        num=nreceivers)
    rec_coordinates[:, 0] = model.domain_size[0] - 20.

    geometry = AcquisitionGeometry(model, rec_coordinates, src_coordinates,
                                   t0, tn, f0=f0, src_type='Ricker')
    solver = AcousticWaveSolver(model, geometry, space_order=space_order)

    source_locations = np.empty((nshots, 2), dtype=np.float32)
    source_locations[:, 0] = 20.
    source_locations[:, 1] = np.linspace(0., model.domain_size[1],
                                         num=nshots)

    residual = geometry.new_rec(name='residual')
    d_obs = geometry.new_rec(name='d_obs')
    d_syn = geometry.new_rec(name='d_syn')
    src = geometry.src

    def fwi_gradient(vp_in):
        grad = Function(name="grad", grid=model.grid)
        objective = 0.
        for i in range(nshots):
            src.coordinates.data[0, :] = source_locations[i, :]
            solver.forward(vp=model.vp, rec=d_obs, src=src)
            _, u0, _ = solver.forward(vp=vp_in, save=True, rec=d_syn,
                                      src=src)
            compute_residual(residual, d_obs, d_syn)
            objective += .5 * float(np.linalg.norm(
                np.asarray(residual.data)) ** 2)
            solver.jacobian_adjoint(rec=residual, u=u0, vp=vp_in, grad=grad)
        return objective, np.asarray(grad.data).copy()

    history = np.zeros((fwi_iterations, 1))
    for i in range(fwi_iterations):
        phi, direction = fwi_gradient(model0.vp)
        history[i] = phi
        alpha = .05 / max(abs(direction.max()), abs(direction.min()))
        update_with_box(model0.vp, alpha, direction)
    return history, model0


if __name__ == '__main__':
    history, model0 = run_fwi()
    print("objective history:", history.ravel())
