"""The TTI survey program: ``AnisotropicWaveSolver.forward`` of the
program under test, centred kernel, on caller-held wavefields ``u`` and
``v``."""

from .base import SurveyProgram

__all__ = ['Program']


class Program(SurveyProgram):

    fields = ('u', 'v')

    def _solver(self, config, kwargs):
        from devito_tpu_torch.models.seismic import AnisotropicWaveSolver
        return AnisotropicWaveSolver(self.model, self.geometry,
                                     space_order=config['space_order'],
                                     kernel=config['kernel'], **kwargs)
