"""The acoustic survey program: ``AcousticWaveSolver.forward`` of the
program under test, kernel OT2, on a caller-held wavefield ``u``."""

from .base import SurveyProgram

__all__ = ['Program']


class Program(SurveyProgram):

    fields = ('u',)

    def _solver(self, config, kwargs):
        from devito_tpu_torch.models.seismic import AcousticWaveSolver
        return AcousticWaveSolver(self.model, self.geometry,
                                  kernel=config['kernel'],
                                  space_order=config['space_order'], **kwargs)
