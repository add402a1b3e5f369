"""A run whose timed path is broken underneath comes out not correct,
under the cells' own limits: the whole run but the look for a card, on
the CPU at a small size, once for each fault a survey cell can have (the
``shots`` driver's ``FAULTS``: no step run, half the steps, one record
sample altered, the source a grid point deeper). The cells run on one
card: there is no exchange between cards to leave out."""

import pytest

from gpubench.manifest import Manifest
from gpubench.tests.helpers import run

FAULTS = sorted(Manifest.driver(Manifest.traffic('shots')).FAULTS)


def test_every_fault_a_survey_can_have():
    assert FAULTS == ['half_the_steps', 'no_steps', 'one_sample_altered',
                      'src_elsewhere']


@pytest.mark.parametrize('problem', ['acoustic', 'tti'])
@pytest.mark.parametrize('fault', FAULTS)
def test_fault_is_not_correct(problem, fault):
    res = run(problem, seconds=0.1, fault=fault)
    assert res['correct'] is False
    assert any(c['value'] is None or c['value'] > c['limit']
               for c in res['checks'].values())


@pytest.mark.parametrize('problem', ['acoustic', 'tti'])
def test_sound_run_is_correct(problem):
    res = run(problem, seconds=0.1)
    assert res['correct'] is True, res['checks']
