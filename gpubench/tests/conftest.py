"""The harness's tests. Those marked ``cuda`` need the card and skip, with
the reason, where there is none; the decision is taken inside the test.
Run them all with ``python -m pytest gpubench/tests -q`` from the
checkout's root (on the card too)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line('markers',
                            'cuda: needs an NVIDIA card; skips without one')


@pytest.fixture
def card():
    """The CUDA device, or a skip when this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: torch.cuda.is_available() is '
                    'False here')
    return torch.device('cuda', 0)
