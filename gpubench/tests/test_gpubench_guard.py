"""The import guard compares whole top-level names: the program under
test, ``devito_tpu_torch``, begins with ``devito_tpu`` and passes; JAX,
jaxlib, flax and the JAX package fail. Nothing under gpubench/ imports
them, and a run loads none of them."""

import ast
from pathlib import Path

from gpubench import guard

HERE = Path(guard.__file__).resolve().parent


def test_whole_top_level_names():
    assert guard.loaded(['devito_tpu_torch', 'devito_tpu_torch.types',
                         'devito_tpux', 'jaxtyping', 'numpy']) == []
    assert guard.loaded(['devito_tpu.types.dense']) == ['devito_tpu']
    assert guard.loaded(['jax.numpy', 'jaxlib', 'flax.linen', 'os']) == \
        ['flax', 'jax', 'jaxlib']


def test_no_source_under_gpubench_imports_them():
    for path in HERE.rglob('*.py'):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert guard.loaded(names) == [], (path, names)


def test_a_run_loads_none_of_them():
    from gpubench.tests.helpers import run
    run('acoustic', seconds=0.2)
    assert guard.loaded() == []
