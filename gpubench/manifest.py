"""The benchmark's manifest (``BENCHMARK.json`` at the checkout's root) and
the files it names: each configuration's file, each traffic mix's file
(``traffic/<mix>.json``) and the job driver it names (``traffic/<driver>.py``,
so that mixes of one kind of job share a driver and a new mix of that kind
is a data file alone), each metric's reader (``endtoend/<name>.py``,
``metrics/<name>.py``) and each configuration's check limits
(``limits/<config>.json``). Everything is found by its name, so a new
configuration, mix or metric is a new file and a new entry."""

import importlib.util
import json
from pathlib import Path

__all__ = ['ROOT', 'HERE', 'Manifest']

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_module(path):
    spec = importlib.util.spec_from_file_location(
        f'gpubench_{path.parent.name}_' + path.stem.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / 'BENCHMARK.json').read_text())

    def cell(self, name):
        for w in self.data['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.data['configs']:
            if c['name'] == name:
                return json.loads((self.root / c['file']).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    @staticmethod
    def traffic(name):
        return json.loads((HERE / 'traffic' / f'{name}.json').read_text())

    @staticmethod
    def driver(mix):
        """The job driver that the traffic mix ``mix`` (its file's
        contents) names: the module ``traffic/<driver>.py``."""
        return _load_module(HERE / 'traffic' / f"{mix['driver']}.py")

    @staticmethod
    def limits(config_name):
        return json.loads((HERE / 'limits' / f'{config_name}.json')
                          .read_text())

    def metrics(self, kind, cell):
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
        reports: those with no ``workloads`` list and those whose list
        names it."""
        return [m for m in self.data[kind]
                if cell in m.get('workloads', [cell])]

    @staticmethod
    def reader(kind, name):
        """The ``read(ctx)`` function of the metric ``name``."""
        folder = 'endtoend' if kind == 'end_to_end' else 'metrics'
        return _load_module(HERE / folder / f'{name}.py').read
