"""What a cell is made of, found by the names in BENCHMARK.json: the
workload entry, its configuration file (configs/<name>.json, named by the
configuration's `file`), its traffic file (traffic/<traffic>.json), the
driver of that traffic's `kind` (drivers/<kind>.py), the limits of its
correctness comparison (limits/<workload>.json) and the readers of its
per-layer metrics (metrics/<metric>.py). A later cell, configuration,
traffic mix, kind of traffic or metric is new files and new entries;
nothing here changes.

A driver module has three functions:
  run(cell, seed, seconds, trace, device, result) -> evidence
      set-up, the measured window (into result, core/runner.py), and what
      the reference needs to judge the timed path: evidence.program holds
      what the program produced;
  reference(evidence, tf32=False, half=False) -> outputs
      the reference in the program's place, in float32 with TF32 off (tf32:
      the control; half: the fault of half the batch left out);
  numbers(evidence, outputs, ref) -> {name: value}
      the numbers that decide `correct`, of outputs against ref.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]      # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's contents
    limits: dict            # number -> limit of the correctness comparison
    end_to_end: list        # the metric entries this cell reports
    per_layer: list
    root: Path = ROOT

    @property
    def model(self) -> dict:
        return self.config['model']


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return 'workloads' not in metric or workload in metric['workloads']


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of the BENCHMARK.json at `root`."""
    bench = load_json(root / 'BENCHMARK.json')
    here = root / 'perfbench'
    work = {w['name']: w for w in bench['workloads']}
    if name not in work:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json; '
                         f'known: {sorted(work)}')
    w = work[name]
    conf = {c['name']: c for c in bench['configs']}[w['config']]
    e2e = [m for m in bench['end_to_end'] if _reports(m, name)]
    reported = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if _reports(m, name) and m['moves'] in reported]
    return Cell(name=name, workload=w, config=load_json(root / conf['file']),
                traffic=load_json(here / 'traffic' / f"{w['traffic']}.json"),
                limits=load_json(here / 'limits' / f'{name}.json'),
                end_to_end=e2e, per_layer=per_layer, root=root)


def _module(folder: str, name: str, root: Path):
    path = root / 'perfbench' / folder / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'perfbench_{folder}_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The `read(ctx)` function of metrics/<name>.py."""
    return _module('metrics', name, root).read


def driver(kind: str, root: Path = ROOT):
    """The driver module of traffic of this kind: drivers/<kind>.py."""
    return _module('drivers', kind, root)
