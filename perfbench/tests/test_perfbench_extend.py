"""A cell, a configuration, a traffic mix, a kind of traffic and a per-layer
metric are added with new files and new entries only: in a copy of the
benchmark, the new cells load, find their new metric's reader and their
traffic's driver by name, and run (the CPU rehearsal), while no file that
was there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from perfbench.core import spec

READER = '''"""Share of each traced sampling step the denoiser takes, in
percent (an example added by a later change). Moves
sample_mol_steps_per_s."""


def read(ctx):
    if ctx.kind != 'sample' or not ctx.denoiser_ms:
        return None
    step_ms = ctx.trace.window_us / 1e3 / ctx.trace.steps
    return 100.0 * sum(ctx.denoiser_ms) / len(ctx.denoiser_ms) / step_ms
'''


DRIVER = '''"""Traffic of kind `sample_chains` (an example added by a later change):
sampling in chains of `chain_steps` steps, each chain restarting from x_T
with fresh draws; otherwise the `sample` driver's."""

from perfbench.core import spec

_base = spec.driver('sample')
reference, numbers = _base.reference, _base.numbers


def run(cell, seed, seconds, trace, device, result):
    cell.traffic['num_steps'] = cell.traffic['chain_steps']
    return _base.run(cell, seed, seconds, trace, device, result)
'''


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if '__pycache__' not in dirpath:
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, 'rb').read()).hexdigest()
    return out


def test_new_cell_config_traffic_and_metric_by_files_only(tmp_path):
    shutil.copy(spec.ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(spec.ROOT / 'perfbench', tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = _digests(tmp_path / 'perfbench')
    pb = tmp_path / 'perfbench'

    cfg = json.loads((pb / 'configs' / 'decompdiff_bond.json').read_text())
    cfg['name'] = 'decompdiff_bond_knn24'
    cfg['model']['knn'] = 24
    (pb / 'configs' / 'decompdiff_bond_knn24.json').write_text(
        json.dumps(cfg))
    traffic = json.loads(
        (pb / 'traffic' / 'sample_pocket_b100.json').read_text())
    traffic['batch'] = 8
    traffic['num_steps'] = 500          # the schedule, as data
    (pb / 'traffic' / 'sample_pocket_b8.json').write_text(json.dumps(traffic))
    chains = dict(traffic, kind='sample_chains', chain_steps=2)
    (pb / 'traffic' / 'sample_chains2_b8.json').write_text(json.dumps(chains))
    (pb / 'drivers' / 'sample_chains.py').write_text(DRIVER)
    limits = json.loads((pb / 'limits' / 'bond.sample.b100.json').read_text())
    for cell in ('knn24.sample.b8', 'knn24.chains2.b8'):
        (pb / 'limits' / f'{cell}.json').write_text(json.dumps(limits))
    (pb / 'metrics' / 'denoiser_share_pct.sample.py').write_text(READER)

    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': 'decompdiff_bond_knn24', 'source': 'an example',
        'file': 'perfbench/configs/decompdiff_bond_knn24.json',
        'reduced': ['knn'], 'why': 'an example'})
    new = {'knn24.sample.b8': 'sample_pocket_b8',
           'knn24.chains2.b8': 'sample_chains2_b8'}
    for name, mix in new.items():
        bench['workloads'].append({
            'name': name, 'config': 'decompdiff_bond_knn24',
            'traffic': mix, 'chips': 1, 'why': 'an example'})
    for m in bench['end_to_end']:
        if 'workloads' in m and 'bond.sample.b100' in m['workloads']:
            m['workloads'] += list(new)
    bench['per_layer'].append({
        'name': 'denoiser_share_pct.sample', 'unit': '%', 'better': 'lower',
        'source': 'device_trace', 'layer': 'denoiser',
        'moves': 'sample_mol_steps_per_s', 'workloads': list(new)})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))

    cell = spec.load_cell('knn24.sample.b8', tmp_path)
    assert cell.traffic['batch'] == 8 and cell.model['knn'] == 24
    names = [m['name'] for m in cell.per_layer]
    assert 'denoiser_share_pct.sample' in names
    assert callable(spec.metric_reader('denoiser_share_pct.sample', tmp_path))
    chains = spec.load_cell('knn24.chains2.b8', tmp_path)
    assert callable(spec.driver(chains.traffic['kind'], tmp_path).run)

    env = dict(os.environ, PYTHONPATH=str(spec.ROOT), CUDA_VISIBLE_DEVICES='')
    for name in new:
        p = subprocess.run([sys.executable, 'perfbench/rehearse.py',
                            '--workload', name, '--seconds', '1'],
                           cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])['correct']
        notes = json.loads(p.stderr.split('perfbench: ')[-1].splitlines()[0])
        if name == 'knn24.chains2.b8':      # the window's check in chain 1+
            assert notes['checked'][-1][0] >= 1, notes

    after = _digests(tmp_path / 'perfbench')
    assert {k: after[k] for k in before} == before
