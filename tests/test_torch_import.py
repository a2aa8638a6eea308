"""The PyTorch port stands alone: it imports no JAX (or flax/optax) and
nothing of decompdiff_tpu, and its entry points refuse to fall back to the
CPU when no device is named and no GPU exists."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import decompdiff_tpu_torch
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.parallel.mesh import make_mesh
from decompdiff_tpu_torch.utils.testing import (
    DEFAULT_MODEL_CONFIG, random_complex_batch)

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / 'decompdiff_tpu_torch'
FORBIDDEN = ('jax', 'flax', 'optax', 'decompdiff_tpu')
# the data-preparation scripts, each scripts/<name>_torch.py beside the
# JAX package's scripts/<name>.py
DATA_SCRIPTS = ('preprocess_subcomplex', 'import_reference_data',
                'split_dataset', 'clean_crossdocked', 'make_synthetic_data')


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        decompdiff_tpu_torch.__path__, 'decompdiff_tpu_torch.'))


def test_every_submodule_imports_without_jax():
    code = (
        'import importlib, sys\n'
        f'for name in {_modules()!r}:\n'
        '    importlib.import_module(name)\n'
        f'bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})\n'
        'print(bad)\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(_modules()) >= 20
    # the data-parallel package (the counterpart of decompdiff_tpu/parallel)
    assert {'decompdiff_tpu_torch.parallel',
            'decompdiff_tpu_torch.parallel.mesh'} <= set(_modules())


@pytest.mark.parametrize('path', sorted(
    {str(p.relative_to(REPO)) for p in PACKAGE.rglob('*.py')}
    | {'decompdiff_tpu_torch/parallel/__init__.py',
       'decompdiff_tpu_torch/parallel/mesh.py'}
    | {'chip_smoke.py', 'scripts/sample_torch.py',
       'scripts/train_torch.py', 'scripts/convert_checkpoint_torch.py',
       'scripts/evaluate_torch.py'} | {f'scripts/{s}_torch.py'
                                       for s in DATA_SCRIPTS}))
def test_no_forbidden_import_statement(path):
    assert (REPO / path).exists(), path
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in FORBIDDEN, (path, name)


def test_imports_without_yaml_and_sampling_script_starts():
    """With jax, flax, optax, the JAX package and PyYAML all unimportable,
    every module of the port imports and the sampling script parses its
    arguments (PyYAML is needed only to read a config file)."""
    code = (
        'import importlib, runpy, sys\n'
        f'for name in {FORBIDDEN + ('yaml',)!r}:\n'
        '    sys.modules[name] = None\n'
        f'for name in {_modules()!r}:\n'
        '    importlib.import_module(name)\n'
        "sys.argv = ['sample_torch.py', '--help']\n"
        'try:\n'
        "    runpy.run_path('scripts/sample_torch.py', run_name='__main__')\n"
        'except SystemExit as e:\n'
        '    assert e.code == 0, e.code\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '--use_pallas' in proc.stdout and '--device' in proc.stdout


def test_evaluation_script_runs_without_jax_and_yaml(tmp_path):
    """With jax, flax, optax, the JAX package and PyYAML unimportable,
    every module of the port imports, scripts/evaluate_torch.py --help
    exits 0, and the script scores a result pickle written by the port's
    sampling driver (its molecules named as the JAX package's class)."""
    code = (
        'import importlib, pickle, runpy, sys\n'
        'import numpy as np\n'
        f'for name in {FORBIDDEN + ('yaml',)!r}:\n'
        '    sys.modules[name] = None\n'
        f'for name in {_modules()!r}:\n'
        '    importlib.import_module(name)\n'
        'from decompdiff_tpu_torch.data.mol import MolRecord\n'
        'from decompdiff_tpu_torch.sampling.driver import save_result\n'
        'def script(*argv):\n'
        "    sys.argv = ['evaluate_torch.py', *argv]\n"
        '    try:\n'
        "        runpy.run_path('scripts/evaluate_torch.py',"
        " run_name='__main__')\n"
        '    except SystemExit as e:\n'
        '        assert e.code == 0, e.code\n'
        "script('--help')\n"
        # benzyl alcohol, a bent chain of ring and side chain
        'ring = [(i, (i + 1) % 6, 4) for i in range(6)]\n'
        'bonds = ring + [(0, 6, 1), (6, 7, 1)]\n'
        'src = [a for a, b, _ in bonds] + [b for a, b, _ in bonds]\n'
        'dst = [b for a, b, _ in bonds] + [a for a, b, _ in bonds]\n'
        'typ = [t for _, _, t in bonds] * 2\n'
        'ang = np.arange(6) * np.pi / 3\n'
        'pos = np.zeros((8, 3), np.float32)\n'
        'pos[:6, 0], pos[:6, 1] = 1.39 * np.cos(ang), 1.39 * np.sin(ang)\n'
        'pos[6] = (2.9, 0.0, 0.0); pos[7] = (3.6, 1.2, 0.0)\n'
        'mol = MolRecord(element=np.array([6] * 7 + [8]), pos=pos,\n'
        '                bond_index=np.array([src, dst]),\n'
        '                bond_type=np.array(typ),\n'
        '                aromatic=np.array([True] * 6 + [False] * 2))\n'
        "res = {'mol': mol, 'complete': True, 'pred_pos': pos,\n"
        "       'pred_v': np.array([1] * 7 + [3]),\n"
        "       'ligand_filename': 'p/lig.sdf'}\n"
        f"out = {str(tmp_path)!r}\n"
        "save_result(out + '/result_0.pkl',\n"
        "            {'results': [res, dict(res)], 'atom_mode': 'basic'})\n"
        "script(out)\n"
        "s = pickle.load(open(out + '/eval_summary.pkl', 'rb'))\n"
        "assert s['n_complete'] == 2 and len(s['chem']) == 2, s\n"
        "assert s['chem_backend'] == 'first_party'\n"
        "assert 0 < s['chem'][0]['qed'] < 1\n"
        f'bad = sorted(m for m in sys.modules if m and m.split(".")[0] in {FORBIDDEN!r}'
        ' and sys.modules[m] is not None)\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '--docking_mode' in proc.stdout
    assert 'total 2, reconstructed 2' in proc.stdout


def test_data_scripts_run_without_jax(tmp_path):
    """With jax, flax, optax, the JAX package and PyYAML unimportable,
    each data script's --help exits 0, and raw pairs become a split store
    through preprocess_subcomplex_torch.py (its worker forked with the
    same modules blocked), import_reference_data_torch.py and
    split_dataset_torch.py. The modules are blocked by an import hook,
    not by None in sys.modules: scipy asks `'jax' in sys.modules`."""
    code = (
        'import pickle, runpy, sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        f'        if name.split(".")[0] in {FORBIDDEN + ('yaml',)!r}:\n'
        '            raise ImportError(name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'def script(name, *argv):\n'
        '    sys.argv = [name, *argv]\n'
        '    try:\n'
        '        runpy.run_path("scripts/" + name, run_name="__main__")\n'
        '    except SystemExit as e:\n'
        '        assert e.code == 0, (name, e.code)\n'
        f'for name in {DATA_SCRIPTS!r}:\n'
        '    script(name + "_torch.py", "--help")\n'
        'from decompdiff_tpu_torch.utils.testing import write_raw_pairs\n'
        f'root = {str(tmp_path)!r}\n'
        'index = write_raw_pairs(root + "/raw", 1, half=4)\n'
        'pickle.dump(index, open(root + "/index.pkl", "wb"))\n'
        'script("preprocess_subcomplex_torch.py", root + "/index.pkl",\n'
        '       "--raw_root", root + "/raw", "--dest", root + "/dest",\n'
        '       "--num_workers", "1")\n'
        'script("import_reference_data_torch.py", "--index",\n'
        '       root + "/dest", "--out", root + "/s.ddstore")\n'
        'script("split_dataset_torch.py", root + "/s.ddstore")\n'
        f'bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for option in ('--raw_root', '--lmdb', '--unique_pocket_test',
                   '--rmsd_thr', '--random-types'):
        assert option in proc.stdout
    assert "done: {'ok': 1}" in proc.stdout
    assert 'wrote 1 records' in proc.stdout
    assert 'wrote split: train=0 test=1' in proc.stdout


def test_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecompDiffModel.create(DEFAULT_MODEL_CONFIG, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_complex_batch(np.random.default_rng(0))
    for key in ('RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()


def test_create_on_this_host_without_device_raises():
    """This host has no CUDA: create(cfg, 8) must raise, not fall back."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError):
        DecompDiffModel.create(DEFAULT_MODEL_CONFIG, 8)
