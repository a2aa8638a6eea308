"""The port reads the JAX package's checkpoints: a `.ckpt` written by
decompdiff_tpu/utils/checkpoint.py save_checkpoint, with a real optax state,
loads in a process where jax, flax and optax cannot be imported, and the
weights it carries give the port's denoiser the JAX model's output.

Tolerance: rtol 2e-4 / atol 2e-5, that of the tiny denoiser's dense-path
parity (tests/test_torch_model.py): both sides run the same float32
formulas in other reduction orders.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.core import freeze

from decompdiff_tpu.config import Config as JaxConfig
from decompdiff_tpu.config import load_config as jax_load_config
from decompdiff_tpu.models.diffusion_model import DecompDiffModel as JaxModel
from decompdiff_tpu.training.train_step import create_train_state
from decompdiff_tpu.utils.checkpoint import save_checkpoint
from decompdiff_tpu.utils.testing import (
    random_complex_batch as jax_random_complex_batch)
from decompdiff_tpu_torch.config import Config, load_config
from decompdiff_tpu_torch.utils.checkpoint import load_checkpoint
from decompdiff_tpu_torch.utils.testing import tiny_model_config

REPO = Path(__file__).resolve().parents[1]
TINY_TOL = dict(rtol=2e-4, atol=2e-5)
TRAIN_CFG = {'optimizer': {'type': 'adam', 'lr': 5e-4, 'weight_decay': 1e-4},
             'max_grad_norm': 8.0}
T = [7, 13]

# Run in a fresh interpreter: jax, flax and optax blocked, the checkpoint
# loaded, the model built from it and run on the seeded batch.
CHILD = r'''
import json, sys
for name in ('jax', 'flax', 'optax'):
    sys.modules[name] = None
import numpy as np, torch
torch.set_num_threads(2)
from decompdiff_tpu_torch.utils.checkpoint import (
    load_checkpoint, load_model_from_checkpoint)
from decompdiff_tpu_torch.utils.testing import random_complex_batch
path, out = sys.argv[1], sys.argv[2]
ckpt = load_checkpoint(path)
model, _ = load_model_from_checkpoint(path, device='cpu')
batch = random_complex_batch(np.random.default_rng(0), device='cpu')
with torch.no_grad():
    preds = model.apply(batch, batch.ligand_pos, batch.ligand_v,
                        batch.bond_type, torch.tensor(%s))
np.savez(out, **{k: v.numpy() for k, v in preds.items()})
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'flax', 'optax', 'decompdiff_tpu')
             and sys.modules[m] is not None)
print(json.dumps({'step': ckpt['step'], 'iteration': ckpt['iteration'],
                  'keys': sorted(ckpt), 'imported': bad,
                  'num_classes': model.atom_diff.num_classes}))
''' % T


@pytest.fixture(scope='module')
def jax_checkpoints(tmp_path_factory):
    """A tiny model's train state (params + an optax chain state of clip,
    weight decay and inject_hyperparams(adam)) saved by the JAX package,
    with params as dicts and as a flax FrozenDict; returns ({'dict': path,
    'frozen': path}, params, the JAX model's predictions for the seeded
    batch)."""
    d = tmp_path_factory.mktemp('ckpt')
    cfg = tiny_model_config()
    model = JaxModel.create(cfg, 8)
    batch = jax_random_complex_batch(np.random.default_rng(0))
    state, _ = create_train_state(model, jax.random.PRNGKey(3), batch,
                                  TRAIN_CFG)
    config = JaxConfig({'data': {'transform': {'ligand_atom_mode': 'basic'}},
                        'model': cfg, 'train': TRAIN_CFG}).to_dict()
    paths = {}
    for kind, params in (('dict', state.params),
                         ('frozen', freeze(state.params))):
        paths[kind] = d / f'{kind}.ckpt'
        save_checkpoint(str(paths[kind]), config,
                        state.replace(params=params, step=5), {'best': 1.0},
                        iteration=5)
    preds = model.apply(state.params, batch, batch.ligand_pos,
                        batch.ligand_v, batch.bond_type, jnp.array(T))
    return paths, jax.tree.map(np.asarray, state.params), \
        {k: np.asarray(v) for k, v in preds.items()}


@pytest.mark.parametrize('frozen', ['dict', 'frozen'])
def test_jax_checkpoint_loads_without_jax(jax_checkpoints, tmp_path,
                                          frozen):
    paths, _, want = jax_checkpoints
    path = paths[frozen]
    raw = path.read_bytes()          # optax's and flax's classes inside
    assert b'optax' in raw and (b'FrozenDict' in raw) == (frozen == 'frozen')
    out = tmp_path / 'preds.npz'
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', CHILD, str(path), str(out)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info == {'step': 5, 'iteration': 5, 'imported': [],
                    'keys': ['config', 'iteration', 'params', 'step'],
                    'num_classes': 8}
    got = np.load(out)
    assert sorted(got.files) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TINY_TOL, err_msg=k)


def test_params_and_config_are_plain_and_exact(jax_checkpoints):
    paths, params, _ = jax_checkpoints
    ckpt = load_checkpoint(str(paths['frozen']))
    assert ckpt['config']['model'] == tiny_model_config()
    assert ckpt['config']['train'] == TRAIN_CFG

    def leaves(tree, prefix=''):
        assert type(tree) is dict, prefix
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f'{prefix}/{k}')
            else:
                yield f'{prefix}/{k}', v

    want, got = dict(leaves(params)), dict(leaves(ckpt['params']))
    assert sorted(got) == sorted(want)
    for k in want:
        assert type(got[k]) is np.ndarray and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_config_matches_jax():
    path = REPO / 'configs' / 'sampling.yml'
    got, want = load_config(str(path)), jax_load_config(str(path))
    assert got.to_dict() == want.to_dict()
    assert got.sample.energy_drift[1].sigma == want.sample.energy_drift[1].sigma
    cfg = Config({'a': {'b': [{'c': 1}]}})
    assert cfg.a.b[0].c == 1 and type(cfg.to_dict()['a']['b'][0]) is dict


class _Eval:
    def __reduce__(self):
        return eval, ('1 + 1',)


def test_checkpoint_naming_a_builtin_function_is_refused(tmp_path):
    path = tmp_path / 'bad.ckpt'
    path.write_bytes(pickle.dumps({'config': {}, 'params': {},
                                   'extra': _Eval()}))
    with pytest.raises(pickle.UnpicklingError, match='builtins.eval'):
        load_checkpoint(str(path))
