"""The port's reference-checkpoint converter
(decompdiff_tpu_torch/utils/convert_checkpoint.py and
scripts/convert_checkpoint_torch.py) against the JAX package's.

  * convert_reference_state_dict: the same tree, leaf for leaf bitwise (both
    are the same numpy code), for uni_o2_bond with bond_net_type lin and
    pre_att, uni_o2 with every ew_net_type, and the prior node;
  * the .pt reader: a reference-layout file with its config an
    easydict.EasyDict is read without easydict; a file naming any other
    global is refused before the global is called;
  * the script end to end: its .ckpt equals the JAX script's, and the
    port's load_model_from_checkpoint and the JAX package's load_checkpoint
    read the same parameters from it.
"""

import os
import pickle
import runpy
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from decompdiff_tpu.utils import convert_checkpoint as jconvert
from decompdiff_tpu.utils.checkpoint import load_checkpoint as jax_load
from decompdiff_tpu_torch.utils import convert_checkpoint as tconvert
from decompdiff_tpu_torch.utils.checkpoint import load_model_from_checkpoint
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.utils.params import (
    load_flax_params, state_dict_to_flax)
from decompdiff_tpu_torch.utils.testing import (
    save_reference_checkpoint, tiny_model_config)
from tests import reference_oracle as oracle

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
NUM_CLASSES, NUM_BOND, PROTEIN_FEAT = 8, 5, 29


def _config(**over):
    cfg = tiny_model_config(knn=8, num_layers=2, hidden_dim=32, n_heads=4)
    cfg.update(over)
    return cfg


def _state_dict(kind, seed=11):
    """(config, reference-layout state dict) of a topology."""
    args = (NUM_CLASSES, NUM_BOND, PROTEIN_FEAT, NUM_CLASSES + 2)
    rng = np.random.default_rng(seed)
    if kind.startswith('uni_o2_'):
        ew = kind[len('uni_o2_'):]
        cfg = _config(model_type='uni_o2', ew_net_type=ew,
                      bond_diffusion=ew == 'global', bond_net_type='pre_att')
        return cfg, oracle.make_reference_state_dict_o2(rng, cfg, *args)
    if kind == 'prior':
        cfg = _config(add_prior_node=True, edge_feat_dim=6)
        sd = oracle.make_reference_state_dict(rng, cfg, *args)
        return cfg, oracle.extend_state_dict_prior(
            sd, np.random.default_rng(seed + 1), cfg)
    cfg = _config(bond_net_type=kind, x2h_out_fc=kind == 'pre_att')
    return cfg, oracle.make_reference_state_dict(rng, cfg, *args)


def _leaves(tree, path=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f'{path}/{k}')
    else:
        yield path, tree


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, np.ndarray) and g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize('kind', ['lin', 'pre_att', 'uni_o2_global',
                                  'uni_o2_r', 'uni_o2_m', 'uni_o2_none',
                                  'prior'])
def test_converter_matches_jax_bitwise(kind):
    cfg, sd = _state_dict(kind)
    got = tconvert.convert_reference_state_dict(sd, cfg)
    _assert_trees_equal(got, jconvert.convert_reference_state_dict(sd, cfg))
    # the tree is the port model's, parameter for parameter
    model = DecompDiffModel.create(cfg, NUM_CLASSES, device='cpu')
    load_flax_params(model.denoiser, got)
    _assert_trees_equal(state_dict_to_flax(model.denoiser.state_dict()), got)


def test_reader_takes_an_easydict_config(tmp_path):
    cfg, sd = _state_dict('lin')
    full = {'model': cfg, 'data': {'transform': {'ligand_atom_mode': 'basic'},
                                   'splits': [{'name': 'train'}]}}
    path = tmp_path / 'ref.pt'
    save_reference_checkpoint(str(path), sd, full, iteration=42)
    assert 'easydict' not in sys.modules          # installed for the save only
    raw = tconvert.read_reference_checkpoint(str(path))
    assert type(raw['config']) is tconvert.EasyDict
    assert raw['config'].model.hidden_dim == cfg['hidden_dim']
    assert raw['iteration'] == 42
    got_sd, got_cfg = tconvert.load_reference_checkpoint(str(path))
    assert got_cfg == cfg and type(got_cfg) is dict
    assert tconvert.plain_dict(raw['config']) == full
    assert sorted(got_sd) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got_sd[k], v.astype(np.float32))


class _Payload:
    """Pickles as a call of os.getcwd: a global the reader must refuse."""

    def __reduce__(self):
        return os.getcwd, ()


def test_reader_refuses_other_globals(tmp_path):
    _, sd = _state_dict('lin')
    path = tmp_path / 'bad.pt'
    torch.save({'config': {'model': {}}, 'model': {
        k: torch.as_tensor(v) for k, v in list(sd.items())[:2]},
        'extra': _Payload()}, path)
    with pytest.raises(pickle.UnpicklingError, match='os.getcwd|posix.getcwd'):
        tconvert.read_reference_checkpoint(str(path))


def test_script_matches_jax_script_and_both_loaders(tmp_path, monkeypatch):
    cfg, sd = _state_dict('lin')
    full = {'model': cfg, 'data': {'transform': {'ligand_atom_mode': 'basic'}}}
    ref = tmp_path / 'ref.pt'
    save_reference_checkpoint(str(ref), sd, full, iteration=5)

    # the port's script with jax, flax, optax and the JAX package blocked
    port = tmp_path / 'port.ckpt'
    code = ('import runpy, sys\n'
            "for name in ('jax', 'flax', 'optax', 'decompdiff_tpu'):\n"
            '    sys.modules[name] = None\n'
            f"sys.argv = ['convert', {str(ref)!r}, '--out', {str(port)!r}]\n"
            "runpy.run_path('scripts/convert_checkpoint_torch.py',"
            " run_name='__main__')\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'M params' in proc.stdout

    # the JAX script in this process, its easydict stand-in restored after
    stub = types.ModuleType('easydict')
    stub.EasyDict = tconvert.EasyDict
    monkeypatch.setitem(sys.modules, 'easydict', stub)
    want = tmp_path / 'jax.ckpt'
    monkeypatch.setattr(sys, 'argv', ['convert', str(ref), '--out',
                                      str(want)])
    runpy.run_path(str(REPO / 'scripts' / 'convert_checkpoint.py'),
                   run_name='__main__')

    got, jax_payload = jax_load(str(port)), jax_load(str(want))
    assert set(got) == set(jax_payload)
    for k in ('config', 'opt_state', 'step', 'scheduler', 'iteration'):
        assert got[k] == jax_payload[k], k
    assert type(got['config']['model']) is dict and got['step'] == 5
    _assert_trees_equal(got['params'], jax_payload['params'])

    model, ckpt = load_model_from_checkpoint(str(port), device='cpu')
    _assert_trees_equal(state_dict_to_flax(model.denoiser.state_dict()),
                        jax_payload['params'])
    assert ckpt['iteration'] == 5
