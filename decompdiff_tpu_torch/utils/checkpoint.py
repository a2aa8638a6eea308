"""Checkpoints in the JAX package's `.ckpt` layout (port of
decompdiff_tpu/utils/checkpoint.py): saving, reading and resuming.

A `.ckpt` is a pickle of {config, params, opt_state, step, lt_history,
lt_count, scheduler, iteration, extra} (decompdiff_tpu/utils/checkpoint.py
save_checkpoint). Its config and params are plain dicts of numpy arrays;
the JAX package's opt_state holds optax's state classes. The reader
resolves only the classes of numpy, builtins and collections; any other
class (optax's, flax's) becomes a stub that keeps the arguments it was
built from, so jax, flax and optax are never imported and optax's Adam
state (a namedtuple) can still be found in it by its structure.

The port writes the same keys with every leaf a numpy array or a builtin,
so numpy alone reads its files, and so do the JAX package's
load_checkpoint and scripts/sample.py. Its opt_state is its own plain
layout (ADAM_LAYOUT): per-parameter Adam `count`, `mu` and `nu` in flax
parameter paths, and `lr`. `read_checkpoint` gives a JAX file's optax
state in that layout too, so `restore_train_state` resumes from either.
"""

from __future__ import annotations

import os
import pickle
from typing import Mapping, Optional

import numpy as np
import torch

from decompdiff_tpu_torch.constants import atom_class_count
from decompdiff_tpu_torch.device import DeviceLike
from decompdiff_tpu_torch.utils.params import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)

_RESOLVED = ('numpy', 'builtins', 'collections')
# flax's FrozenDict pickles as FrozenDict(plain dict): read it as that dict
_AS_DICT = {('flax.core.frozen_dict', 'FrozenDict')}


# the port's optimizer state layout, told apart from an optax state by this
# value under 'layout'
ADAM_LAYOUT = 'decompdiff_tpu_torch.adam'


class _Stub(dict):
    """Stands in for a class outside numpy, builtins and collections. It
    keeps the arguments the pickle builds it from in `fields` (a
    namedtuple's fields, in order) and its dict items (a dict subclass such
    as a config class keeps its contents); any other state is dropped."""

    fields: tuple = ()

    def __new__(cls, *args, **kwargs):
        self = super().__new__(cls)
        self.fields = args + tuple(kwargs.values())
        return self

    def __init__(self, *args, **kwargs):
        super().__init__()

    def __setstate__(self, state):
        pass

    def append(self, item):
        pass

    def extend(self, items):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split('.')[0] in _RESOLVED:
            found = super().find_class(module, name)
            if module == 'builtins' and not isinstance(found, type):
                raise pickle.UnpicklingError(
                    f'a checkpoint names builtins.{name}, not a class')
            return found
        if (module, name) in _AS_DICT:
            return dict
        return _Stub


def _plain(tree, path='params'):
    """Nested mappings of arrays -> nested dicts of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: _plain(v, f'{path}.{k}') for k, v in tree.items()}
    if not isinstance(tree, (np.ndarray, np.generic)):
        raise TypeError(f'{path}: {type(tree).__name__} is not an array')
    return np.asarray(tree)


def _read(path: str) -> dict:
    with open(path, 'rb') as f:
        return _Unpickler(f).load()


def load_checkpoint(path: str) -> dict:
    """{'config', 'params', 'step', 'iteration'} of a `.ckpt` (the JAX
    package's or the port's): config and params as plain dicts (params'
    leaves numpy arrays). What the sampler reads."""
    return _main_keys(_read(path))


def _main_keys(payload: dict) -> dict:
    return {
        'config': _plain_config(payload['config']),
        'params': _plain(payload['params']),
        'step': int(payload.get('step', 0)),
        'iteration': int(payload.get('iteration', 0)),
    }


def _plain_config(node):
    if isinstance(node, Mapping):
        return {k: _plain_config(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_plain_config(v) for v in node)
    return node


def _walk(node):
    """node, then depth first every tuple, list or stub field below it
    (mappings are leaves: parameter trees and hyperparameter dicts)."""
    yield node
    children = (node.fields if isinstance(node, _Stub)
                else node if isinstance(node, (tuple, list)) else ())
    for child in children:
        yield from _walk(child)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _is_scalar(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic)) and np.ndim(x) == 0


def _from_optax(opt_state) -> dict:
    """An optax chain state -> the port's layout. Found by structure, as the
    JAX package's _adam_index finds it (training/train_step.py): the
    inject_hyperparams state is the one with a hyperparameter dict holding
    the learning rate, and adam's state inside it the one of three fields
    (count, mu, nu) with mu and nu parameter trees."""
    hyper = adam = None
    for node in _walk(opt_state):
        if isinstance(node, _Stub):
            found = [f for f in node.fields
                     if isinstance(f, Mapping) and 'learning_rate' in f]
            if found:
                hyper, inner = found[0], node
                break
    if hyper is None:
        raise ValueError('no inject_hyperparams state found in opt_state')
    for node in _walk(inner):
        if (isinstance(node, _Stub) and len(node.fields) == 3
                and _is_scalar(node.fields[0])
                and all(isinstance(f, Mapping) for f in node.fields[1:])):
            adam = node
            break
    if adam is None:
        raise ValueError('no Adam state (count, mu, nu) found in opt_state')
    count, mu, nu = adam.fields
    mu = _plain(mu, 'opt_state.mu')
    return {'layout': ADAM_LAYOUT,
            'count': _tree_map(lambda _: np.asarray(count, np.int32), mu),
            'mu': mu, 'nu': _plain(nu, 'opt_state.nu'),
            'lr': float(hyper['learning_rate'])}


def read_checkpoint(path: str) -> dict:
    """Every key of a `.ckpt`, the JAX package's or the port's, as plain
    values: config and params as in load_checkpoint, opt_state in the
    port's layout (ADAM_LAYOUT; from an optax state for a JAX file),
    lt_history and lt_count numpy arrays or None, scheduler and extra
    dicts. What resuming reads."""
    payload = _read(path)
    opt = payload.get('opt_state')
    if isinstance(opt, Mapping) and opt.get('layout') == ADAM_LAYOUT:
        opt = {'layout': ADAM_LAYOUT, 'lr': float(opt['lr']),
               **{k: _plain(opt[k], f'opt_state.{k}')
                  for k in ('count', 'mu', 'nu')}}
    elif opt is not None:
        opt = _from_optax(opt)
    return {
        **_main_keys(payload),
        'opt_state': opt,
        'lt_history': _array_or_none(payload.get('lt_history')),
        'lt_count': _array_or_none(payload.get('lt_count')),
        'scheduler': _plain_config(payload.get('scheduler') or {}),
        'extra': _plain_config(payload.get('extra') or {}),
    }


def _array_or_none(x):
    return None if x is None else np.asarray(x)


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host that later in-place updates of t do not reach."""
    return t.detach().to('cpu', copy=True).numpy()


def checkpoint_payload(config: dict, model, state, scheduler_state: dict,
                       iteration: int, extra: Optional[dict] = None) -> dict:
    """The checkpoint of `model` and TrainState `state` as host copies
    (numpy arrays and builtins only). A training step updates the
    parameters and the Adam moments in place, so this snapshot is taken
    before the next step starts; only pickling it may overlap training."""
    opt = state.optimizer
    count, mu, nu = {}, {}, {}
    for name, p in opt.params.items():
        st = opt.adam.state.get(p, {})
        if st:
            count[name], mu[name], nu[name] = (
                torch.as_tensor(st['step']), st['exp_avg'], st['exp_avg_sq'])
        else:       # torch Adam's state before its first step
            count[name] = torch.zeros(())
            mu[name] = nu[name] = torch.zeros_like(p)
    opt_state = {'layout': ADAM_LAYOUT, 'lr': opt.lr,
                 'count': _tree_map(lambda c: c.astype(np.int32),
                                    state_dict_to_flax(count)),
                 'mu': state_dict_to_flax(mu), 'nu': state_dict_to_flax(nu)}
    return {
        'config': _plain_config(config),
        'params': state_dict_to_flax(model.denoiser.state_dict()),
        'opt_state': opt_state,
        'step': int(state.step),
        'lt_history': _host(state.lt_history),
        'lt_count': _host(state.lt_count),
        'scheduler': dict(scheduler_state),
        'iteration': int(iteration),
        'extra': dict(extra or {}),
    }


def write_checkpoint(path: str, payload: dict) -> None:
    """Pickle to path + '.tmp', then rename over path, so a reader never
    sees a partial file."""
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)


def save_checkpoint(path: str, config: dict, model, state,
                    scheduler_state: dict, iteration: int,
                    extra: Optional[dict] = None) -> None:
    write_checkpoint(path, checkpoint_payload(
        config, model, state, scheduler_state, iteration, extra))


def restore_train_state(ckpt: dict, model, state):
    """Load read_checkpoint's `ckpt` into `model` (parameters, strictly)
    and TrainState `state` (Adam's per-parameter step, exp_avg and
    exp_avg_sq from count, mu and nu, the learning rate, the step count and
    the Lt buffers); returns state. torch Adam's step, exp_avg and
    exp_avg_sq are optax adam's count, mu and nu (the same update,
    tests/test_torch_train.py::test_optimizer_matches_optax)."""
    load_flax_params(model.denoiser, ckpt['params'])
    opt, saved = state.optimizer, ckpt['opt_state']
    count, mu, nu = (flax_to_state_dict(saved[k])
                     for k in ('count', 'mu', 'nu'))
    sd = opt.adam.state_dict()
    sd['state'] = {
        i: {'step': torch.tensor(float(count[name]), dtype=torch.float32),
            'exp_avg': mu[name], 'exp_avg_sq': nu[name]}
        for i, name in enumerate(opt.params)}
    for group in sd['param_groups']:
        group['lr'] = float(saved['lr'])
    opt.adam.load_state_dict(sd)
    state.step = int(ckpt['step'])
    dev = state.lt_history.device
    if ckpt.get('lt_history') is not None:
        state.lt_history = torch.as_tensor(ckpt['lt_history'], device=dev)
        state.lt_count = torch.as_tensor(ckpt['lt_count'], device=dev)
    return state


def load_model_from_checkpoint(path: str, num_classes: Optional[int] = None,
                               device: DeviceLike = None,
                               overrides: Optional[dict] = None):
    """The port's DecompDiffModel with a JAX checkpoint's weights.

    Builds DecompDiffModel.create(config['model'] updated with `overrides`)
    on `device` (CUDA unless given) with num_classes from the checkpoint's
    ligand_atom_mode unless given, and loads the parameters strictly.
    Returns (model, checkpoint dict)."""
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    ckpt = load_checkpoint(path)
    config = ckpt['config']
    if num_classes is None:
        transform = config.get('data', {}).get('transform', {})
        num_classes = atom_class_count(
            transform.get('ligand_atom_mode', 'basic'))
    model = DecompDiffModel.create(dict(config['model'], **(overrides or {})),
                                   num_classes, device=device)
    load_flax_params(model.denoiser, ckpt['params'])
    return model, ckpt
