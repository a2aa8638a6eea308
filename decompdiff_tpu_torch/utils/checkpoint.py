"""Reading the JAX package's checkpoints (port of the reading half of
decompdiff_tpu/utils/checkpoint.py).

A `.ckpt` is a pickle of {config, params, opt_state, step, ..., iteration}
(decompdiff_tpu/utils/checkpoint.py save_checkpoint). Its config and params
are plain dicts of numpy arrays, but its opt_state holds optax's state
classes. `load_checkpoint` reads it with an unpickler that resolves only the
classes of numpy, builtins and collections; any other class (optax's, flax's)
becomes an inert stub, so jax, flax and optax are never imported, and the
optimizer state is dropped. Saving and resuming wait for ROADMAP item B2.
"""

from __future__ import annotations

import pickle
from typing import Mapping, Optional

import numpy as np

from decompdiff_tpu_torch.constants import atom_class_count
from decompdiff_tpu_torch.device import DeviceLike
from decompdiff_tpu_torch.utils.params import load_flax_params

_RESOLVED = ('numpy', 'builtins', 'collections')
# flax's FrozenDict pickles as FrozenDict(plain dict): read it as that dict
_AS_DICT = {('flax.core.frozen_dict', 'FrozenDict')}


class _Stub(dict):
    """Stands in for a class outside numpy, builtins and collections. It
    takes whatever the pickle builds it from and keeps only dict items (a
    dict subclass such as a config class keeps its contents)."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

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


def load_checkpoint(path: str) -> dict:
    """{'config', 'params', 'step', 'iteration'} of a JAX `.ckpt`: config
    and params as plain dicts (params' leaves numpy arrays)."""
    with open(path, 'rb') as f:
        payload = _Unpickler(f).load()
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
