"""The parameter bridge between the JAX package and the port.

A module's state_dict key is the flax parameter path joined with '.' (for
example `refine_net.layer_0.bond_layer.hk_a_kernel`), and every tensor keeps
the flax layout (Dense kernels are [in, out]), so no transpose is needed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def flax_to_state_dict(tree: Mapping) -> dict:
    """A flax parameter tree (nested dicts of arrays, with or without the
    top-level 'params' collection) -> {dotted path: float32 tensor}."""
    if set(tree) == {'params'}:
        tree = tree['params']
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            path = f'{prefix}.{key}' if prefix else str(key)
            if isinstance(value, Mapping):
                walk(value, path)
            else:
                out[path] = torch.as_tensor(np.array(value, np.float32))

    walk(tree, '')
    return out


def state_dict_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of flax_to_state_dict: {dotted path: tensor} -> a flax
    parameter tree {'params': nested dicts of float32 numpy arrays}."""
    tree: dict = {}
    for path, value in state.items():
        *parents, leaf = path.split('.')
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value.detach().cpu().numpy().astype(np.float32)
    return {'params': tree}


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy a flax parameter tree into `module`, strictly: every leaf is used
    once, every parameter is set, and every shape must match."""
    state = flax_to_state_dict(tree)
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f'parameter trees differ: missing {missing}, '
                       f'unexpected {extra}')
    for name, param in own.items():
        value = state[name]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f'{name}: shape {tuple(value.shape)} does not '
                             f'match {tuple(param.shape)}')
        with torch.no_grad():
            param.copy_(value)


def init_params_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter as flax would initialize it: `*kernel` with
    lecun_normal (truncated normal, variance 1/fan_in), `*scale` with ones
    and `*bias` with zeros. Parameters are visited in sorted name order, so
    one generator state gives one set of weights."""
    stddev = 1.0 / 0.87962566103423978  # std of a unit normal cut at +-2
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            if name.endswith('kernel'):
                std = stddev / np.sqrt(p.shape[0])
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif name.endswith('scale'):
                p.fill_(1.0)
            elif name.endswith('bias'):
                p.zero_()
            else:
                raise ValueError(f'no initializer for parameter {name}')
