"""Convert a reference (bytedance/DecompDiff, PyTorch) checkpoint into the
flax parameter tree the port loads (port of
decompdiff_tpu/utils/convert_checkpoint.py; the mapping is the same numpy
code, so both packages give the same tree, leaf for leaf).

The reference stores {config, model: state_dict, ...}
(ref scripts/train_diffusion_decomp.py:293-300). The denoiser math here is
identical but the first linear of every edge/triplet attention MLP is stored
factorized (per-edge-feature / per-dst / per-src blocks), so torch weight
matrices are split column-wise:

  * NodeUpdateLayer kv: W [H, Fe+2H] over [edge_feat, h_i, h_j] (ref
    models/encoders/uni_transformer_edge.py:48-54) ->
    {m}_e_kernel = W[:, :Fe]^T, {m}_i = W[:, Fe:Fe+H]^T, {m}_j = W[:, Fe+H:]^T
  * BondUpdateLayer kv: W over [h_bond_kj, r_kj, r_ji, a_feat, h_k, h_j]
    (ref :148) -> kj block = cols [0:H+20] ++ [H+53:2H+53], ij = r_ji cols,
    a = angular cols, j = h_j cols
  * torch Linear weights are [out, in] -> transposed; LayerNorm weight ->
    scale. Diffusion schedule buffers are skipped (recomputed from config).

Both refine-net topologies are mapped: `uni_o2_bond` (released) and
`uni_o2` (ref uni_transformer.py; its factorized kv swaps the
[edge_type | outer] column blocks into our [outer | edge_type] row order,
see _split_o2_kv), plus the add_prior_node embedding. Works on plain numpy
state dicts; `load_reference_checkpoint` reads torch .pt files without
running pickled code: it resolves only torch's tensor rebuilders, the
storage classes, collections.OrderedDict and easydict.EasyDict (read as the
stand-in EasyDict below), and refuses every other global.

utils/params.py `load_flax_params` loads the tree into the port's modules.
"""

from __future__ import annotations

import collections
import pickle
import types
from typing import Dict

import numpy as np
import torch


def _t(w):
    return np.asarray(w, np.float32).T


def _mlp(sd, prefix):
    """Torch MLP(net.0 Linear, net.1 LN, net.3 Linear) -> flax MLP tree."""
    return {
        'Dense_0': {'kernel': _t(sd[f'{prefix}.net.0.weight']),
                    'bias': np.asarray(sd[f'{prefix}.net.0.bias'], np.float32)},
        'LayerNorm_0': {'scale': np.asarray(sd[f'{prefix}.net.1.weight'], np.float32),
                        'bias': np.asarray(sd[f'{prefix}.net.1.bias'], np.float32)},
        'Dense_1': {'kernel': _t(sd[f'{prefix}.net.3.weight']),
                    'bias': np.asarray(sd[f'{prefix}.net.3.bias'], np.float32)},
    }


def _linear(sd, prefix):
    return {'kernel': _t(sd[f'{prefix}.weight']),
            'bias': np.asarray(sd[f'{prefix}.bias'], np.float32)}


def _split_edge_kv(sd, prefix, name, feat_dim, hidden):
    """NodeUpdateLayer/PosUpdateLayer kv MLP -> factorized blocks."""
    w0 = np.asarray(sd[f'{prefix}.net.0.weight'], np.float32)  # [H, Fe+2H]
    if w0.shape[1] != feat_dim + 2 * hidden:
        raise ValueError(
            f'{prefix}: kv width {w0.shape[1]} != edge_feat {feat_dim} + '
            f'2*hidden {hidden} — checkpoint trained with a different '
            'num_r_gaussian/edge_feat_dim; slicing would silently scramble')
    out = {
        f'{name}_e_kernel': w0[:, :feat_dim].T,
        f'{name}_e_bias': np.asarray(sd[f'{prefix}.net.0.bias'], np.float32),
        f'{name}_i_kernel': w0[:, feat_dim:feat_dim + hidden].T,
        f'{name}_j_kernel': w0[:, feat_dim + hidden:].T,
        f'{name}_ln_scale': np.asarray(sd[f'{prefix}.net.1.weight'], np.float32),
        f'{name}_ln_bias': np.asarray(sd[f'{prefix}.net.1.bias'], np.float32),
        f'{name}_out_kernel': _t(sd[f'{prefix}.net.3.weight']),
        f'{name}_out_bias': np.asarray(sd[f'{prefix}.net.3.bias'], np.float32),
    }
    return out


def _split_bond_kv(sd, prefix, name, hidden, include_h_node, rbf=20, ang=13):
    """BondUpdateLayer kv MLP -> kj / ij / a / j blocks."""
    w0 = np.asarray(sd[f'{prefix}.net.0.weight'], np.float32)
    H, R, A = hidden, rbf, ang
    expect = (3 * H if include_h_node else 2 * H) + 2 * R + A
    if w0.shape[1] != expect:
        raise ValueError(
            f'{prefix}: kv width {w0.shape[1]} != {expect} '
            f'(hidden {H}, rbf {R}, ang {A}, include_h_node '
            f'{include_h_node}) — slicing would silently scramble')
    c_bond, c_rkj, c_rji, c_a = 0, H, H + R, H + 2 * R
    c_hk, c_hj = H + 2 * R + A, 2 * H + 2 * R + A
    if include_h_node:
        kj = np.concatenate([w0[:, c_bond:c_rji], w0[:, c_hk:c_hj]], axis=1)
        j_block = {'kernel': w0[:, c_hj:c_hj + H].T}
    else:
        kj = w0[:, c_bond:c_rji]
        j_block = None
    out = {
        f'{name}_kj': {'kernel': kj.T},
        f'{name}_ij': {'kernel': w0[:, c_rji:c_a].T},
        f'{name}_a_kernel': w0[:, c_a:c_a + A].T,
        f'{name}_a_bias': np.asarray(sd[f'{prefix}.net.0.bias'], np.float32),
        f'{name}_ln_scale': np.asarray(sd[f'{prefix}.net.1.weight'], np.float32),
        f'{name}_ln_bias': np.asarray(sd[f'{prefix}.net.1.bias'], np.float32),
        f'{name}_out_kernel': _t(sd[f'{prefix}.net.3.weight']),
        f'{name}_out_bias': np.asarray(sd[f'{prefix}.net.3.bias'], np.float32),
    }
    if j_block is not None:
        out[f'{name}_j'] = j_block
    return out


def _split_dense_bond_kv(sd, prefix, name, hidden):
    """Bond-stream kv MLP over [h_bond, h_i, h_j] -> raw param blocks."""
    w0 = np.asarray(sd[f'{prefix}.net.0.weight'], np.float32)
    if w0.shape[1] != 3 * hidden:
        raise ValueError(
            f'{prefix}: kv width {w0.shape[1]} != 3*hidden {hidden}')
    return {
        f'{name}_e_kernel': w0[:, :hidden].T,
        f'{name}_e_bias': np.asarray(sd[f'{prefix}.net.0.bias'], np.float32),
        f'{name}_i_kernel': w0[:, hidden:2 * hidden].T,
        f'{name}_j_kernel': w0[:, 2 * hidden:].T,
        f'{name}_ln_scale': np.asarray(sd[f'{prefix}.net.1.weight'], np.float32),
        f'{name}_ln_bias': np.asarray(sd[f'{prefix}.net.1.bias'], np.float32),
        f'{name}_out_kernel': _t(sd[f'{prefix}.net.3.weight']),
        f'{name}_out_bias': np.asarray(sd[f'{prefix}.net.3.bias'], np.float32),
    }


def _split_o2_kv(sd, prefix, name, n_etypes, hidden):
    """uni_o2 Base{X2H,H2X}AttLayer kv MLP -> factorized blocks. The torch
    first linear runs over [edge_type(F) | outer(type, rbf)(F*20) | h_i | h_j]
    (ref uni_transformer.py:53-56,121-123); our row layout is
    [outer | edge_type] (models/uni_transformer._edge_feat_o2), so the type
    and outer column blocks swap."""
    w0 = np.asarray(sd[f'{prefix}.net.0.weight'], np.float32)
    fe, rfe = n_etypes, n_etypes * 20
    if w0.shape[1] != fe + rfe + 2 * hidden:
        raise ValueError(
            f'{prefix}: kv width {w0.shape[1]} != {fe + rfe + 2 * hidden} '
            '(edge types + outer + 2*hidden) — slicing would silently '
            'scramble')
    we = np.concatenate([w0[:, fe:fe + rfe], w0[:, :fe]], axis=1)
    return {
        f'{name}_e_kernel': we.T,
        f'{name}_e_bias': np.asarray(sd[f'{prefix}.net.0.bias'], np.float32),
        f'{name}_i_kernel': w0[:, fe + rfe:fe + rfe + hidden].T,
        f'{name}_j_kernel': w0[:, fe + rfe + hidden:].T,
        f'{name}_ln_scale': np.asarray(sd[f'{prefix}.net.1.weight'],
                                       np.float32),
        f'{name}_ln_bias': np.asarray(sd[f'{prefix}.net.1.bias'], np.float32),
        f'{name}_out_kernel': _t(sd[f'{prefix}.net.3.weight']),
        f'{name}_out_bias': np.asarray(sd[f'{prefix}.net.3.bias'],
                                       np.float32),
    }


def _convert_uni_o2(sd: Dict[str, np.ndarray], config: dict) -> dict:
    """model_type='uni_o2' refine net (ref uni_transformer.py:217-332; the
    dead init_h_emb_layer params are skipped)."""
    hidden = int(config['hidden_dim'])
    ew_t = config.get('ew_net_type', 'r')
    x2h_out_fc = bool(config.get('x2h_out_fc', True))
    refine: dict = {}
    if ew_t == 'global':
        refine['edge_pred'] = _mlp(sd, 'refine_net.edge_pred_layer')
    for l in range(int(config['num_layers'])):
        base = f'refine_net.base_block.{l}'
        layer: dict = {}
        for i in range(int(config.get('num_x2h', 1))):
            pre = f'{base}.x2h_layers.{i}'
            x2h: dict = {}
            x2h.update(_split_o2_kv(sd, f'{pre}.hk_func', 'hk', 4, hidden))
            x2h.update(_split_o2_kv(sd, f'{pre}.hv_func', 'hv', 4, hidden))
            x2h['hq'] = _mlp(sd, f'{pre}.hq_func')
            if x2h_out_fc:
                x2h['node_output'] = _mlp(sd, f'{pre}.node_output')
            if ew_t == 'r':
                x2h['hk_ew_kernel'] = _t(sd[f'{pre}.ew_net.0.weight'])
                x2h['hk_ew_bias'] = np.asarray(sd[f'{pre}.ew_net.0.bias'],
                                               np.float32)
            elif ew_t == 'm':
                x2h['ew_kernel'] = _t(sd[f'{pre}.ew_net.0.weight'])
                x2h['ew_bias'] = np.asarray(sd[f'{pre}.ew_net.0.bias'],
                                            np.float32)
            layer[f'x2h_{i}'] = x2h
        for i in range(int(config.get('num_h2x', 1))):
            pre = f'{base}.h2x_layers.{i}'
            h2x: dict = {}
            h2x.update(_split_o2_kv(sd, f'{pre}.xk_func', 'xk', 4, hidden))
            h2x.update(_split_o2_kv(sd, f'{pre}.xv_func', 'xv', 4, hidden))
            h2x['xq'] = _mlp(sd, f'{pre}.xq_func')
            if ew_t == 'r':
                h2x['xk_ew_kernel'] = _t(sd[f'{pre}.ew_net.0.weight'])
                h2x['xk_ew_bias'] = np.asarray(sd[f'{pre}.ew_net.0.bias'],
                                               np.float32)
            layer[f'h2x_{i}'] = h2x
        refine[f'layer_{l}'] = layer
    return refine


def convert_reference_state_dict(sd: Dict[str, np.ndarray],
                                 config: dict) -> dict:
    """Reference DecompScorePosNet3D state_dict -> flax params tree
    ({'params': ...} ready for DecompDiffModel.apply). Maps both released
    refine nets: uni_o2_bond and uni_o2."""
    hidden = int(config['hidden_dim'])
    edge_fe = int(config.get('edge_feat_dim', 4)) * 21
    num_layers = int(config['num_layers'])
    include_h_node = bool(config.get('h_node_in_bond_net', False))
    x2h_out_fc = bool(config.get('x2h_out_fc', True))
    model_type = config.get('model_type', 'uni_o2_bond')

    p: dict = {
        'protein_atom_emb': _linear(sd, 'protein_atom_emb'),
        'ligand_atom_emb': _linear(sd, 'ligand_atom_emb'),
        'v_inf_0': _linear(sd, 'v_inference.0'),
        'v_inf_1': _linear(sd, 'v_inference.2'),
    }
    if 'ligand_bond_emb.weight' in sd:
        p['ligand_bond_emb'] = _linear(sd, 'ligand_bond_emb')
    if 'prior_atom_emb.weight' in sd:
        p['prior_atom_emb'] = _linear(sd, 'prior_atom_emb')
    if f'bond_inference.0.weight' in sd:
        p['bond_inf_0'] = _linear(sd, 'bond_inference.0')
        p['bond_inf_1'] = _linear(sd, 'bond_inference.2')

    if model_type == 'uni_o2':
        p['refine_net'] = _convert_uni_o2(sd, config)
        return {'params': p}
    assert model_type == 'uni_o2_bond', model_type

    refine: dict = {}
    if 'refine_net.edge_pred_layer.net.0.weight' in sd:
        refine['edge_pred'] = _mlp(sd, 'refine_net.edge_pred_layer')

    for l in range(num_layers):
        base = f'refine_net.base_block.{l}'
        layer: dict = {'lin_node': _linear(sd, f'{base}.lin_node')}

        nle: dict = {}
        nle.update(_split_edge_kv(sd, f'{base}.node_layer_with_edge.hk_func',
                                  'hk', edge_fe, hidden))
        nle.update(_split_edge_kv(sd, f'{base}.node_layer_with_edge.hv_func',
                                  'hv', edge_fe, hidden))
        nle['hq'] = _mlp(sd, f'{base}.node_layer_with_edge.hq_func')
        if x2h_out_fc:
            nle['node_output'] = _mlp(
                sd, f'{base}.node_layer_with_edge.node_output')
        layer['node_layer_with_edge'] = nle

        nlb: dict = {}
        for m in ('hk', 'hv'):
            nlb.update(_split_dense_bond_kv(
                sd, f'{base}.node_layer_with_bond.{m}_func', m, hidden))
        nlb['hq'] = _mlp(sd, f'{base}.node_layer_with_bond.hq_func')
        if x2h_out_fc:
            nlb['node_output'] = _mlp(
                sd, f'{base}.node_layer_with_bond.node_output')
        layer['node_layer_with_bond'] = nlb

        bl: dict = {}
        bl.update(_split_bond_kv(sd, f'{base}.bond_layer.hk_func', 'hk',
                                 hidden, include_h_node))
        bl.update(_split_bond_kv(sd, f'{base}.bond_layer.hv_func', 'hv',
                                 hidden, include_h_node))
        bl['hq'] = _mlp(sd, f'{base}.bond_layer.hq_func')
        layer['bond_layer'] = bl

        ple: dict = {}
        ple.update(_split_edge_kv(sd, f'{base}.pos_layer_with_edge.xk_func',
                                  'xk', edge_fe, hidden))
        ple.update(_split_edge_kv(sd, f'{base}.pos_layer_with_edge.xv_func',
                                  'xv', edge_fe, hidden))
        ple['xq'] = _mlp(sd, f'{base}.pos_layer_with_edge.xq_func')
        layer['pos_layer_with_edge'] = ple

        plb: dict = {}
        for m in ('xk', 'xv'):
            plb.update(_split_dense_bond_kv(
                sd, f'{base}.pos_layer_with_bond.{m}_func', m, hidden))
        plb['xq'] = _mlp(sd, f'{base}.pos_layer_with_bond.xq_func')
        layer['pos_layer_with_bond'] = plb

        refine[f'layer_{l}'] = layer

    p['refine_net'] = refine
    return {'params': p}


class EasyDict(dict):
    """Stands in for easydict.EasyDict, the class of a reference
    checkpoint's config (ref utils/misc.py load_config): a dict whose items
    are also its attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


def plain_dict(cfg):
    """The config with every mapping a builtin dict and every sequence a
    list (an EasyDict pickled into a converted checkpoint would make it
    unreadable where easydict is not installed)."""
    if isinstance(cfg, dict):
        return {k: plain_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [plain_dict(v) for v in cfg]
    return cfg


# the globals a reference checkpoint may name; torch.load resolves the
# storage classes itself
_ALLOWED = {
    ('torch._utils', '_rebuild_tensor_v2'): torch._utils._rebuild_tensor_v2,
    ('torch._utils', '_rebuild_tensor_v3'): torch._utils._rebuild_tensor_v3,
    ('torch._utils', '_rebuild_parameter'): torch._utils._rebuild_parameter,
    ('collections', 'OrderedDict'): collections.OrderedDict,
    ('easydict', 'EasyDict'): EasyDict,
}


class _ReferenceUnpickler(pickle.Unpickler):
    """Resolves the globals of _ALLOWED and torch's dtypes; refuses any
    other."""

    def find_class(self, module, name):
        found = _ALLOWED.get((module, name))
        if found is None and module == 'torch' and isinstance(
                getattr(torch, name, None), torch.dtype):
            found = getattr(torch, name)
        if found is None:
            raise pickle.UnpicklingError(
                f'a reference checkpoint names {module}.{name}, which the '
                'reader does not resolve')
        return found


def _reference_pickle_module():
    """A module for torch.load's pickle_module: its Unpickler and load."""
    module = types.ModuleType('reference_pickle')
    module.Unpickler = _ReferenceUnpickler
    module.load = lambda f, **kw: _ReferenceUnpickler(f, **kw).load()
    return module


def read_reference_checkpoint(path: str) -> dict:
    """The unpickled reference .pt (tensors on the CPU; the config as
    EasyDict stand-ins), through the restricted unpickler."""
    return torch.load(path, map_location='cpu', weights_only=False,
                      pickle_module=_reference_pickle_module())


def load_reference_checkpoint(path: str):
    """Load a reference .pt checkpoint; returns (numpy state dict, plain
    model config dict)."""
    ckpt = read_reference_checkpoint(path)
    sd = {k: v.numpy() for k, v in ckpt['model'].items()}
    return sd, plain_dict(ckpt['config']['model'])
