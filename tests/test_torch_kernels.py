"""Each kernel mode of the port, through its module with use_kernels on (on
the CPU the wrapper runs the kernel's plain version), against the JAX
package's Pallas kernel in interpret mode and its dense path, with shared
parameters loaded through the param bridge.

Modes: edge node/pos with 4 and 6 edge types, bond node/pos, triplet with
include_h_node True and False; every case has ragged masks and fully-masked
rows. Tolerance rtol 2e-4 / atol 2e-5, that of the JAX package's own
Pallas-vs-dense tests (tests/test_pallas_{edge,bond,triplet}.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu.data.batch import make_bond_mask
from decompdiff_tpu.models import uni_transformer_bond as jutb
from decompdiff_tpu.models.common import safe_norm as jax_safe_norm
from decompdiff_tpu.ops.knn import knn_neighbors
from decompdiff_tpu_torch.models import uni_transformer_bond as tutb
from decompdiff_tpu_torch.ops import bond_attention as bond_ops
from decompdiff_tpu_torch.ops import edge_attention as edge_ops
from decompdiff_tpu_torch.ops import triplet_attention as triplet_ops
from decompdiff_tpu_torch.ops.common import Branch
from decompdiff_tpu_torch.utils.params import load_flax_params

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-5)
H, HEADS = 32, 4


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _check(port_out, *jax_outs):
    got = port_out.detach().numpy()
    for want in jax_outs:
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _load(module, params):
    load_flax_params(module, jax.tree.map(np.asarray, params))
    return module.requires_grad_(False)


# --------------------------------------------------------------------------
# edge attention
# --------------------------------------------------------------------------

def _jax_edge_data(x, nbr_idx, nbr_mask, mask_ligand, group_idx, pallas):
    """The EdgeData UniTransformerBond builds for each path (as
    tests/test_pallas_edge.py builds it)."""
    B, N, K = nbr_idx.shape
    x = jnp.asarray(x)
    mask_ligand = jnp.asarray(mask_ligand)
    if pallas:
        ml = mask_ligand.astype(jnp.float32)
        if group_idx is not None:
            g = jnp.asarray(group_idx, jnp.float32)
            gsrc = jutb.gather_nodes(g[..., None], nbr_idx).reshape(B, N * K, 1)
        else:
            g = jnp.zeros_like(ml)
            gsrc = jnp.zeros((B, N * K, 1), jnp.float32)
        return jutb.EdgeData(nbr_idx, nbr_mask, x4=jutb._pad4(x),
                             idx_flat=nbr_idx.reshape(B, N * K, 1),
                             mld=jnp.stack([ml, g], axis=-1), gsrc_flat=gsrc)
    rel_x = x[:, :, None, :] - jutb.gather_nodes(x, nbr_idx)
    lig_src = jutb.gather_nodes(mask_ligand[..., None].astype(jnp.float32),
                                nbr_idx)[..., 0] > 0.5
    lig_dst = mask_ligand[:, :, None]
    type_id = jnp.where(lig_src & lig_dst, 0,
                        jnp.where(lig_src & ~lig_dst, 1,
                                  jnp.where(~lig_src & lig_dst, 2, 3)))
    edge_type = jax.nn.one_hot(type_id, 4, dtype=jnp.float32)
    if group_idx is not None:
        g = jnp.asarray(group_idx, jnp.float32)
        same = jutb.gather_nodes(g[..., None], nbr_idx)[..., 0] == g[:, :, None]
        edge_type = jnp.concatenate(
            [edge_type, jax.nn.one_hot(same.astype(jnp.int32), 2)], axis=-1)
    return jutb.EdgeData(nbr_idx, nbr_mask, rel_x=rel_x,
                         dist=jax_safe_norm(rel_x, axis=-1),
                         edge_type=edge_type)


def _edge_inputs(group, seed, B=2, N=16, Np=10, K=4):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, H)).astype(np.float32)
    x = (rng.normal(size=(B, N, 3)) * 3).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0, 12:] = False                       # padded slots: masked rows
    nbr_idx, nbr_mask = knn_neighbors(jnp.asarray(x), jnp.asarray(mask), K)
    mask_ligand = (np.arange(N)[None, :] >= Np) & mask
    group_idx = rng.integers(0, 3, size=(B, N)) if group else None
    e_w = rng.random((B, N, K, 1)).astype(np.float32)
    ed_dense = _jax_edge_data(x, nbr_idx, nbr_mask, mask_ligand, group_idx,
                              False)
    ed_pallas = _jax_edge_data(x, nbr_idx, nbr_mask, mask_ligand, group_idx,
                               True)
    graph = tutb.EdgeGraph(
        _t(nbr_idx, torch.int32), _t(nbr_mask, torch.float32),
        _t(mask_ligand, torch.float32),
        None if group_idx is None else _t(group_idx, torch.float32))
    return dict(h=h, x=x, e_w=e_w, Np=Np, ed_dense=ed_dense,
                ed_pallas=ed_pallas, graph=graph,
                n_etypes=6 if group else 4)


@pytest.mark.parametrize('group', [False, True], ids=['4types', '6types'])
@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_edge_kernel_modes(pos_mode, group):
    c = _edge_inputs(group, seed=3 + 2 * pos_mode + group)
    kw = dict(use_pallas=False, num_protein=c['Np'], n_etypes=c['n_etypes'])
    if pos_mode:
        jmod = jutb.PosEdgeAttention(H, HEADS, **kw)
        jfused = jutb.PosEdgeAttention(H, HEADS, **dict(kw, use_pallas=True))
        tmod = tutb.PosEdgeAttention(H, HEADS, c['n_etypes'],
                                     use_kernels=True)
    else:
        jmod = jutb.NodeEdgeAttention(H, HEADS, out_fc=False, **kw)
        jfused = jutb.NodeEdgeAttention(H, HEADS, out_fc=False,
                                        **dict(kw, use_pallas=True))
        tmod = tutb.NodeEdgeAttention(H, HEADS, c['n_etypes'], out_fc=False,
                                      use_kernels=True)
    params = jmod.init(jax.random.PRNGKey(0), c['h'], c['ed_dense'], c['e_w'])
    dense = jmod.apply(params, c['h'], c['ed_dense'], c['e_w'])
    pallas = jfused.apply(params, c['h'], c['ed_pallas'], c['e_w'])
    _load(tmod, params)
    launches = edge_ops.edge_attention.launches
    got = tmod(_t(c['h']), _t(c['x']), c['graph'], _t(c['e_w'][..., 0]))
    assert edge_ops.edge_attention.launches == launches  # CPU: no launch
    assert got.shape == ((2, 16, 3) if pos_mode else (2, 16, H))
    _check(got, dense, pallas)
    if not pos_mode:                     # padded dst nodes: exactly zero
        assert float(got[0, 12:].abs().max()) == 0.0


def test_node_edge_out_fc_matches_dense():
    c = _edge_inputs(False, seed=11)
    jmod = jutb.NodeEdgeAttention(H, HEADS, out_fc=True, num_protein=c['Np'])
    params = jmod.init(jax.random.PRNGKey(1), c['h'], c['ed_dense'], c['e_w'])
    tmod = _load(tutb.NodeEdgeAttention(H, HEADS, 4, out_fc=True,
                                        use_kernels=True), params)
    _check(tmod(_t(c['h']), _t(c['x']), c['graph'], _t(c['e_w'][..., 0])),
           jmod.apply(params, c['h'], c['ed_dense'], c['e_w']))


# --------------------------------------------------------------------------
# bond attention
# --------------------------------------------------------------------------

def _bond_inputs(seed, B=2, Nl=8):
    rng = np.random.default_rng(seed)
    h_lig = rng.normal(size=(B, Nl, H)).astype(np.float32)
    h_bond = rng.normal(size=(B, Nl, Nl, H)).astype(np.float32)
    x_lig = (rng.normal(size=(B, Nl, 3)) * 2).astype(np.float32)
    lig_mask = np.ones((B, Nl), bool)
    lig_mask[0, 6:] = False                    # ragged: rows 6, 7 masked
    bond_mask = make_bond_mask(lig_mask)
    return h_lig, h_bond, x_lig, bond_mask


@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_kernel_modes(pos_mode):
    h_lig, h_bond, x_lig, bond_mask = _bond_inputs(seed=4 + pos_mode)
    tbm = _t(bond_mask, torch.float32)
    if pos_mode:
        rel = x_lig[:, :, None, :] - x_lig[:, None, :, :]
        args = (h_lig, rel, h_bond, bond_mask)
        jmod = jutb.PosBondAttention(H, HEADS)
        jfused = jutb.PosBondAttention(H, HEADS, use_pallas=True)
        params = jmod.init(jax.random.PRNGKey(0), *args)
        tmod = _load(tutb.PosBondAttention(H, HEADS, use_kernels=True),
                     params)
        got = tmod(_t(h_lig), _t(x_lig), _t(h_bond), tbm)
    else:
        args = (h_lig, h_bond, bond_mask)
        jmod = jutb.NodeBondAttention(H, HEADS, out_fc=False)
        jfused = jutb.NodeBondAttention(H, HEADS, out_fc=False,
                                        use_pallas=True)
        params = jmod.init(jax.random.PRNGKey(0), *args)
        tmod = _load(tutb.NodeBondAttention(H, HEADS, out_fc=False,
                                            use_kernels=True), params)
        got = tmod(_t(h_lig), _t(h_bond), tbm)
        assert float(got[0, 6:].abs().max()) == 0.0    # masked rows: zero
    launches = bond_ops.bond_attention.launches
    _check(got, jmod.apply(params, *args), jfused.apply(params, *args))
    assert bond_ops.bond_attention.launches == launches


def test_node_bond_full_context_scatter():
    """With h_full the message is scattered into the full context before
    node_output, so protein rows get node_output([0, h]) (ref :324-331)."""
    h_lig, h_bond, _, bond_mask = _bond_inputs(seed=9)
    Np = 5
    h_full = np.concatenate(
        [np.random.default_rng(1).normal(size=(2, Np, H)).astype(np.float32),
         h_lig], axis=1)
    jmod = jutb.NodeBondAttention(H, HEADS, out_fc=True)
    params = jmod.init(jax.random.PRNGKey(2), h_lig, h_bond, bond_mask,
                       h_full=h_full, num_protein=Np)
    tmod = _load(tutb.NodeBondAttention(H, HEADS, out_fc=True,
                                        use_kernels=True), params)
    got = tmod(_t(h_lig), _t(h_bond), _t(bond_mask, torch.float32),
               h_full=_t(h_full), num_protein=Np)
    assert got.shape == (2, Np + 8, H)
    _check(got, jmod.apply(params, h_lig, h_bond, bond_mask, h_full=h_full,
                           num_protein=Np))


# --------------------------------------------------------------------------
# triplet attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize('include_h_node', [True, False])
def test_triplet_kernel(include_h_node):
    h_lig, h_bond, x_lig, bond_mask = _bond_inputs(seed=0)
    args = (h_lig, h_bond, x_lig, bond_mask)
    jmod = jutb.BondTripletAttention(H, HEADS, include_h_node=include_h_node)
    jfused = jutb.BondTripletAttention(H, HEADS, include_h_node=include_h_node,
                                       use_pallas=True)
    params = jmod.init(jax.random.PRNGKey(0), *args)
    tmod = _load(tutb.BondTripletAttention(
        H, HEADS, include_h_node=include_h_node, use_kernels=True), params)
    launches = triplet_ops.triplet_attention.launches
    got = tmod(_t(h_lig), _t(h_bond), _t(x_lig),
               _t(bond_mask, torch.float32))
    assert triplet_ops.triplet_attention.launches == launches
    _check(got, jmod.apply(params, *args), jfused.apply(params, *args))
    assert float(got[0, 6:].abs().max()) == 0.0     # masked (j -> i) rows


# --------------------------------------------------------------------------
# wrapper dispatch
# --------------------------------------------------------------------------

def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version for CPU tensors only; tensors on any
    other non-CUDA device are refused rather than moved."""
    B, Nl = 1, 4
    meta = dict(device='meta')
    q = torch.empty(B, Nl, H, **meta)
    br = Branch(*(torch.empty(1, **meta) for _ in range(7)))
    with pytest.raises(ValueError, match='unsupported device'):
        bond_ops.bond_attention(torch.empty(B, Nl, Nl, H, **meta), None,
                                torch.empty(B, Nl, Nl, **meta), q, br, br,
                                n_heads=HEADS, pos_mode=False)
