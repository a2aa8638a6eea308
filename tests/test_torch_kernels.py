"""Each kernel mode of the port, through its module with use_kernels on (on
the CPU the wrapper runs the kernel's plain version), against the JAX
package's Pallas kernel in interpret mode and its dense path, with shared
parameters loaded through the param bridge.

Modes: edge node/pos with 4 and 6 edge types, each also with gather_bf16
(the sources read from the JAX kernels' bf16 node table), edge node mode
with the m-gate (through the uni_o2 X2HAttention modules), bond node/pos,
triplet with include_h_node True and False; every case has ragged masks and
fully-masked rows. Tolerance rtol 2e-4 / atol 2e-5, that of the JAX package's own
Pallas-vs-dense tests (tests/test_pallas_{edge,bond,triplet}.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu.data.batch import make_bond_mask
from decompdiff_tpu.models import uni_transformer as jo2
from decompdiff_tpu.models import uni_transformer_bond as jutb
from decompdiff_tpu.models.common import safe_norm as jax_safe_norm
from decompdiff_tpu.ops.knn import knn_neighbors
from decompdiff_tpu_torch.models import uni_transformer as to2
from decompdiff_tpu_torch.models import uni_transformer_bond as tutb
from decompdiff_tpu_torch.ops import bond_attention as bond_ops
from decompdiff_tpu_torch.ops import edge_attention as edge_ops
from decompdiff_tpu_torch.ops import triplet_attention as triplet_ops
from decompdiff_tpu_torch.ops.common import Branch
from decompdiff_tpu_torch.utils.params import (
    flax_to_state_dict, load_flax_params)

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


def _edge_inputs(group, seed, B=2, N=16, Np=10, K=4, width=H, heads=HEADS):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, width)).astype(np.float32)
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
    return dict(h=h, x=x, e_w=e_w, Np=Np, H=width, heads=heads,
                ed_dense=ed_dense, ed_pallas=ed_pallas, graph=graph,
                n_etypes=6 if group else 4, nbr_idx=nbr_idx,
                nbr_mask=nbr_mask, mask_ligand=mask_ligand,
                group_idx=group_idx)


# (mode, 6 edge types); 'mgate' is node mode with the uni_o2 m-gate, which
# only the 4-type net has
EDGE_CASES = [('node', False), ('node', True), ('pos', False), ('pos', True),
              ('mgate', False)]
EDGE_IDS = [f'{m}-{6 if g else 4}types' for m, g in EDGE_CASES]


def _jax_edge(mode, pallas, c, gather=False):
    """(init, apply) of the JAX module of an edge case: init(key) -> params;
    apply(params, h, x, e_w) builds the edge data from x (so jax.grad
    reaches it) and runs the module. gather: gather_bf16 (node, pos)."""
    kw = dict(use_pallas=pallas, num_protein=c['Np'])
    if gather:
        kw['gather_bf16'] = True
    width, heads = c['H'], c['heads']
    if mode == 'mgate':
        mod = jo2.X2HAttention(width, heads, ew_net_type='m', out_fc=False,
                               **kw)
    elif mode == 'pos':
        mod = jutb.PosEdgeAttention(width, heads, n_etypes=c['n_etypes'],
                                    **kw)
    else:
        mod = jutb.NodeEdgeAttention(width, heads, out_fc=False,
                                     n_etypes=c['n_etypes'], **kw)

    def args(h, x, e_w):
        ed = _jax_edge_data(x, c['nbr_idx'], c['nbr_mask'], c['mask_ligand'],
                            c['group_idx'], pallas)
        if mode != 'mgate':
            return h, ed, e_w
        # uni_transformer.py's edge data; d2 and lig_src feed ew 'r' only
        o2 = ((ed.x4, ed.idx_flat, ed.mld, None, None) if pallas else
              (ed.edge_type, ed.dist, jutb.gather_nodes(h, ed.nbr_idx)))
        return h, o2, ed.nbr_idx, ed.nbr_mask, e_w

    return (lambda key: mod.init(key, *args(c['h'], c['x'], c['e_w'])),
            lambda params, h, x, e_w: mod.apply(params, *args(h, x, e_w)))


def _port_edge(mode, c, gather=False):
    width, heads, n_etypes = c['H'], c['heads'], c['n_etypes']
    if mode == 'mgate':
        return to2.X2HAttention(width, heads, 'm', out_fc=False,
                                use_kernels=True)
    if mode == 'pos':
        return tutb.PosEdgeAttention(width, heads, n_etypes,
                                     use_kernels=True, gather_bf16=gather)
    return tutb.NodeEdgeAttention(width, heads, n_etypes, out_fc=False,
                                  use_kernels=True, gather_bf16=gather)


def _edge_params(mode, c):
    """Dense-path init; for the gate, every leaf moved by N(0, 0.1^2) so
    the gate's bias is not 0."""
    params = _jax_edge(mode, False, c)[0](jax.random.PRNGKey(0))
    if mode != 'mgate':
        return params
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), params)


@pytest.mark.parametrize('mode,group', EDGE_CASES, ids=EDGE_IDS)
def test_edge_kernel_modes(mode, group):
    pos_mode = mode == 'pos'
    c = _edge_inputs(group, seed=3 + 2 * pos_mode + group + 5 * (
        mode == 'mgate'))
    params = _edge_params(mode, c)
    args = (c['h'], c['x'], c['e_w'])
    dense = _jax_edge(mode, False, c)[1](params, *args)
    pallas = _jax_edge(mode, True, c)[1](params, *args)
    tmod = _load(_port_edge(mode, c), params)
    counts = (edge_ops.edge_attention.launches,
              edge_ops.edge_attention.gated_launches)
    got = tmod(_t(c['h']), _t(c['x']), c['graph'], _t(c['e_w'][..., 0]))
    assert (edge_ops.edge_attention.launches,
            edge_ops.edge_attention.gated_launches) == counts  # CPU: none
    assert got.shape == ((2, 16, 3) if pos_mode else (2, 16, H))
    _check(got, dense, pallas)
    if mode == 'node':                   # padded dst nodes: exactly zero
        assert float(got[0, 12:].abs().max()) == 0.0


# gather_bf16 (config key pallas_gather_bf16): the JAX kernel path reads the
# sources from a bf16 node table [h | x hi | x lo] (_pack_hx), so t_src
# projects bf16-rounded h and the source coordinates are hi + lo; the port's
# modules form the same from h and x (gather_table) and pass x_src to the
# wrapper. Forward at TOL against the JAX Pallas kernel with the option, in
# interpret mode; the option itself moves the output by more than that.
GATHER_CASES = [c for c in EDGE_CASES if c[0] != 'mgate']
GATHER_IDS = [i for c, i in zip(EDGE_CASES, EDGE_IDS) if c[0] != 'mgate']


@pytest.mark.parametrize('mode,group', GATHER_CASES, ids=GATHER_IDS)
def test_edge_kernel_gather_bf16(mode, group):
    pos_mode = mode == 'pos'
    c = _edge_inputs(group, seed=31 + 2 * pos_mode + group)
    params = _edge_params(mode, c)
    args = (c['h'], c['x'], c['e_w'])
    want = np.asarray(_jax_edge(mode, True, c, gather=True)[1](params, *args))
    f32 = np.asarray(_jax_edge(mode, True, c)[1](params, *args))
    tmod = _load(_port_edge(mode, c, gather=True), params)
    counts = (edge_ops.edge_attention.launches,
              edge_ops.edge_attention.gather_launches)
    got = tmod(_t(c['h']), _t(c['x']), c['graph'], _t(c['e_w'][..., 0]))
    assert (edge_ops.edge_attention.launches,
            edge_ops.edge_attention.gather_launches) == counts  # CPU: none
    _check(got, want)
    assert np.abs(want - f32).max() > 10 * TOL['atol']
    if mode == 'node':                   # padded dst nodes: exactly zero
        assert float(got[0, 12:].abs().max()) == 0.0
    tmod.gather_bf16 = False             # the flag alone selects the table
    _check(tmod(_t(c['h']), _t(c['x']), c['graph'], _t(c['e_w'][..., 0])),
           f32)


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

def _bond_inputs(seed, B=2, Nl=8, width=H):
    rng = np.random.default_rng(seed)
    h_lig = rng.normal(size=(B, Nl, width)).astype(np.float32)
    h_bond = rng.normal(size=(B, Nl, Nl, width)).astype(np.float32)
    x_lig = (rng.normal(size=(B, Nl, 3)) * 2).astype(np.float32)
    lig_mask = np.ones((B, Nl), bool)
    lig_mask[0, 6:] = False                    # ragged: rows 6, 7 masked
    bond_mask = make_bond_mask(lig_mask)
    return h_lig, h_bond, x_lig, bond_mask


def _check_bond_modes(pos_mode, seed, Nl=8):
    """The bond module with use_kernels on (the plain version) against the
    JAX dense module and its Pallas kernel in interpret mode; the rows past
    6 of complex 0 are masked and give exactly zero in node mode."""
    h_lig, h_bond, x_lig, bond_mask = _bond_inputs(seed=seed, Nl=Nl)
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


@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_kernel_modes(pos_mode):
    _check_bond_modes(pos_mode, seed=4 + pos_mode)


@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_kernel_modes_two_chunks(pos_mode):
    """Nl = 40: more sources than the card kernel's 32-source chunk (the
    second one ragged)."""
    _check_bond_modes(pos_mode, seed=14 + pos_mode, Nl=40)


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


# The `pallas_bf16` option: y and Wo rounded to bf16 before the second
# linears. Where the port's float32 y and the JAX kernel's differ in the
# last bit, a y near a bf16 rounding boundary rounds to neighbouring bf16
# values, which moves a k or v entry by one bf16 ulp of y (2^-8 relative)
# times a row of Wo: up to 7.7e-4 here (seeds 0-3, both variants), against
# ~4.5e-3 that the option itself moves the output. Hence rtol / atol 1e-3.
BF16_TOL = dict(rtol=1e-3, atol=1e-3)


def _bf16_triplet_modules(include_h_node):
    """(JAX Pallas module with bf16, port module with kernels and bf16)."""
    jmod = jutb.BondTripletAttention(H, HEADS, include_h_node=include_h_node,
                                     use_pallas=True, pallas_bf16=True)
    tmod = tutb.BondTripletAttention(H, HEADS, include_h_node=include_h_node,
                                     use_kernels=True, bf16=True)
    return jmod, tmod


@pytest.mark.parametrize('include_h_node', [True, False])
def test_triplet_kernel_bf16(include_h_node):
    """The bf16 plain version (what the wrapper runs on the CPU) against the
    JAX Pallas kernel with bf16=True in interpret mode; the option moves
    the output by more than that tolerance, and the kernel path of the
    port without it stays the float32 one."""
    h_lig, h_bond, x_lig, bond_mask = _bond_inputs(seed=2)
    args = (h_lig, h_bond, x_lig, bond_mask)
    jmod, tmod = _bf16_triplet_modules(include_h_node)
    params = jutb.BondTripletAttention(
        H, HEADS, include_h_node=include_h_node).init(jax.random.PRNGKey(0),
                                                      *args)
    tmod = _load(tmod, params)
    targs = (_t(h_lig), _t(h_bond), _t(x_lig), _t(bond_mask, torch.float32))
    counts = (triplet_ops.triplet_attention.launches,
              triplet_ops.triplet_attention.bf16_launches)
    got = tmod(*targs).detach().numpy()
    assert (triplet_ops.triplet_attention.launches,
            triplet_ops.triplet_attention.bf16_launches) == counts  # CPU
    np.testing.assert_allclose(got, np.asarray(jmod.apply(params, *args)),
                               **BF16_TOL)
    tmod.bf16 = False
    f32 = tmod(*targs).detach().numpy()
    assert np.abs(got - f32).max() > 2 * BF16_TOL['atol']
    _check(torch.as_tensor(f32), jutb.BondTripletAttention(
        H, HEADS, include_h_node=include_h_node).apply(params, *args))
    assert float(np.abs(got[0, 6:]).max()) == 0.0   # masked (j -> i) rows


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


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------
# The plain versions' autograd gradients (what the wrappers run on the CPU,
# and what the backward kernels are held to on the card) against the JAX
# modules' gradients through the Pallas kernels' custom VJPs (interpret mode)
# and through the dense path. Tolerance rtol 5e-4 / atol 5e-5 * max(1, max
# |JAX gradient|), that of tests/test_pallas_triplet_grad.py.

def _assert_grads(got, want, label):
    for (name, a), b in zip(got, want):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5 * scale,
                                   err_msg=f'{label}: {name}')


def _param_grads(flax_grads):
    """(path, array) leaves of a flax gradient tree, sorted by path."""
    return sorted(flax_to_state_dict(jax.tree.map(np.asarray,
                                                  flax_grads)).items())


def _torch_grads(module, inputs, diff, cot):
    """Gradients of sum(module(*inputs) * cot) wrt the parameters (sorted
    by name) and the inputs at positions `diff`."""
    module.requires_grad_(True)
    leaves = [a.clone().requires_grad_(True) if i in diff else a
              for i, a in enumerate(inputs)]
    out = module(*leaves)
    params = sorted(module.named_parameters())
    wrt = [p for _, p in params] + [leaves[i] for i in diff]
    grads = torch.autograd.grad((out * _t(cot)).sum(), wrt, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(wrt, grads)]          # unused: zero, as in JAX
    named = [(n, g.numpy()) for (n, _), g in zip(params, grads)]
    return named, [g.numpy() for g in grads[len(params):]]


@pytest.mark.parametrize('mode,group', EDGE_CASES, ids=EDGE_IDS)
def test_edge_kernel_grads(mode, group):
    """With the m-gate this covers d wm and d bm (ew_kernel, ew_bias)."""
    c = _edge_inputs(group, seed=21 + 2 * (mode == 'pos') + group + 5 * (
        mode == 'mgate'))
    _check_edge_grads(mode, c, (False, True))


def _check_edge_grads(mode, c, paths):
    """Parameter, h, x and e_w gradients of the port's edge module (the
    plain backward) against jax.grad of the JAX module on each of `paths`
    (False: dense, True: Pallas in interpret mode)."""
    params = _edge_params(mode, c)
    B, N = c['h'].shape[:2]
    cot = np.random.default_rng(9).normal(
        size=(B, N, 3 if mode == 'pos' else c['H'])).astype(np.float32)

    def jax_grads(pallas):
        apply = _jax_edge(mode, pallas, c)[1]

        def f(params, h, x, e_w):
            return jnp.sum(apply(params, h, x, e_w) * cot)
        return jax.grad(f, argnums=(0, 1, 2, 3))(params, c['h'], c['x'],
                                                 c['e_w'])

    tmod = _load(_port_edge(mode, c), params)
    got_p, got_in = _torch_grads(
        tmod, (_t(c['h']), _t(c['x']), c['graph'], _t(c['e_w'][..., 0])),
        (0, 1, 3), cot)
    if mode == 'mgate':
        assert {'ew_kernel', 'ew_bias'} <= {n for n, _ in got_p}
    for pallas in paths:
        gp, gh, gx, gew = jax_grads(pallas)
        label = 'pallas' if pallas else 'dense'
        _assert_grads(got_p, [b for _, b in _param_grads(gp)], label)
        _assert_grads(zip(('h', 'x', 'e_w'), got_in),
                      [gh, gx, np.asarray(gew)[..., 0]], label)


# With gather_bf16 the cotangents of h and x pass a bf16 rounding, as in
# JAX's cast chain: the table's (summed over edges, then rounded) and the
# source coordinates' (hi + lo: the rounded sum of the d x_src terms). JAX
# sums d t_src per edge into the table before rounding; the port scatters
# d t_src, multiplies by Wj^T, then rounds: the same sum in another order,
# so a value within float32 rounding of a bf16 rounding boundary can round
# to the neighbouring bf16 value. d h and d x are therefore held at the
# float32 tolerance above except for at most 1% of their elements, which
# may differ by one bf16 ulp at the gradient's scale, 2^-7 * max(1,
# max |grad|). Every other gradient at the float32 tolerance.
BF16_ULP = 2.0 ** -7


def _assert_rounded_grads(got, want, label):
    for (name, a), b in zip(got, want):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        diff = np.abs(a - b)
        outside = diff > 5e-4 * np.abs(b) + 5e-5 * scale
        assert outside.sum() <= max(1, 0.01 * b.size), (label, name)
        assert diff.max() <= BF16_ULP * scale, (label, name, diff.max())


@pytest.mark.parametrize('mode,group', GATHER_CASES, ids=GATHER_IDS)
def test_edge_kernel_gather_bf16_grads(mode, group):
    """Parameter, h, x and e_w gradients of the gather_bf16 path against
    jax.grad of the JAX Pallas module with the option (its custom VJP in
    interpret mode)."""
    pos_mode = mode == 'pos'
    c = _edge_inputs(group, seed=41 + 2 * pos_mode + group)
    params = _edge_params(mode, c)
    cot = np.random.default_rng(9).normal(
        size=(2, 16, 3 if pos_mode else H)).astype(np.float32)
    apply = _jax_edge(mode, True, c, gather=True)[1]

    def f(params, h, x, e_w):
        return jnp.sum(apply(params, h, x, e_w) * cot)
    gp, gh, gx, gew = jax.grad(f, argnums=(0, 1, 2, 3))(params, c['h'],
                                                        c['x'], c['e_w'])
    tmod = _load(_port_edge(mode, c, gather=True), params)
    got_p, got_in = _torch_grads(
        tmod, (_t(c['h']), _t(c['x']), c['graph'], _t(c['e_w'][..., 0])),
        (0, 1, 3), cot)
    _assert_grads(got_p, [b for _, b in _param_grads(gp)], 'gather_bf16')
    _assert_grads([('e_w', got_in[2])], [np.asarray(gew)[..., 0]],
                  'gather_bf16')
    _assert_rounded_grads(zip(('h', 'x'), got_in[:2]), [gh, gx],
                          'gather_bf16')


@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_bond_kernel_grads(pos_mode):
    _check_bond_grads(pos_mode, 24 + pos_mode, (False, True))


def _check_bond_grads(pos_mode, seed, paths, B=2, width=H, heads=HEADS):
    """Parameter and input gradients of the port's bond module (the plain
    backward) against jax.grad of the JAX module on each of `paths` (False:
    dense, True: Pallas in interpret mode)."""
    h_lig, h_bond, x_lig, bond_mask = _bond_inputs(seed=seed, B=B,
                                                   width=width)
    tbm = _t(bond_mask, torch.float32)
    cot = np.random.default_rng(9).normal(
        size=(B, 8, 3 if pos_mode else width)).astype(np.float32)
    if pos_mode:
        def rel(x):
            return x[:, :, None, :] - x[:, None, :, :]
        mods = [jutb.PosBondAttention(width, heads, use_pallas=p)
                for p in paths]
        params = jutb.PosBondAttention(width, heads).init(
            jax.random.PRNGKey(0), h_lig, rel(x_lig), h_bond, bond_mask)
        tmod = _load(tutb.PosBondAttention(width, heads, use_kernels=True),
                     params)
        got_p, got_in = _torch_grads(
            tmod, (_t(h_lig), _t(x_lig), _t(h_bond), tbm), (0, 1, 2), cot)

        def jax_grads(mod):
            def f(params, h, x, hb):
                return jnp.sum(mod.apply(params, h, rel(x), hb, bond_mask)
                               * cot)
            return jax.grad(f, argnums=(0, 1, 2, 3))(params, h_lig, x_lig,
                                                     h_bond)
        labels = ('h_lig', 'x_lig', 'h_bond')
    else:
        mods = [jutb.NodeBondAttention(width, heads, out_fc=False,
                                       use_pallas=p) for p in paths]
        params = jutb.NodeBondAttention(width, heads, out_fc=False).init(
            jax.random.PRNGKey(0), h_lig, h_bond, bond_mask)
        tmod = _load(tutb.NodeBondAttention(width, heads, out_fc=False,
                                            use_kernels=True), params)
        got_p, got_in = _torch_grads(tmod, (_t(h_lig), _t(h_bond), tbm),
                                     (0, 1), cot)

        def jax_grads(mod):
            def f(params, h, hb):
                return jnp.sum(mod.apply(params, h, hb, bond_mask) * cot)
            return jax.grad(f, argnums=(0, 1, 2))(params, h_lig, h_bond)
        labels = ('h_lig', 'h_bond')
    for mod, pallas in zip(mods, paths):
        label = 'pallas' if pallas else 'dense'
        gp, *gin = jax_grads(mod)
        _assert_grads(got_p, [b for _, b in _param_grads(gp)], label)
        _assert_grads(zip(labels, got_in), gin, label)


@pytest.mark.parametrize('include_h_node', [True, False])
def test_triplet_kernel_grads(include_h_node):
    _check_triplet_grads(include_h_node, 26, (False, True))


def _check_triplet_grads(include_h_node, seed, paths, B=2, width=H,
                         heads=HEADS):
    """Parameter and input gradients of the port's triplet module (the
    plain backward) against jax.grad of the JAX module on each of `paths`
    (False: dense, True: Pallas in interpret mode)."""
    h_lig, h_bond, x_lig, bond_mask = _bond_inputs(seed=seed, B=B,
                                                   width=width)
    mods = [jutb.BondTripletAttention(width, heads,
                                      include_h_node=include_h_node,
                                      use_pallas=p) for p in paths]
    params = jutb.BondTripletAttention(
        width, heads, include_h_node=include_h_node).init(
            jax.random.PRNGKey(0), h_lig, h_bond, x_lig, bond_mask)
    cot = np.random.default_rng(9).normal(size=(B, 8, 8, width)).astype(
        np.float32)
    tmod = _load(tutb.BondTripletAttention(
        width, heads, include_h_node=include_h_node, use_kernels=True),
        params)
    got_p, got_in = _torch_grads(
        tmod, (_t(h_lig), _t(h_bond), _t(x_lig), _t(bond_mask, torch.float32)),
        (0, 1, 2), cot)
    for mod, pallas in zip(mods, paths):
        label = 'pallas' if pallas else 'dense'
        def f(params, h, hb, x):
            return jnp.sum(mod.apply(params, h, hb, x, bond_mask) * cot)
        gp, *gin = jax.grad(f, argnums=(0, 1, 2, 3))(params, h_lig, h_bond,
                                                     x_lig)
        _assert_grads(got_p, [b for _, b in _param_grads(gp)], label)
        _assert_grads(zip(('h_lig', 'h_bond', 'x_lig'), got_in), gin, label)


@pytest.mark.parametrize('include_h_node', [True, False])
def test_triplet_kernel_bf16_grads(include_h_node):
    """With bf16 the gradient is the float32 one: the port's CPU autograd
    node runs the float32 plain backward, as the JAX custom VJP runs the
    float32 backward kernel; both against jax.grad of the bf16 Pallas
    module, at the float32 gradient tolerance."""
    h_lig, h_bond, x_lig, bond_mask = _bond_inputs(seed=27)
    jmod, tmod = _bf16_triplet_modules(include_h_node)
    params = jutb.BondTripletAttention(
        H, HEADS, include_h_node=include_h_node).init(
            jax.random.PRNGKey(0), h_lig, h_bond, x_lig, bond_mask)
    cot = np.random.default_rng(9).normal(size=(2, 8, 8, H)).astype(
        np.float32)
    got_p, got_in = _torch_grads(
        _load(tmod, params),
        (_t(h_lig), _t(h_bond), _t(x_lig), _t(bond_mask, torch.float32)),
        (0, 1, 2), cot)

    def f(params, h, hb, x):
        return jnp.sum(jmod.apply(params, h, hb, x, bond_mask) * cot)
    gp, *gin = jax.grad(f, argnums=(0, 1, 2, 3))(params, h_lig, h_bond,
                                                 x_lig)
    _assert_grads(got_p, [b for _, b in _param_grads(gp)], 'pallas bf16')
    _assert_grads(zip(('h_lig', 'h_bond', 'x_lig'), got_in), gin,
                  'pallas bf16')


# The plain backward versions at a width of the wide card kernels (H = 512,
# 16 heads: 1024-thread builds with the row buffers in device memory), which
# the card tests hold those kernels to, against jax.grad of the JAX modules
# through the Pallas kernels in interpret mode, at the gradient tolerance
# above. B = 1 and 16 nodes (edge) or Nl = 8 (bond, triplet) keep interpret
# mode quick.
WIDE_H, WIDE_HEADS = 512, 16


@pytest.mark.parametrize('case', ['edge-node', 'edge-pos', 'edge-mgate',
                                  'bond-node', 'bond-pos', 'triplet'])
def test_wide_kernel_grads(case):
    kernel, _, mode = case.partition('-')
    wide = dict(width=WIDE_H, heads=WIDE_HEADS)
    if kernel == 'edge':
        c = _edge_inputs(mode == 'pos', seed=61 + len(mode), B=1, **wide)
        _check_edge_grads(mode, c, (True,))
    elif kernel == 'bond':
        _check_bond_grads(mode == 'pos', 64 + len(mode), (True,), B=1, **wide)
    else:
        _check_triplet_grads(True, 66, (True,), B=1, **wide)
