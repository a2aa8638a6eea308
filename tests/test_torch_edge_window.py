"""The edge attention's destination-row window (ops/edge_attention.py
`rows`) on the CPU: the plain version with a window equals the same call
without it on the window's rows and gives exact zeros outside, in node and
pos mode, with 4 and 6 edge types, a window of even and odd length, with
and without x_src; a window outside [0, N] raises; its gradient, for a
cotangent that is zero outside the window, equals the unwindowed one; and
one AttentionLayerO2 and one AttentionLayerBond layer of the tiny config,
which window their coordinate attention to the rows after the protein
block, give the same x and h as with the window taken away. Every
comparison is exact: the plain version computes every row either way.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from decompdiff_tpu_torch.models import uni_transformer_bond as tutb
from decompdiff_tpu_torch.models.uni_transformer import AttentionLayerO2
from decompdiff_tpu_torch.ops import edge_attention as edge_ops
from decompdiff_tpu_torch.ops.common import Branch
from decompdiff_tpu_torch.ops.knn import knn_neighbors
from decompdiff_tpu_torch.utils.testing import tiny_model_config

CFG = tiny_model_config()
H, HEADS, K = CFG['hidden_dim'], CFG['n_heads'], CFG['knn']
B, NP, N_EXTRA = 2, 14, 3        # prior dummies after the ligand block


def _rand(rng, *shape, scale=0.3):
    return torch.as_tensor(rng.normal(size=shape) * scale,
                           dtype=torch.float32)


def _graph(rng, Nl, group):
    """An EdgeGraph over [protein | ligand | dummies], complex 0 ragged."""
    N = NP + Nl + N_EXTRA
    x = _rand(rng, B, N, 3, scale=3.0)
    mask = torch.ones(B, N, dtype=torch.bool)
    mask[0, NP + Nl - 2:NP + Nl] = False
    idx, nbr_mask, _ = knn_neighbors(x, mask, K)
    lig = ((torch.arange(N)[None] >= NP) & mask).float()
    grp = (torch.as_tensor(rng.integers(-1, 3, size=(B, N)),
                           dtype=torch.float32) if group else None)
    return x, tutb.EdgeGraph(idx.int().contiguous(), nbr_mask.float(), lig,
                             grp)


def _call_args(rng, Nl, pos, group, x_src):
    """(args, kw) of an edge attention call."""
    x, graph = _graph(rng, Nl, group)
    N = x.shape[1]
    n_et = 6 if group else 4

    def branch(dout):
        return Branch(_rand(rng, B, N, H, scale=1.0),
                      _rand(rng, B, N, H, scale=1.0),
                      _rand(rng, n_et * 21, H), _rand(rng, H, dout),
                      _rand(rng, dout), 1.0 + _rand(rng, H), _rand(rng, H))
    args = (x, graph.lig, graph.group, graph.idx, graph.mask,
            torch.as_tensor(rng.random((B, N, K)), dtype=torch.float32),
            _rand(rng, B, N, H, scale=1.0), branch(H),
            branch(HEADS if pos else H))
    kw = dict(n_heads=HEADS, pos_mode=pos)
    if x_src:
        kw['x_src'] = x + _rand(rng, *x.shape, scale=0.5)
    return args, kw


def _outside(N, start, n):
    i = torch.arange(N)
    return (i < start) | (i >= start + n)


def _op_case(pos, group, Nl, x_src):
    rng = np.random.default_rng(Nl + 2 * pos + 4 * group + 8 * x_src)
    args, kw = _call_args(rng, Nl, pos, group, x_src)
    N = args[0].shape[1]
    whole = edge_ops.edge_attention_reference(*args, **kw)
    for start, n in ((NP, Nl), (0, N), (NP + 1, 0), (N - 1, 1)):
        got = edge_ops.edge_attention_reference(*args, **kw,
                                                rows=(start, n))
        out = _outside(N, start, n)
        assert torch.equal(got[:, ~out], whole[:, ~out]), (start, n)
        assert torch.equal(got[:, out], torch.zeros_like(got[:, out]))
        assert not got[:, out].signbit().any()
    # the wrapper takes the same window and runs the plain version here
    got = edge_ops.edge_attention(*args, **kw, rows=(NP, Nl))
    assert torch.equal(got, edge_ops.edge_attention_reference(
        *args, **kw, rows=(NP, Nl)))


def _bad_window_case():
    rng = np.random.default_rng(0)
    args, kw = _call_args(rng, 5, True, False, False)
    N = args[0].shape[1]
    for rows in ((-1, 3), (N - 2, 3), (0, N + 1), (2, -1), (N + 1, 0)):
        with pytest.raises(ValueError, match='row window'):
            edge_ops.edge_attention_reference(*args, **kw, rows=rows)
        with pytest.raises(ValueError, match='row window'):
            edge_ops.edge_attention(*args, **kw, rows=rows)
        with pytest.raises(ValueError, match='row window'):
            edge_ops.edge_attention_backward(
                torch.zeros(B, N, 3), *args, **kw, rows=rows)


def _leaves(grads):
    """The tensors of a backward's result, Branches and the gate flattened."""
    for t in grads:
        yield from (_leaves(t) if isinstance(t, tuple) else (t,))


def _grad_case(pos):
    """The windowed backward for a cotangent zero outside the window equals
    the unwindowed backward; a cotangent nonzero outside reaches nothing
    there."""
    rng = np.random.default_rng(30 + pos)
    Nl = 7
    args, kw = _call_args(rng, Nl, pos, True, False)
    N = args[0].shape[1]
    out = _outside(N, NP, Nl)
    g = _rand(rng, B, N, 3 if pos else H, scale=1.0)
    g_in = torch.where(out[:, None], 0.0, g)
    want = edge_ops.edge_attention_backward(g_in, *args, **kw)
    for cot in (g_in, g):
        got = edge_ops.edge_attention_backward(cot, *args, **kw,
                                               rows=(NP, Nl))
        for a, b in zip(_leaves(got), _leaves(want)):
            assert torch.equal(a, b)


def _layer_inputs(rng, Nl, group):
    x, graph = _graph(rng, Nl, group)
    N = x.shape[1]
    h = _rand(rng, B, N, H, scale=1.0)
    movable = ~_outside(N, NP, Nl)[None].expand(B, N) & (graph.lig > 0.5)
    e_w = torch.as_tensor(rng.random((B, N, K)), dtype=torch.float32)
    return h, x, graph, movable, e_w


def _run_windows(fn, keep):
    """(fn(), the windows its edge attention calls were given), each call
    run with its window if `keep`, else with the window taken away."""
    edge, seen = edge_ops.edge_attention, []

    def call(*args, rows=None, **kw):
        seen.append(rows)
        return edge(*args, rows=rows if keep else None, **kw)
    with mock.patch.object(edge_ops, 'edge_attention', call):
        return fn(), seen


def _same_with_and_without(fn, keys, n_pos):
    """fn's outputs, with and without the windows, are equal, and n_pos
    calls (the coordinate attentions) took the rows after the protein
    block, the others none."""
    with torch.no_grad():
        got, seen = _run_windows(fn, True)
        want, _ = _run_windows(fn, False)
    N = want[-1].shape[1]                    # x [B, N, 3] comes last
    assert sorted(seen, key=str) == sorted(
        [(NP, N - NP)] * n_pos + [None] * (len(seen) - n_pos), key=str)
    for a, b, key in zip(got, want, keys):
        assert torch.equal(a, b), key
    return want


def _randomized(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return module


def _layer_o2_case():
    rng = np.random.default_rng(40)
    Nl = 7
    h, x, graph, movable, e_w = _layer_inputs(rng, Nl, False)
    layer = _randomized(AttentionLayerO2(H, HEADS, num_h2x=2,
                                         ew_net_type='r', use_kernels=True),
                        1)
    want = _same_with_and_without(
        lambda: layer(h, x, graph, movable, e_w, NP), ('h', 'x'), 2)
    assert not torch.equal(want[1], x)       # the ligand rows moved


def _layer_bond_case():
    rng = np.random.default_rng(41)
    Nl = 6
    h, x, graph, movable, e_w = _layer_inputs(rng, Nl, True)
    h_bond = _rand(rng, B, Nl, Nl, H, scale=1.0)
    bond_mask = (torch.as_tensor(rng.random((B, Nl, Nl))) < 0.4).float()
    layer = _randomized(tutb.AttentionLayerBond(
        H, HEADS, CFG['x2h_out_fc'], False, 6, use_kernels=True), 2)
    want = _same_with_and_without(
        lambda: layer(h, x, graph, h_bond, bond_mask, movable, NP, e_w),
        ('h', 'h_bond', 'x'), 1)
    assert not torch.equal(want[2], x)


CASES = {
    f'{mode}-{n_et}types-Nl{Nl}{"-x_src" if xs else ""}': functools.partial(
        _op_case, mode == 'pos', n_et == 6, Nl, xs)
    for mode in ('node', 'pos') for n_et in (4, 6) for Nl in (6, 7)
    for xs in (False, True)}
CASES.update({
    'bad-window': _bad_window_case,
    'grad-node': functools.partial(_grad_case, False),
    'grad-pos': functools.partial(_grad_case, True),
    'layer-o2': _layer_o2_case,
    'layer-bond': _layer_bond_case,
})


@pytest.mark.parametrize('case', sorted(CASES))
def test_row_window(case):
    CASES[case]()
