"""The head-factorized edge-attention backward (the algorithm of the backward
kernel at H in 32, 64, 128, csrc/head_bwd.cuh), as its plain PyTorch version
`edge_attention_backward_factored`, against two references on the same
seeded inputs:

- the plain autograd backward (`edge_attention_backward_reference`) in
  float64, at rtol 1e-5 / atol 1e-6 x max(1, |grad|max): the same function
  with the sums in another order (its masked softmax, which casts to
  float32 for the model, is kept in float64 here);
- jax.vjp of the JAX package's Pallas edge kernel (`edge_attention_pallas`)
  in interpret mode, in float32, at rtol 5e-4 / atol 5e-5 x max(1,
  |grad|max), the tolerance to which tests/test_torch_kernels.py holds the
  port's edge gradients against the Pallas VJP. The JAX kernel projects
  the gathered source rows of a node table h by Wj itself, so the port's
  t_src is h @ Wj, and its d t_src is held through d h = d t_src Wj^T and
  d Wj = h^T d t_src.

Cases: node and pos mode at H = 32 (4 heads) and H = 128 (16 heads), with 4
and 6 edge types, K = 20 and K = 40 (two 32-source chunks in the kernel),
the m-gated node mode and the gather_bf16 sources (x_src, node and pos);
row 5 of complex 0 has no valid source and complex 1 none at all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu.models.uni_transformer_bond import _pallas_prep_we
from decompdiff_tpu.ops.pallas.edge_kernel import edge_attention_pallas
from decompdiff_tpu_torch.ops import common as ops_common
from decompdiff_tpu_torch.ops import edge_attention as edge_ops
from decompdiff_tpu_torch.ops.common import Branch

torch.set_num_threads(2)
B, N, NP = 2, 16, 10
# (mode, H, heads, K, 6 edge types)
CASES = [('node', 32, 4, 20, False), ('node', 128, 16, 40, True),
         ('pos', 32, 4, 40, True), ('pos', 128, 16, 20, False),
         ('gated', 128, 16, 20, False), ('gather', 32, 4, 40, True),
         ('gather_pos', 128, 16, 20, True)]
IDS = [f'{m}-H{h}-K{k}-{6 if g else 4}types' for m, h, _, k, g in CASES]


def _bf16(a):
    return np.asarray(torch.as_tensor(a).bfloat16().float())


def _inputs(mode, H, heads, K, group, seed=0):
    """numpy inputs of one case: the graph, q, g, the node table h and both
    branches (t_src = h @ wj), the gate and x_src where the mode has them."""
    rng = np.random.default_rng(seed + H + K + 7 * group)
    pos = mode.endswith('pos')

    def r(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    n_et = 6 if group else 4
    x = r(B, N, 3, scale=3.0)
    idx = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    mask = (rng.random((B, N, K)) < 0.8).astype(np.float32)
    mask[0, 5] = 0.0                       # row 5 of complex 0: no source
    mask[1] = 0.0                          # complex 1: no source at all
    lig = np.broadcast_to(np.arange(N) >= NP, (B, N)).astype(np.float32)
    d = dict(mode=mode, heads=heads, x=x, idx=idx, mask=mask, lig=lig,
             group=(rng.integers(0, 3, size=(B, N)).astype(np.float32)
                    if group else None),
             e_w=rng.random((B, N, K)).astype(np.float32),
             q=r(B, N, H, scale=1.0), g=r(B, N, 3 if pos else H, scale=1.0),
             h=r(B, N, H, scale=1.0), gate=None, x_src=None)
    if mode.startswith('gather'):          # the bf16 node table's sources
        hi = _bf16(x)
        d['x_src'] = hi + _bf16(x - hi)
    h_src = _bf16(d['h']) if mode.startswith('gather') else d['h']
    for tag, dout in (('k', H), ('v', heads if pos else H)):
        wj = r(H, H, scale=0.1)
        d[tag] = dict(t_row=r(B, N, H, scale=1.0), t_src=h_src @ wj,
                      w_feat=r(n_et * 21, H), wo=r(H, dout), bo=r(dout),
                      ln_scale=1.0 + r(H), ln_bias=r(H), wj=wj)
    if mode == 'gated':
        d['gate'] = (r(H), np.array([0.5], np.float32))
    return d


def _torch(d, dtype):
    def t(a):
        return None if a is None else torch.as_tensor(a, dtype=dtype)
    args = (t(d['x']), t(d['lig']), t(d['group']),
            torch.as_tensor(d['idx']), t(d['mask']), t(d['e_w']), t(d['q']),
            *(Branch(*(t(d[b][f]) for f in Branch._fields)) for b in 'kv'))
    kw = dict(n_heads=d['heads'], pos_mode=d['mode'].endswith('pos'),
              gate=None if d['gate'] is None else tuple(map(t, d['gate'])),
              x_src=t(d['x_src']))
    return t(d['g']), args, kw


def _flat(grads, d):
    """(label, float64 array) of every gradient of a backward wrapper's
    result, in the order of its tuple."""
    d_x, d_ew, d_q, dk, dv, *rest = grads
    out = [('x', d_x), ('e_w', d_ew), ('q', d_q)]
    for tag, br in (('k', dk), ('v', dv)):
        out += [(f'{tag}.{f}', getattr(br, f)) for f in Branch._fields]
    if d['gate'] is not None:
        out += [('wm', rest[0][0]), ('bm', rest[0][1])]
    if d['x_src'] is not None:
        out.append(('x_src', rest[-1]))
    return [(n, np.asarray(a.detach().numpy() if torch.is_tensor(a) else a,
                           np.float64)) for n, a in out]


def _assert_close(got, want, rtol, atol, label):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                                   err_msg=f'{label}: d {name}')


def _factored(d, dtype):
    g, args, kw = _torch(d, dtype)
    return edge_ops.edge_attention_backward_factored(g, *args, **kw)


def _softmax_in_dtype(logits, mask, dim):
    """models.common.masked_softmax without its cast to float32."""
    masked = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    m = masked.amax(dim=dim, keepdim=True)
    e = torch.where(mask, torch.exp(masked - m), 0.0)
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-16)


@pytest.mark.parametrize('mode,H,heads,K,group', CASES, ids=IDS)
def test_factored_backward_matches_autograd(mode, H, heads, K, group,
                                            monkeypatch):
    monkeypatch.setattr(ops_common, 'masked_softmax', _softmax_in_dtype)
    d = _inputs(mode, H, heads, K, group)
    g, args, kw = _torch(d, torch.float64)
    want = _flat(edge_ops.edge_attention_backward_reference(g, *args, **kw),
                 d)
    got = _flat(_factored(d, torch.float64), d)
    _assert_close(got, want, 1e-5, 1e-6, 'factored vs autograd')
    # complex 1 has no valid source: its per-node gradients are zero
    assert all(float(np.abs(a[1]).max()) == 0.0 for n, a in got
               if n in ('e_w', 'q', 'k.t_row', 'v.t_row'))


@pytest.mark.parametrize('mode,H,heads,K,group', CASES, ids=IDS)
def test_factored_backward_matches_jax_pallas(mode, H, heads, K, group):
    d = _inputs(mode, H, heads, K, group)
    pos, gather = mode.endswith('pos'), mode.startswith('gather')
    hd, n_et = H // heads, 6 if group else 4
    x4 = np.concatenate([d['x'], np.zeros((B, N, 1), np.float32)], -1)
    if gather:                 # [bf16 h | x hi | x lo], held in float32
        hi = _bf16(x4)
        hx = np.concatenate([_bf16(d['h']), hi, _bf16(x4 - hi)], -1)
    else:
        hx = np.concatenate([d['h'], x4], -1)
    grp = np.zeros((B, N), np.float32) if d['group'] is None else d['group']
    gsrc = np.take_along_axis(grp, d['idx'].reshape(B, N * K), 1)

    def branch(p, rep):
        class _P:
            we = jnp.asarray(p['w_feat'])
        wo, bo = p['wo'], p['bo'][None]
        if rep:                # pos mode's v: each head column hd times
            wo, bo = np.repeat(wo, hd, axis=1), np.repeat(bo, hd, axis=1)
        return [_pallas_prep_we(_P, n_et), p['wj'], wo, bo,
                p['ln_scale'][None], p['ln_bias'][None]]

    k, v = d['k'], d['v']
    primals = [x4, d['e_w'], hx, k['t_row'], v['t_row'], d['q'],
               *branch(k, False), *branch(v, pos)]
    if d['gate'] is not None:
        primals += list(d['gate'])
    primals = [jnp.asarray(a) for a in primals]

    def f(xd4, e_w, hx, ti_k, ti_v, q, *w):
        return edge_attention_pallas(
            xd4, jnp.stack([jnp.asarray(d['lig']), jnp.asarray(grp)], -1),
            jnp.asarray(d['idx'].reshape(B, N * K, 1)),
            jnp.asarray(gsrc[..., None]), e_w, jnp.asarray(d['mask']), hx,
            ti_k, ti_v, q, *w[:12], *w[12:], n_heads=heads, pos_mode=pos,
            num_protein=NP, n_etypes=n_et)

    out, vjp = jax.vjp(f, *primals)
    cot = d['g']
    if pos:
        cot = np.concatenate([cot, np.zeros((B, N, 1), np.float32)], -1)
    (dxd, dew, dhx, dtr_k, dtr_v, dq, *dw) = [
        np.asarray(a, np.float64) for a in vjp(jnp.asarray(cot))]

    # the port's gradients in the JAX kernel's terms
    got = dict(_flat(_factored(d, torch.float32), d))
    h_src = _bf16(d['h']) if gather else d['h']
    # the kernel's w_feat rows: per type its 20 RBF rows, then its own row
    perm = np.concatenate([np.r_[t * 20:(t + 1) * 20, n_et * 20 + t]
                           for t in range(n_et)])
    pairs = [('x (destinations)', got['x'] if gather else None, dxd[..., :3]),
             ('x', None if gather else got['x'],
              dxd[..., :3] + dhx[..., H:H + 3]),
             ('x_src', got.get('x_src'), dhx[..., H:H + 3]),
             ('e_w', got['e_w'], dew), ('q', got['q'], dq),
             ('h', np.einsum('bnc,jc->bnj', got['k.t_src'], k['wj'])
              + np.einsum('bnc,jc->bnj', got['v.t_src'], v['wj']),
              dhx[..., :H])]
    for i, tag in enumerate('kv'):
        we, wj, wo, bo, lns, lnb = dw[6 * i:6 * i + 6]
        if tag == 'v' and pos:
            wo = wo.reshape(H, heads, hd).sum(-1)
            bo = bo.reshape(1, heads, hd).sum(-1)
        pairs += [(f'{tag}.t_row', got[f'{tag}.t_row'],
                   (dtr_k, dtr_v)[i]),
                  (f'{tag}.wj', np.einsum('bnj,bnc->jc', h_src,
                                          got[f'{tag}.t_src']), wj),
                  (f'{tag}.w_feat', got[f'{tag}.w_feat'][perm],
                   we[:n_et * 21]),
                  (f'{tag}.wo', got[f'{tag}.wo'], wo),
                  (f'{tag}.bo', got[f'{tag}.bo'], bo[0]),
                  (f'{tag}.ln_scale', got[f'{tag}.ln_scale'], lns[0]),
                  (f'{tag}.ln_bias', got[f'{tag}.ln_bias'], lnb[0])]
    if d['gate'] is not None:
        pairs += [('wm', got['wm'], dw[12]), ('bm', got['bm'], dw[13])]
    pairs = [(n, a, b) for n, a, b in pairs if a is not None]
    _assert_close([(n, a) for n, a, _ in pairs],
                  [(n, b) for n, _, b in pairs], 5e-4, 5e-5,
                  'factored vs JAX Pallas')
