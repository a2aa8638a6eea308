"""The head-factorized bond-attention backward (the algorithm of the backward
kernels at H in 32, 64, 128: csrc/head_bwd.cuh, then the tensor-core
products of d h_bond and d We in csrc/bond_attention.cu), as its plain
PyTorch version `bond_attention_backward_factored`, against two references
on the same seeded inputs:

- the plain autograd backward (`bond_attention_backward_reference`) in
  float64, at rtol 1e-5 / atol 1e-6 x max(1, |grad|max): the same function
  with the sums in another order (its masked softmax, which casts to
  float32 for the model, is kept in float64 here);
- jax.vjp of the JAX package's Pallas bond kernel (`bond_attention_pallas`)
  in interpret mode, in float32, at rtol 5e-4 / atol 5e-5 x max(1,
  |grad|max), the tolerance to which tests/test_torch_kernels.py holds the
  port's gradients against the Pallas VJPs. The JAX kernel projects the
  ligand rows h by Wi, Wj and the bias be itself, so the port's t_row is
  h @ Wi + be and t_src is h @ Wj, and d t_row, d t_src are held through
  d Wi = h^T d t_row, d Wj = h^T d t_src, d be = sum d t_row and
  d h = d t_row Wi^T + d t_src Wj^T.

Cases: node and pos mode at H = 32 (4 heads) and H = 128 (16 heads), at
Nl = 13 and Nl = 40 (two 32-source chunks in the kernel); atom 4 of
complex 0 has no bond and complex 1 none at all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu.ops.pallas.bond_kernel import bond_attention_pallas
from decompdiff_tpu_torch.ops import bond_attention as bond_ops
from decompdiff_tpu_torch.ops import common as ops_common
from decompdiff_tpu_torch.ops.common import Branch

torch.set_num_threads(2)
B = 2
# (mode, H, heads, Nl)
CASES = [(m, h, nh, nl) for m in ('node', 'pos')
         for h, nh in ((32, 4), (128, 16)) for nl in (13, 40)]
IDS = [f'{m}-H{h}-Nl{nl}' for m, h, _, nl in CASES]
FIELDS = ('t_row', 't_src', 'w_feat', 'wo', 'bo', 'ln_scale', 'ln_bias')


def _inputs(mode, H, heads, Nl, seed=0):
    """numpy inputs of one case: the bond graph, h_bond, x, q, g, the ligand
    rows h and both branches (t_row = h @ wi + be, t_src = h @ wj)."""
    rng = np.random.default_rng(seed + H + Nl)
    pos = mode == 'pos'

    def r(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    mask = ((rng.random((B, Nl, Nl)) < 0.5)
            & ~np.eye(Nl, dtype=bool)).astype(np.float32)
    mask[0, 4] = 0.0                       # atom 4 of complex 0: no bond
    mask[1] = 0.0                          # complex 1: no bond at all
    h = r(B, Nl, H, scale=1.0)
    d = dict(mode=mode, heads=heads, mask=mask, h=h,
             h_bond=r(B, Nl, Nl, H, scale=1.0), x=r(B, Nl, 3, scale=2.0),
             q=r(B, Nl, H, scale=1.0), g=r(B, Nl, 3 if pos else H, scale=1.0))
    for tag, dout in (('k', H), ('v', heads if pos else H)):
        wi, wj, be = r(H, H, scale=0.1), r(H, H, scale=0.1), r(H)
        d[tag] = dict(t_row=h @ wi + be, t_src=h @ wj,
                      w_feat=r(H, H, scale=0.1), wo=r(H, dout), bo=r(dout),
                      ln_scale=1.0 + r(H), ln_bias=r(H), wi=wi, wj=wj, be=be)
    return d


def _torch(d, dtype):
    def t(a):
        return torch.as_tensor(a, dtype=dtype)
    pos = d['mode'] == 'pos'
    args = (t(d['h_bond']), t(d['x']) if pos else None, t(d['mask']),
            t(d['q']), *(Branch(*(t(d[b][f]) for f in FIELDS)) for b in 'kv'))
    return t(d['g']), args, dict(n_heads=d['heads'], pos_mode=pos)


def _flat(grads):
    """(label, float64 array) of every gradient of a backward wrapper's
    result, in the order of its tuple (d x only in pos mode)."""
    d_hb, d_x, d_q, dk, dv = grads
    out = [('h_bond', d_hb), ('x', d_x), ('q', d_q)]
    for tag, br in (('k', dk), ('v', dv)):
        out += [(f'{tag}.{f}', getattr(br, f)) for f in FIELDS]
    return [(n, np.asarray(a.detach().numpy(), np.float64)) for n, a in out
            if a is not None]


def _assert_close(got, want, rtol, atol, label):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                                   err_msg=f'{label}: d {name}')


def _factored(d, dtype):
    g, args, kw = _torch(d, dtype)
    return bond_ops.bond_attention_backward_factored(g, *args, **kw)


def _softmax_in_dtype(logits, mask, dim):
    """models.common.masked_softmax without its cast to float32."""
    masked = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    m = masked.amax(dim=dim, keepdim=True)
    e = torch.where(mask, torch.exp(masked - m), 0.0)
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-16)


@pytest.mark.parametrize('mode,H,heads,Nl', CASES, ids=IDS)
def test_factored_backward_matches_autograd(mode, H, heads, Nl, monkeypatch):
    monkeypatch.setattr(ops_common, 'masked_softmax', _softmax_in_dtype)
    d = _inputs(mode, H, heads, Nl)
    g, args, kw = _torch(d, torch.float64)
    want = _flat(bond_ops.bond_attention_backward_reference(g, *args, **kw))
    got = _flat(_factored(d, torch.float64))
    _assert_close(got, want, 1e-5, 1e-6, 'factored vs autograd')
    # complex 1 has no bond: its per-atom and per-pair gradients are zero,
    # and so is the row of atom 4 in complex 0
    for n, a in got:
        if n in ('h_bond', 'q', 'k.t_row', 'v.t_row', 'k.t_src', 'v.t_src'):
            assert float(np.abs(a[1]).max()) == 0.0, n
    assert float(np.abs(dict(got)['h_bond'][0, 4]).max()) == 0.0


@pytest.mark.parametrize('mode,H,heads,Nl', CASES, ids=IDS)
def test_factored_backward_matches_jax_pallas(mode, H, heads, Nl):
    d = _inputs(mode, H, heads, Nl)
    pos = mode == 'pos'
    if pos:
        rel = d['x'][:, :, None, :] - d['x'][:, None, :, :]
        rel_pad = np.concatenate([rel, np.zeros((B, Nl, Nl, 1), np.float32)],
                                 -1)
    else:
        rel_pad = np.zeros((B, 1, 1, 4), np.float32)

    def branch(p):             # pos mode's v: wo [H, heads], as the port's
        return [p['w_feat'], p['wi'], p['wj'], p['wo'], p['bo'][None],
                p['be'][None], p['ln_scale'][None], p['ln_bias'][None]]

    primals = [jnp.asarray(a) for a in [d['h_bond'], d['h'], rel_pad, d['q'],
                                        *branch(d['k']), *branch(d['v'])]]

    def f(h_bond, h, rel_pad, q, *w):
        return bond_attention_pallas(h_bond, h, rel_pad, q,
                                     jnp.asarray(d['mask']), *w,
                                     n_heads=heads, pos_mode=pos)

    out, vjp = jax.vjp(f, *primals)
    cot = d['g']
    if pos:
        cot = np.concatenate([cot, np.zeros((B, Nl, 1), np.float32)], -1)
    d_hb, d_h, d_rel, d_q, *dw = [np.asarray(a, np.float64)
                                  for a in vjp(jnp.asarray(cot))]

    # the port's gradients in the JAX kernel's terms
    got = dict(_flat(_factored(d, torch.float32)))
    h = d['h'].astype(np.float64)
    d_h_port = sum(np.einsum('bnc,jc->bnj', got[f'{t}.t_row'], d[t]['wi'])
                   + np.einsum('bnc,jc->bnj', got[f'{t}.t_src'], d[t]['wj'])
                   for t in 'kv')
    pairs = [('h_bond', got['h_bond'], d_hb), ('q', got['q'], d_q),
             ('h', d_h_port, d_h)]
    if pos:                    # rel = x_i - x_j
        dr = d_rel[..., :3]
        pairs.append(('x', got['x'], dr.sum(2) - dr.sum(1)))
    for i, tag in enumerate('kv'):
        we, wi, wj, wo, bo, be, lns, lnb = dw[8 * i:8 * i + 8]
        pairs += [(f'{tag}.w_feat', got[f'{tag}.w_feat'], we),
                  (f'{tag}.wi', np.einsum('bnj,bnc->jc', h,
                                          got[f'{tag}.t_row']), wi),
                  (f'{tag}.wj', np.einsum('bnj,bnc->jc', h,
                                          got[f'{tag}.t_src']), wj),
                  (f'{tag}.be', got[f'{tag}.t_row'].sum((0, 1)), be[0]),
                  (f'{tag}.wo', got[f'{tag}.wo'], wo),
                  (f'{tag}.bo', got[f'{tag}.bo'], bo[0]),
                  (f'{tag}.ln_scale', got[f'{tag}.ln_scale'], lns[0]),
                  (f'{tag}.ln_bias', got[f'{tag}.ln_bias'], lnb[0])]
    _assert_close([(n, a) for n, a, _ in pairs],
                  [(n, b) for n, _, b in pairs], 5e-4, 5e-5,
                  'factored vs JAX Pallas')
