"""The head-factorized triplet-attention backward (the algorithm of the
backward kernel at H in 32, 64, 128, csrc/head_bwd.cuh), as its plain
PyTorch version `triplet_attention_backward_factored`, against two
references on the same seeded inputs:

- the plain autograd backward (`triplet_attention_backward_reference`) in
  float64, at rtol 1e-5 / atol 1e-6 x max(1, |grad|max): the same function
  with the sums in another order (its masked softmax, which casts to
  float32 for the model, is kept in float64 here, so that d bo_k, 0 in
  exact arithmetic, is not float32 noise);
- jax.grad (jax.vjp) of the JAX package's Pallas triplet kernel in interpret
  mode, in float32, at rtol 5e-4 / atol 5e-5 x max(1, |grad|max), the
  kernel-gradient tolerance of tests/test_pallas_triplet_grad.py.

Cases: H = 32 with 4 heads and H = 128 with 16 heads, Nl = 8 and Nl = 40
(two 32-source chunks in the kernel), and H = 32 with 4 heads at Nl = 64,
the top of the ligand ladder (two full chunks; the kernel's d t_src sums in
device memory); atom 4 of complex 0 has no bonds and complex 1 none at all
(its gradients are zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu.ops.pallas.triplet_kernel import triplet_attention_pallas
from decompdiff_tpu_torch.ops import common as ops_common
from decompdiff_tpu_torch.ops import triplet_attention as triplet_ops
from decompdiff_tpu_torch.ops.common import Branch

torch.set_num_threads(2)
CASES = [(32, 4, 8), (32, 4, 40), (128, 16, 8), (128, 16, 40),
         (32, 4, 64)]
IDS = [f'H{h}-Nl{n}' for h, _, n in CASES]


def _inputs(H, Nl, B=2, seed=0):
    """numpy inputs: angle, bond mask, q, g and both branches' fields."""
    rng = np.random.default_rng(seed + H + Nl)

    def r(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def branch():
        return dict(t_row=r(B, Nl, Nl, H, scale=1.0),
                    t_src=r(B, Nl, Nl, H, scale=1.0), w_feat=r(13, H),
                    wo=r(H, H), bo=r(H), ln_scale=1.0 + r(H), ln_bias=r(H))

    bm = ((rng.random((B, Nl, Nl)) < 0.4)
          & ~np.eye(Nl, dtype=bool)).astype(np.float32)
    bm[0, 4] = 0.0                         # atom 4 of complex 0: no bonds
    bm[1] = 0.0                            # complex 1: no bonds
    angle = (rng.random((B, Nl, Nl, Nl)) * np.pi).astype(np.float32)
    return dict(angle=angle, mask=bm, q=r(B, Nl, Nl, H, scale=1.0),
                g=r(B, Nl, Nl, H, scale=1.0), k=branch(), v=branch())


def _torch(d, dtype):
    t = {n: torch.as_tensor(d[n], dtype=dtype)
         for n in ('angle', 'mask', 'q', 'g')}
    for b in ('k', 'v'):
        t[b] = Branch(*(torch.as_tensor(d[b][f], dtype=dtype)
                        for f in Branch._fields))
    return t


def _flat(grads):
    """(label, array) of every gradient of a backward wrapper's result."""
    d_angle, d_q, dk, dv = grads
    out = [('angle', d_angle), ('q', d_q)]
    for tag, br in (('k', dk), ('v', dv)):
        out += [(f'{tag}.{f}', getattr(br, f)) for f in Branch._fields]
    return [(n, np.asarray(a.detach().numpy() if torch.is_tensor(a) else a,
                           np.float64)) for n, a in out]


def _assert_close(got, want, rtol, atol, label):
    for (name, a), (_, b) in zip(got, want):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                                   err_msg=f'{label}: d {name}')


def _factored(d, dtype):
    t = _torch(d, dtype)
    return triplet_ops.triplet_attention_backward_factored(
        t['g'], t['angle'], t['mask'], t['q'], t['k'], t['v'],
        n_heads=d['heads'])


def _softmax_in_dtype(logits, mask, dim):
    """models.common.masked_softmax without its cast to float32."""
    masked = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    m = masked.amax(dim=dim, keepdim=True)
    e = torch.where(mask, torch.exp(masked - m), 0.0)
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-16)


@pytest.mark.parametrize('H,heads,Nl', CASES, ids=IDS)
def test_factored_backward_matches_autograd(H, heads, Nl, monkeypatch):
    monkeypatch.setattr(ops_common, 'masked_softmax', _softmax_in_dtype)
    d = dict(_inputs(H, Nl), heads=heads)
    t = _torch(d, torch.float64)
    want = _flat(triplet_ops.triplet_attention_backward_reference(
        t['g'], t['angle'], t['mask'], t['q'], t['k'], t['v'],
        n_heads=heads))
    got = _flat(_factored(d, torch.float64))
    _assert_close(got, want, 1e-5, 1e-6, 'factored vs autograd')
    zero = [a[1] for _, a in got if a.ndim == 4]    # complex 1: no bonds
    assert all(float(np.abs(a).max()) == 0.0 for a in zero)


@pytest.mark.parametrize('H,heads,Nl', CASES, ids=IDS)
def test_factored_backward_matches_jax_pallas(H, heads, Nl):
    d = dict(_inputs(H, Nl), heads=heads)

    def jax_branch(p):
        wa = np.zeros((16, H), np.float32)
        wa[:13] = p['w_feat']
        return (jnp.asarray(wa), jnp.asarray(p['wo']),
                jnp.asarray(p['bo'][None]), jnp.asarray(p['ln_scale'][None]),
                jnp.asarray(p['ln_bias'][None]))

    def f(angle, tkj_k, tij_k, tkj_v, tij_v, q, wk, wv):
        return triplet_attention_pallas(angle, tkj_k, tij_k, tkj_v, tij_v,
                                        q, jnp.asarray(d['mask']), *wk, *wv,
                                        n_heads=heads)

    k, v = d['k'], d['v']
    primals = (jnp.asarray(d['angle']), jnp.asarray(k['t_src']),
               jnp.asarray(k['t_row']), jnp.asarray(v['t_src']),
               jnp.asarray(v['t_row']), jnp.asarray(d['q']), jax_branch(k),
               jax_branch(v))
    _, vjp = jax.vjp(f, *primals)
    (d_angle, d_tsrc_k, d_trow_k, d_tsrc_v, d_trow_v, d_q, wk,
     wv) = vjp(jnp.asarray(d['g']))

    def branch(t_row, t_src, w):
        return Branch(t_row, t_src, np.asarray(w[0])[:13], w[1], w[2][0],
                      w[3][0], w[4][0])
    want = _flat((d_angle, d_q, branch(d_trow_k, d_tsrc_k, wk),
                  branch(d_trow_v, d_tsrc_v, wv)))
    got = _flat(_factored(d, torch.float32))
    _assert_close(got, want, 5e-4, 5e-5, 'factored vs JAX Pallas')
