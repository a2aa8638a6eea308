"""Dense bond-graph attention: wrapper, plain version and launch counts of
the CUDA kernels in csrc/bond_attention.cu, which replace the Pallas kernels
of decompdiff_tpu/ops/pallas/bond_kernel.py (forward _bond_fwd_call /
_bond_kernel, backward _bond_bwd_call / _bond_bwd_kernel).

For every ligand atom i (destination) and every ligand atom j (source):

    pre_m = h_bond[i, j] @ We_m + t_row_m[i] + t_src_m[j]            (m = k, v)
    k, v  = relu(LayerNorm(pre_m)) @ Wo_m + bo_m
    alpha = softmax over j under bond_mask[i, j] of the head-grouped q[i] . k
    node mode:  out[i] = sum_j alpha v                             [B, Nl, H]
    pos mode:   out[i] = sum_j mean_h(alpha v) (x_i - x_j)         [B, Nl, 3]

`t_row` is h @ Wi + be and `t_src` is h @ Wj; in pos mode Wo_v is [H, heads].

The forward launcher chooses its kernel by width: for H in 32, 64, 128 the
tensor-core kernel (csrc/row_mma.cuh, h_bond @ We included), for every
other width that check_heads admits the per-row kernel
(csrc/row_attention.cuh). It reports the route it took, and the per-row
launches also count in `bond_attention.row_launches`.

On CUDA tensors `bond_attention` is differentiable: its autograd node saves
only the inputs, and `bond_attention_backward` recomputes the rest in a
backward kernel. The launcher chooses that kernel by width and reports it:
for H in 32, 64, 128 with at most 16 heads and Nl up to 64 the
head-factorized kernel (csrc/head_bwd.cuh: q and the output cotangent belong
to the destination row, so the cotangents of k and v factorize by head and
no per-pair [H, H] product is left on the second linears' side; one block
per SM), which writes d pre of both branches to a device-memory buffer, and
then a tensor-core product kernel that forms d h_bond = d pre_k We_k^T +
d pre_v We_v^T and d We = h_bond^T d pre from it; otherwise the per-row
kernel (csrc/row_attention_bwd.cuh; two blocks per SM), whose launches
also count in `bond_attention_backward.row_launches`. Its launches with
the row buffers in a device-memory scratch (wide H; the launcher decides
and reports it) also count in `bond_attention_backward.scratch_launches`.
`bond_attention_backward_factored` is the head-factorized algorithm in
plain PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from decompdiff_tpu_torch.ops import _build
from decompdiff_tpu_torch.ops.common import (
    Branch, ParamGrads, attend, autograd_grads, backward_blocks,
    backward_scratch, branch_checks, branch_mlp, branch_ptrs, check_heads,
    check_inputs, feat_product, kernel_query, launch, on_cpu, ptr)


def bond_attention_reference(h_bond, x, mask, q, k: Branch, v: Branch, *,
                             n_heads: int, pos_mode: bool,
                             compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the order of the JAX dense
    path (models/uni_transformer_bond.py NodeBondAttention/PosBondAttention).
    compute_dtype: the JAX dense path's rounding of h_bond @ We under the
    config key (ops/common.py feat_product); the kernel has none."""
    def branch(p: Branch):
        pre = (feat_product(h_bond, p.w_feat, compute_dtype)
               + p.t_row[:, :, None, :] + p.t_src[:, None, :, :])
        return branch_mlp(pre, p)

    rel = x[:, :, None, :] - x[:, None, :, :] if pos_mode else None
    return attend(q, branch(k), branch(v), mask > 0.5, n_heads, rel)


def bond_attention_backward_reference(g, h_bond, x, mask, q, k: Branch,
                                      v: Branch, *, n_heads: int,
                                      pos_mode: bool):
    """Plain version of the backward: autograd through the plain forward.
    Returns (d_h_bond, d_x (None in node mode), d_q, d_k, d_v)."""
    def fn(h_bond, x, q, *kv):
        return bond_attention_reference(
            h_bond, x, mask, q, Branch(*kv[:7]), Branch(*kv[7:]),
            n_heads=n_heads, pos_mode=pos_mode)
    d = autograd_grads(fn, g, [h_bond, x if pos_mode else None, q, *k, *v])
    return d[0], d[1], d[2], Branch(*d[3:10]), Branch(*d[10:])


def bond_attention_backward_factored(g, h_bond, x, mask, q, k: Branch,
                                     v: Branch, *, n_heads: int,
                                     pos_mode: bool):
    """The head-factorized backward that the backward kernels compute at H
    in 32, 64, 128, in plain PyTorch (for tests; no path calls it). Returns
    what bond_attention_backward_reference returns.

    q[i] and the output cotangent g[i] belong to the destination row, so the
    cotangent of k factorizes by head, d k[j, c] = scale dh[j, h(c)] q[c],
    and in node mode that of v too, d v[j, c] = alpha[j, h(c)] g[c]. With
    Qk[h] = Wo_k[:, h] q[h] and Gv[h] = Wo_v[:, h] g[h] ([heads, H] per row)
    no per-pair [H, H] product is left on the second linears' side: the
    logits are scale (y_k . Qk[h] + q_h . bo_k,h), d alpha is y_v . Gv[h] +
    g_h . bo_v,h, d y_k = scale sum_h dh Qk[h] and d y_v = sum_h alpha
    Gv[h]; d q and d Wo come from the per-row sums Yd[h] = sum_j dh y_k and
    Ya[h] = sum_j alpha y_v. In pos mode Wo_v is already [H, heads]: v_h =
    y_v . Wo_v[:, h] + bo_v,h. The first linears' three [H, H] products per
    pair stay: pre = h_bond We (recomputed), d h_bond = d pre_k We_k^T +
    d pre_v We_v^T and d We = sum over pairs of h_bond^T d pre."""
    H = q.shape[-1]
    hd = H // n_heads
    scale = 1.0 / math.sqrt(hd)

    def recompute(p: Branch):
        pre = (h_bond @ p.w_feat + p.t_row[:, :, None, :]
               + p.t_src[:, None, :, :])
        mu = pre.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((pre - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
        xhat = (pre - mu) * rstd
        return xhat, rstd, torch.relu(xhat * p.ln_scale + p.ln_bias)

    def heads(t):                                   # [..., H] -> [..., NH, hd]
        return t.reshape(t.shape[:-1] + (n_heads, hd))

    xk, rk, yk = recompute(k)
    xv, rv, yv = recompute(v)
    wok = heads(k.wo)                               # [H(in), NH, hd]
    Qk = torch.einsum('xhd,bihd->bihx', wok, heads(q))
    logit = scale * (torch.einsum('bijx,bihx->bijh', yk, Qk)
                     + heads(q * k.bo).sum(-1)[:, :, None, :])
    if pos_mode:
        rel = x[:, :, None, :] - x[:, None, :, :]            # [B, i, j, 3]
        raw = yv @ v.wo + v.bo                               # v [B, i, j, NH]
        coef = (rel * g[:, :, None, :]).sum(-1)[..., None] / n_heads
    else:
        Gv = torch.einsum('xhd,bihd->bihx', heads(v.wo), heads(g))
        raw = (torch.einsum('bijx,bihx->bijh', yv, Gv)
               + heads(g * v.bo).sum(-1)[:, :, None, :])
        coef = 1.0
    valid = (mask > 0.5)[..., None]
    m = torch.where(valid, logit, -1e30).amax(2, keepdim=True).clamp_min(
        -1e29)
    e = torch.where(valid, torch.exp(logit - m), 0.0)
    alpha = e / e.sum(2, keepdim=True).clamp_min(1e-16)
    d_alpha = coef * raw
    dh = alpha * (d_alpha - (alpha * d_alpha).sum(2, keepdim=True))
    cv = alpha * coef                     # the v branch's head coefficients

    def branch_bwd(dy, xhat, rstd, y, p: Branch):
        du = torch.where(y > 0, dy, 0.0)
        dx = du * p.ln_scale
        d_pre = rstd * (dx - dx.mean(-1, keepdim=True)
                        - xhat * (dx * xhat).mean(-1, keepdim=True))
        return d_pre, (du * xhat).sum((0, 1, 2)), du.sum((0, 1, 2))

    dyk = scale * torch.einsum('bijh,bihx->bijx', dh, Qk)
    if pos_mode:
        dyv = cv @ v.wo.t()
    else:
        dyv = torch.einsum('bijh,bihx->bijx', cv, Gv)
    dpk, dlns_k, dlnb_k = branch_bwd(dyk, xk, rk, yk, k)
    dpv, dlns_v, dlnb_v = branch_bwd(dyv, xv, rv, yv, v)
    d_hb = dpk @ k.w_feat.t() + dpv @ v.w_feat.t()
    d_x = None
    if pos_mode:                          # d rel = sum_h alpha v / NH g
        d_rel = ((alpha * raw).sum(-1) / n_heads)[..., None] * g[:, :, None]
        d_x = d_rel.sum(2) - d_rel.sum(1)

    # the per-row sums: d q, d Wo and d bo
    Yd = torch.einsum('bijh,bijx->bihx', dh, yk)
    sdh, scv = dh.sum(2), cv.sum(2)                          # [B, Nl, NH]
    d_q = scale * (torch.einsum('bihx,xhd->bihd', Yd, wok)
                   + heads(k.bo) * sdh[..., None]).reshape(q.shape)
    dwo_k = scale * torch.einsum('bihx,bihd->xhd', Yd, heads(q)).reshape(H, H)
    dbo_k = scale * (heads(q) * sdh[..., None]).sum((0, 1)).reshape(H)
    if pos_mode:
        dwo_v = torch.einsum('bijx,bijh->xh', yv, cv)
        dbo_v = scv.sum((0, 1))
    else:
        Ya = torch.einsum('bijh,bijx->bihx', cv, yv)
        dwo_v = torch.einsum('bihx,bihd->xhd', Ya, heads(g)).reshape(H, H)
        dbo_v = (heads(g) * scv[..., None]).sum((0, 1)).reshape(H)

    def grads(d_pre, dwo, dbo, dlns, dlnb):
        return Branch(d_pre.sum(2), d_pre.sum(1),
                      torch.einsum('bijx,bijc->xc', h_bond, d_pre),
                      dwo, dbo, dlns, dlnb)

    return (d_hb, d_x, d_q, grads(dpk, dwo_k, dbo_k, dlns_k, dlnb_k),
            grads(dpv, dwo_v, dbo_v, dlns_v, dlnb_v))


def _checks(h_bond, x, mask, q, k, v, n_heads, pos_mode):
    """check_inputs entries of the kernel's inputs."""
    B, Nl, _, H = h_bond.shape
    check_heads(H, n_heads)
    if pos_mode and x is None:
        raise ValueError('pos mode needs the ligand coordinates x')
    f32 = torch.float32
    named = [('h_bond', h_bond, (B, Nl, Nl, H), f32),
             ('mask', mask, (B, Nl, Nl), f32), ('q', q, (B, Nl, H), f32)]
    if pos_mode:
        named.append(('x', x, (B, Nl, 3), f32))
    for tag, p, dout in (('k', k, H), ('v', v, n_heads if pos_mode else H)):
        named += branch_checks(tag, p, (B, Nl, H), (B, Nl, H), H, H, dout)
    return named


def _forward(h_bond, x, mask, q, k, v, n_heads, pos_mode):
    B, Nl, _, H = h_bond.shape
    check_inputs(q.device, _checks(h_bond, x, mask, q, k, v, n_heads,
                                   pos_mode))
    out = torch.empty((B, Nl, 3 if pos_mode else H), device=q.device,
                      dtype=torch.float32)
    row = ctypes.c_int(0)                 # 1: the per-row kernel launched
    fn = _build.load('bond_attention', 'bond_attention_fwd', 20, 5)
    args = ([ptr(h_bond), ptr(x if pos_mode else None), ptr(mask), ptr(q)]
            + branch_ptrs(k) + branch_ptrs(v) + [ptr(out), ctypes.byref(row)]
            + [B, Nl, H, n_heads, int(pos_mode)])
    launch(fn, args, q.device, 'bond_attention')
    bond_attention.launches += 1
    bond_attention.row_launches += row.value
    return out


class _BondAttention(torch.autograd.Function):
    """Forward kernel, saving only the inputs; backward kernel."""

    @staticmethod
    def forward(ctx, n_heads, pos_mode, h_bond, x, mask, q, *kv):
        ctx.opts = dict(n_heads=n_heads, pos_mode=pos_mode)
        ctx.save_for_backward(h_bond, x, mask, q, *kv)
        return _forward(h_bond, x, mask, q, Branch(*kv[:7]), Branch(*kv[7:]),
                        n_heads, pos_mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h_bond, x, mask, q, *kv = ctx.saved_tensors
        d_hb, d_x, d_q, dk, dv = bond_attention_backward(
            g.contiguous(), h_bond, x, mask, q, Branch(*kv[:7]),
            Branch(*kv[7:]), **ctx.opts)
        return (None, None, d_hb, d_x, None, d_q, *dk, *dv)


def bond_attention(h_bond: torch.Tensor, x: Optional[torch.Tensor],
                   mask: torch.Tensor, q: torch.Tensor, k: Branch, v: Branch,
                   *, n_heads: int, pos_mode: bool) -> torch.Tensor:
    """Args (float32): h_bond [B, Nl, Nl, H]; x [B, Nl, 3] ligand coordinates
    (pos mode only, else None); mask [B, Nl, Nl] bond mask; q [B, Nl, H];
    k, v: Branch with t_row / t_src [B, Nl, H], w_feat [H, H],
    wo [H, H] (v in pos mode [H, heads]), bo, ln_scale, ln_bias.
    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    its gradient launches the backward kernel.
    """
    if on_cpu(q):
        return bond_attention_reference(h_bond, x, mask, q, k, v,
                                        n_heads=n_heads, pos_mode=pos_mode)
    return _BondAttention.apply(n_heads, pos_mode, h_bond,
                                x if pos_mode else None, mask, q, *k, *v)


def bond_attention_backward(g: torch.Tensor, h_bond, x, mask, q, k: Branch,
                            v: Branch, *, n_heads: int, pos_mode: bool):
    """Gradients of bond_attention for the output cotangent g ([B, Nl, H],
    pos mode [B, Nl, 3]): (d_h_bond, d_x (None in node mode), d_q, d_k, d_v),
    d_k and d_v as Branch. CPU tensors run the plain version; CUDA tensors
    launch the backward kernel."""
    if on_cpu(q):
        return bond_attention_backward_reference(
            g, h_bond, x, mask, q, k, v, n_heads=n_heads, pos_mode=pos_mode)
    B, Nl, _, H = h_bond.shape
    named = _checks(h_bond, x, mask, q, k, v, n_heads, pos_mode)
    named.append(('g', g, (B, Nl, 3 if pos_mode else H), torch.float32))
    check_inputs(q.device, named)
    dev = q.device
    row = kernel_query('bond_attention', 'bond_attention_bwd_route',
                       (Nl, H, n_heads), dev)
    # the head route writes every element of d h_bond
    d_hb = (torch.zeros if row else torch.empty)((B, Nl, Nl, H), device=dev)
    d_x = torch.zeros((B, Nl, 3), device=dev) if pos_mode else None
    d_q, d_trow_k, d_trow_v = (torch.empty((B, Nl, H), device=dev)
                               for _ in range(3))
    d_tsrc_k, d_tsrc_v = (torch.zeros((B, Nl, H), device=dev)
                          for _ in range(2))
    blocks = backward_blocks(B * Nl, dev, per_sm=2 if row else 1)
    # the head route stores every element of its slots
    pg = ParamGrads(blocks, H, H, n_heads if pos_mode else H, dev,
                    stored=not row)
    # the per-row kernel alone reads the transposed weights and the scratch,
    # the head route alone the d pre buffer of both branches
    woT_k, weT_k, weT_v = ((w.t().contiguous() if row else None)
                           for w in (k.wo, k.w_feat, v.w_feat))
    woT_v = v.wo.t().contiguous() if row and not pos_mode else None
    scratch = (backward_scratch('bond_attention', [Nl, H, n_heads], blocks,
                                dev) if row else None)
    d_pre = None if row else torch.empty((2, B, Nl, Nl, H), device=dev)
    route = ctypes.c_int(0)               # 1: row buffers in the scratch
    launched_row = ctypes.c_int(0)        # 1: the per-row kernel launched
    fn = _build.load('bond_attention', 'bond_attention_bwd', 36, 6)
    args = ([ptr(h_bond), ptr(x if pos_mode else None), ptr(mask), ptr(q),
             ptr(g)] + branch_ptrs(k) + [ptr(woT_k), ptr(weT_k)]
            + branch_ptrs(v) + [ptr(woT_v), ptr(weT_v)]
            + [ptr(t) for t in (d_hb, d_x, d_q, d_trow_k, d_tsrc_k, d_trow_v,
                                d_tsrc_v, pg.slots, pg.out, scratch, d_pre)]
            + [ctypes.byref(route), ctypes.byref(launched_row), B, Nl, H,
               n_heads, int(pos_mode), blocks])
    launch(fn, args, dev, 'bond_attention_backward')
    bond_attention_backward.launches += 1
    bond_attention_backward.scratch_launches += route.value
    bond_attention_backward.row_launches += launched_row.value
    dk, dv = pg.branches(d_trow_k, d_tsrc_k, d_trow_v, d_tsrc_v)
    return d_hb, d_x, d_q, dk, dv


bond_attention.launches = bond_attention.row_launches = 0
bond_attention_backward.launches = 0
bond_attention_backward.scratch_launches = 0
bond_attention_backward.row_launches = 0
