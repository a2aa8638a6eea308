"""kNN edge attention: wrapper, plain version and launch counts of the CUDA
kernels in csrc/edge_attention.cu, which replace the Pallas kernels of
decompdiff_tpu/ops/pallas/edge_kernel.py (forward _edge_fwd_call /
_edge_kernel, backward _edge_bwd_call / _edge_bwd_kernel).

For every destination node i and each of its K kNN sources s = idx[i, k]:

    edge_type = 4-way one-hot of (src is ligand, dst is ligand)
                [+ 2-way one-hot of same decomposition group]
    edge_feat = [outer(edge_type, RBF20(|x_i - xs_s|)), edge_type]  (F*21)
    pre_m     = edge_feat @ We_m + t_row_m[i] + t_src_m[s]          (m = k, v)
    k, v      = relu(LayerNorm(pre_m)) @ Wo_m + bo_m
    [gate = (wm, bm), node mode only: v *= sigmoid(v . wm + bm)]
    v *= e_w
    alpha     = masked softmax over K of the head-grouped q[i] . k / sqrt(hd)
    node mode:  out[i] = sum_k alpha v                              [B, N, H]
    pos mode:   out[i] = sum_k mean_h(alpha v) (x_i - xs_s)         [B, N, 3]

`t_row` is h @ Wi + be and `t_src` is h @ Wj (per-node products, computed
by the caller with torch.matmul); in pos mode Wo_v is [H, heads]. `xs` is
the source coordinates `x_src`, or x when there is none.

The gate is the uni_o2 net's ew_net_type 'm' (edge_kernel.py m_gate); the
kernels take it as a template parameter, and its launches are counted apart
(`edge_attention.gated_launches`, `edge_attention_backward.gated_launches`)
from the ungated ones (`.launches`).

`x_src` [B, N, 3] carries the TPU kernel's gather_bf16 table (config key
`pallas_gather_bf16`, edge_kernel.py _split_hjT): the sources' coordinates
rebuilt from bf16 hi + lo, beside the float32 x of the destinations. The
caller forms it (models/uni_transformer_bond.py, with t_src from
bf16-rounded h). Launches with an x_src are counted apart
(`edge_attention.gather_launches`, `edge_attention_backward.gather_launches`),
and its gradient is returned apart from that of x.

The forward launcher chooses its kernel by width: for H in 32, 64, 128 the
tensor-core kernel (csrc/row_mma.cuh), for every other width that
check_heads admits the per-row kernel (csrc/row_attention.cuh). It reports
the route it took, and the per-row launches, of any mode, also count in
`edge_attention.row_launches`.

`rows` = (start, count), the destination-row window, is the same for every
molecule: only rows start .. start + count - 1 are computed, every other
row's output is exactly 0 and carries no gradient, and None computes every
row. Each refine-net layer's coordinate (pos-mode) attention passes the
rows after the protein block, the only rows whose update it keeps
(movable is False on the protein), from num_protein and N alone, so no
host synchronisation. The kernel's tile map walks only
the window's tiles, and the same launch writes the zeros outside it; each
window row is bitwise the row computed without the window, since a row's
arithmetic never reads another's (csrc/edge_attention.cu). Launches with a
window count in `edge_attention.window_launches`, and while recording is
on (utils/profiling.py) add the rows they compute, B * count, to the
counter `ops.edge_attention.rows` and B * N to `ops.edge_attention.rows_all`.
The backward kernels take the window only to read the cotangent's rows
outside it as 0 (in the refine nets those are 0 already: movable is False
there); they still walk every row, since training, the one caller of the
backward, is paced by the host.

On CUDA tensors `edge_attention` is differentiable: its autograd node saves
only the inputs, and `edge_attention_backward` recomputes the rest in a
backward kernel and returns the gradients of x, e_w, q, both branches, the
gate and x_src. The launcher chooses that kernel by width and reports it,
in every mode (node, pos, gated, gather): for H in 32, 64, 128 with at most
16 heads and K up to 64 the head-factorized kernel (csrc/head_bwd.cuh: q
and the output cotangent belong to the destination row, so the cotangents
of k and v factorize by head and no per-edge [H, H] product is left; one
block per SM), otherwise the per-row kernel (csrc/row_attention_bwd.cuh;
two blocks per SM), whose launches also count in
`edge_attention_backward.row_launches`. Where the per-row kernel's
per-block row buffers do not fit in shared memory (wide H or many
sources), the launcher says how many floats a block needs, the wrapper
allocates that scratch in device memory, and the launcher reports the
route it took: such launches also count in
`edge_attention_backward.scratch_launches` (the same for the bond and
triplet backward). `edge_attention_backward_factored` is the
head-factorized algorithm in plain PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from decompdiff_tpu_torch.models.common import (
    FIXED_RBF_OFFSETS, fixed_rbf, outer_product, safe_norm)
from decompdiff_tpu_torch.ops import _build
from decompdiff_tpu_torch.ops.common import (
    Branch, ParamGrads, attend, autograd_grads, backward_blocks,
    backward_scratch, branch_checks, branch_mlp, branch_ptrs, check_heads,
    check_inputs, feat_product, kernel_query, launch, on_cpu, ptr)
from decompdiff_tpu_torch.utils.profiling import count, span

Gate = Tuple[torch.Tensor, torch.Tensor]   # (wm [H], bm [1])
Rows = Tuple[int, int]                     # (start, count) of every molecule


def _row_window(rows: Optional[Rows], N: int) -> Optional[Rows]:
    """rows as (start, count) ints, or None for every row; raises unless
    the window lies in [0, N]."""
    if rows is None:
        return None
    start, n = (int(r) for r in rows)
    if start < 0 or n < 0 or start + n > N:
        raise ValueError(f'row window {tuple(rows)} outside [0, {N}]')
    return start, n


def _zero_outside(out: torch.Tensor, rows: Optional[Rows]) -> torch.Tensor:
    """out [B, N, C] with the rows outside the window exactly 0."""
    if rows is None:
        return out
    i = torch.arange(out.shape[1], device=out.device)
    keep = (i >= rows[0]) & (i < rows[0] + rows[1])
    return torch.where(keep[:, None], out, 0.0)


def gather_nodes(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """h [B, N, F], idx [B, N, K] -> [B, N, K, F]."""
    B, N, K = idx.shape
    flat = idx.reshape(B, N * K, 1).long().expand(-1, -1, h.shape[-1])
    return torch.gather(h, 1, flat).reshape(B, N, K, h.shape[-1])


def edge_types(lig: torch.Tensor, group: Optional[torch.Tensor],
               idx: torch.Tensor) -> torch.Tensor:
    """[B, N, K, 4 or 6] one-hot edge types: (src ligand?, dst ligand?), then
    with groups (same group?)."""
    lig_src = gather_nodes(lig[..., None], idx)[..., 0] > 0.5
    lig_dst = (lig > 0.5)[:, :, None]
    type_id = torch.where(lig_src & lig_dst, 0,
                          torch.where(lig_src & ~lig_dst, 1,
                                      torch.where(~lig_src & lig_dst, 2, 3)))
    edge_type = F.one_hot(type_id, 4).to(lig.dtype)
    if group is not None:
        same = gather_nodes(group[..., None], idx)[..., 0] == group[:, :, None]
        edge_type = torch.cat(
            [edge_type, F.one_hot(same.long(), 2).to(lig.dtype)], dim=-1)
    return edge_type


def _node_mode_gate(gate: Optional[Gate], pos_mode: bool) -> None:
    if gate is not None and pos_mode:
        raise ValueError("the m-gate applies in node mode only (ew_net_type "
                         "'m' is the identity for coordinate updates)")


def edge_attention_reference(x, lig, group, idx, mask, e_w, q,
                             k: Branch, v: Branch, *, n_heads: int,
                             pos_mode: bool, gate: Optional[Gate] = None,
                             x_src: Optional[torch.Tensor] = None,
                             compute_dtype: Optional[torch.dtype] = None,
                             rows: Optional[Rows] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the order of the JAX dense
    path (models/uni_transformer_bond.py NodeEdgeAttention/PosEdgeAttention,
    models/uni_transformer.py X2HAttention for the gate); with x_src, the
    order of the JAX kernel's gather_bf16 path (edge_kernel.py:172-175).
    compute_dtype: the JAX dense path's rounding of edge_feat @ We under
    the config key (ops/common.py feat_product); the kernel has none.
    rows: the window, honoured by zeroing every other row of the output
    (computed all the same)."""
    _node_mode_gate(gate, pos_mode)
    rows = _row_window(rows, idx.shape[1])
    xs = x if x_src is None else x_src
    rel = x[:, :, None, :] - gather_nodes(xs, idx)           # x_dst - x_src
    dist = safe_norm(rel, dim=-1)
    edge_type = edge_types(lig, group, idx)
    edge_feat = torch.cat([outer_product(edge_type, fixed_rbf(dist)),
                           edge_type], dim=-1)

    def branch(p: Branch):
        pre = (feat_product(edge_feat, p.w_feat, compute_dtype)
               + p.t_row[:, :, None, :] + gather_nodes(p.t_src, idx))
        return branch_mlp(pre, p)

    kk = branch(k)
    vv = branch(v)
    if gate is not None:
        wm, bm = gate
        vv = vv * torch.sigmoid(vv @ wm[:, None] + bm)
    vv = vv * e_w[..., None]
    return _zero_outside(
        attend(q, kk, vv, mask > 0.5, n_heads, rel if pos_mode else None),
        rows)


def edge_attention_backward_reference(g, x, lig, group, idx, mask, e_w, q,
                                      k: Branch, v: Branch, *, n_heads: int,
                                      pos_mode: bool,
                                      gate: Optional[Gate] = None,
                                      x_src: Optional[torch.Tensor] = None,
                                      rows: Optional[Rows] = None):
    """Plain version of the backward: autograd through the plain forward.
    Returns (d_x, d_e_w, d_q, d_k, d_v), d_k and d_v as Branch, then with a
    gate (d_wm, d_bm) and with an x_src d_x_src."""
    def fn(x, e_w, q, x_src, *params):
        return edge_attention_reference(
            x, lig, group, idx, mask, e_w, q, Branch(*params[:7]),
            Branch(*params[7:14]), n_heads=n_heads, pos_mode=pos_mode,
            gate=tuple(params[14:]) or None, x_src=x_src, rows=rows)
    d = autograd_grads(fn, g, [x, e_w, q, x_src, *k, *v, *(gate or ())])
    grads = (d[0], d[1], d[2], Branch(*d[4:11]), Branch(*d[11:18]))
    if gate is not None:
        grads += (tuple(d[18:]),)
    return grads if x_src is None else grads + (d[3],)


def edge_attention_backward_factored(g, x, lig, group, idx, mask, e_w, q,
                                     k: Branch, v: Branch, *, n_heads: int,
                                     pos_mode: bool,
                                     gate: Optional[Gate] = None,
                                     x_src: Optional[torch.Tensor] = None):
    """The head-factorized backward that the backward kernel computes at H
    in 32, 64, 128, in plain PyTorch (for tests; no path calls it). Returns
    what edge_attention_backward_reference returns.

    q[i] and the output cotangent g[i] belong to the destination row, so the
    cotangent of k factorizes by head, d k[s, c] = scale dh[s, h(c)] q[c],
    and in node mode that of v too, d v[s, c] = alpha[s, h(c)] e_w g[c]
    (times the m-gate). With Qk[h] = Wo_k[:, h] q[h] and Gv[h] =
    Wo_v[:, h] g[h] ([heads, H] per row) no per-edge [H, H] product is left:
    the logits are scale (y_k . Qk[h] + q_h . bo_k,h), d alpha is e_w
    (y_v . Gv[h] + g_h . bo_v,h), d y_k = scale sum_h dh Qk[h] and d y_v =
    e_w sum_h alpha Gv[h]; d q and d Wo come from the per-row sums
    Yd[h] = sum_s dh y_k and Ya[h] = sum_s e_w alpha y_v. In pos mode Wo_v
    is already [H, heads]: v_h = y_v . Wo_v[:, h] + bo_v,h. The m-gate
    sigmoid(s), s = y_v . (Wo_v wm) + bo_v . wm + bm, adds the heads-wide
    vector Wo_v wm: d y_v gains d s Wo_v wm, d Wo_v the outer product of
    Ys = sum_s d s y_v with wm, and d wm = Wo_v^T Ys + bo_v sum_s d s."""
    _node_mode_gate(gate, pos_mode)
    B, N, K = idx.shape
    H = q.shape[-1]
    hd = H // n_heads
    scale = 1.0 / math.sqrt(hd)
    xs = x if x_src is None else x_src
    rel = x[:, :, None, :] - gather_nodes(xs, idx)           # [B, N, K, 3]
    d2 = (rel * rel).sum(-1)
    dist = safe_norm(rel, dim=-1)
    edge_type = edge_types(lig, group, idx)                  # [B, N, K, F]
    rbf = fixed_rbf(dist)                                    # [B, N, K, 20]
    edge_feat = torch.cat([outer_product(edge_type, rbf), edge_type], -1)

    def recompute(p: Branch):
        pre = (edge_feat @ p.w_feat + p.t_row[:, :, None, :]
               + gather_nodes(p.t_src, idx))
        mu = pre.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((pre - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
        xhat = (pre - mu) * rstd
        return xhat, rstd, torch.relu(xhat * p.ln_scale + p.ln_bias)

    def heads(t):                                   # [..., H] -> [..., NH, hd]
        return t.reshape(t.shape[:-1] + (n_heads, hd))

    xk, rk, yk = recompute(k)
    xv, rv, yv = recompute(v)
    wok = heads(k.wo)                               # [H(in), NH, hd]
    Qk = torch.einsum('xhd,bnhd->bnhx', wok, heads(q))
    logit = scale * (torch.einsum('bnkx,bnhx->bnkh', yk, Qk)
                     + heads(q * k.bo).sum(-1)[:, :, None, :])
    ew = e_w[..., None]
    if pos_mode:
        vh = yv @ v.wo + v.bo                       # [B, N, K, NH]
        gr = (rel * g[:, :, None, :]).sum(-1)[..., None]
        raw, coef = vh, ew * gr / n_heads
    else:
        Gv = torch.einsum('xhd,bnhd->bnhx', heads(v.wo), heads(g))
        raw = (torch.einsum('bnkx,bnhx->bnkh', yv, Gv)
               + heads(g * v.bo).sum(-1)[:, :, None, :])
        gt = 1.0
        if gate is not None:
            wm, bm = gate
            wvm = v.wo @ wm
            gt = torch.sigmoid(yv @ wvm + v.bo @ wm + bm)[..., None]
        coef = ew * gt
    valid = (mask > 0.5)[..., None]
    m = torch.where(valid, logit, -1e30).amax(2, keepdim=True).clamp_min(
        -1e29)
    e = torch.where(valid, torch.exp(logit - m), 0.0)
    alpha = e / e.sum(2, keepdim=True).clamp_min(1e-16)
    d_alpha = coef * raw
    dh = alpha * (d_alpha - (alpha * d_alpha).sum(2, keepdim=True))
    cv = alpha * coef                     # the v branch's head coefficients
    dew = (alpha * raw).sum(-1)                              # [B, N, K]
    if pos_mode:
        d_ew, wr = dew * gr[..., 0] / n_heads, dew * e_w / n_heads
    elif gate is not None:
        ds = e_w * dew * gt[..., 0] * (1.0 - gt[..., 0])
        d_ew = dew * gt[..., 0]
    else:
        d_ew = dew

    def branch_bwd(dy, xhat, rstd, y, p: Branch):
        du = torch.where(y > 0, dy, 0.0)
        dx = du * p.ln_scale
        d_pre = rstd * (dx - dx.mean(-1, keepdim=True)
                        - xhat * (dx * xhat).mean(-1, keepdim=True))
        return d_pre, (du * xhat).sum((0, 1, 2)), du.sum((0, 1, 2))

    dyk = scale * torch.einsum('bnkh,bnhx->bnkx', dh, Qk)
    if pos_mode:
        dyv = cv @ v.wo.t()
    else:
        dyv = torch.einsum('bnkh,bnhx->bnkx', cv, Gv)
        if gate is not None:
            dyv = dyv + ds[..., None] * wvm
    dpk, dlns_k, dlnb_k = branch_bwd(dyk, xk, rk, yk, k)
    dpv, dlns_v, dlnb_v = branch_bwd(dyv, xv, rv, yv, v)

    # the edge features: d w_feat, and d dist through the RBF chain
    d_feat = dpk @ k.w_feat.t() + dpv @ v.w_feat.t()        # [B, N, K, F*21]
    n_et = edge_type.shape[-1]
    d_rbf = (d_feat[..., :n_et * 20].reshape(B, N, K, n_et, 20)
             * edge_type[..., None]).sum(-2)
    offsets = torch.as_tensor(FIXED_RBF_OFFSETS, dtype=rbf.dtype,
                              device=rbf.device)
    d_dist = (d_rbf * rbf * (offsets - dist[..., None])).sum(-1)
    d_rel = torch.where(d2 >= 1e-12, d_dist / dist, 0.0)[..., None] * rel
    if pos_mode:
        d_rel = d_rel + wr[..., None] * g[:, :, None, :]
    d_x = d_rel.sum(2)
    flat = (idx.long() + N * torch.arange(B, device=idx.device)[:, None, None]
            ).reshape(-1)

    def scatter(t):                       # [B, N, K, C] -> [B, N, C] at idx
        out = torch.zeros((B * N, t.shape[-1]), dtype=t.dtype,
                          device=t.device)
        return out.index_add_(0, flat, t.reshape(B * N * K, -1)).reshape(
            B, N, -1)
    d_xs = -scatter(d_rel)
    if x_src is None:
        d_x = d_x + d_xs

    # the per-row sums: d q, d Wo and d bo
    Yd = torch.einsum('bnkh,bnkx->bnhx', dh, yk)
    sdh, scv = dh.sum(2), cv.sum(2)                          # [B, N, NH]
    d_q = scale * (torch.einsum('bnhx,xhd->bnhd', Yd, wok)
                   + heads(k.bo) * sdh[..., None]).reshape(q.shape)
    dwo_k = scale * torch.einsum('bnhx,bnhd->xhd', Yd, heads(q)).reshape(H, H)
    dbo_k = scale * (heads(q) * sdh[..., None]).sum((0, 1)).reshape(H)
    if pos_mode:
        dwo_v = torch.einsum('bnkx,bnkh->xh', yv, cv)
        dbo_v = scv.sum((0, 1))
    else:
        Ya = torch.einsum('bnkh,bnkx->bnhx', cv, yv)
        dwo_v = torch.einsum('bnhx,bnhd->xhd', Ya, heads(g)).reshape(H, H)
        dbo_v = (heads(g) * scv[..., None]).sum((0, 1)).reshape(H)
        if gate is not None:
            Ys = torch.einsum('bnk,bnkx->x', ds, yv)
            dsum = ds.sum()
            dwo_v = dwo_v + Ys[:, None] * wm
            dbo_v = dbo_v + wm * dsum
            d_gate = (v.wo.t() @ Ys + v.bo * dsum, dsum.reshape(1))

    def grads(d_pre, dwo, dbo, dlns, dlnb):
        return Branch(d_pre.sum(2), scatter(d_pre),
                      torch.einsum('bnkf,bnkc->fc', edge_feat, d_pre),
                      dwo, dbo, dlns, dlnb)

    out = (d_x, d_ew, d_q, grads(dpk, dwo_k, dbo_k, dlns_k, dlnb_k),
           grads(dpv, dwo_v, dbo_v, dlns_v, dlnb_v))
    if gate is not None:
        out += (d_gate,)
    return out if x_src is None else out + (d_xs,)


def _checks(x, lig, group, idx, mask, e_w, q, k, v, n_heads, pos_mode, gate,
            x_src):
    """check_inputs entries of the kernel's inputs, and the edge-type count."""
    _node_mode_gate(gate, pos_mode)
    B, N, K = idx.shape
    H = q.shape[-1]
    check_heads(H, n_heads)
    f32 = torch.float32
    n_et = 4 if group is None else 6
    named = [('x', x, (B, N, 3), f32), ('lig', lig, (B, N), f32),
             ('idx', idx, (B, N, K), torch.int32),
             ('mask', mask, (B, N, K), f32), ('e_w', e_w, (B, N, K), f32),
             ('q', q, (B, N, H), f32)]
    if group is not None:
        named.append(('group', group, (B, N), f32))
    if x_src is not None:
        named.append(('x_src', x_src, (B, N, 3), f32))
    for tag, p, dout in (('k', k, H), ('v', v, n_heads if pos_mode else H)):
        named += branch_checks(tag, p, (B, N, H), (B, N, H), n_et * 21, H,
                               dout)
    if gate is not None:
        named += [('gate.wm', gate[0], (H,), f32),
                  ('gate.bm', gate[1], (1,), f32)]
    return named, n_et


def _count(counter, gate, x_src) -> None:
    """One launch of `counter` (a wrapper) in the counter of its mode."""
    if gate is not None:
        counter.gated_launches += 1
    elif x_src is not None:
        counter.gather_launches += 1
    else:
        counter.launches += 1


def _forward(x, lig, group, idx, mask, e_w, q, k, v, n_heads, pos_mode,
             gate, x_src, rows):
    B, N, K = idx.shape
    H = q.shape[-1]
    named, n_et = _checks(x, lig, group, idx, mask, e_w, q, k, v, n_heads,
                          pos_mode, gate, x_src)
    check_inputs(q.device, named)
    start, n = rows or (0, N)
    out = torch.empty((B, N, 3 if pos_mode else H), device=q.device,
                      dtype=torch.float32)
    wm, bm = gate or (None, None)
    row = ctypes.c_int(0)                 # 1: the per-row kernel launched
    fn = _build.load('edge_attention', 'edge_attention_fwd', 26, 9)
    args = ([ptr(x), ptr(x if x_src is None else x_src), ptr(lig),
             ptr(group), ptr(idx), ptr(mask), ptr(e_w), ptr(q)]
            + branch_ptrs(k) + branch_ptrs(v)
            + [ptr(wm), ptr(bm), ptr(out), ctypes.byref(row)]
            + [B, N, K, H, n_heads, n_et, int(pos_mode), start, n])
    launch(fn, args, q.device, 'edge_attention')
    _count(edge_attention, gate, x_src)
    edge_attention.row_launches += row.value
    if rows is not None:
        edge_attention.window_launches += 1
        count('ops.edge_attention.rows', B * n)
        count('ops.edge_attention.rows_all', B * N)
    return out


class _EdgeAttention(torch.autograd.Function):
    """Forward kernel, saving only the inputs and the window; backward
    kernel. `params` is the k and v Branch fields, then wm and bm with a
    gate."""

    @staticmethod
    def forward(ctx, n_heads, pos_mode, rows, x, x_src, lig, group, idx,
                mask, e_w, q, *params):
        ctx.opts = dict(n_heads=n_heads, pos_mode=pos_mode, rows=rows)
        ctx.save_for_backward(x, x_src, lig, group, idx, mask, e_w, q,
                              *params)
        return _forward(x, lig, group, idx, mask, e_w, q,
                        Branch(*params[:7]), Branch(*params[7:14]), n_heads,
                        pos_mode, tuple(params[14:]) or None, x_src, rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, x_src, lig, group, idx, mask, e_w, q, *params = ctx.saved_tensors
        gate = tuple(params[14:]) or None
        with span('ops.edge_attention.backward'):
            d_x, d_ew, d_q, dk, dv, *rest = edge_attention_backward(
                g.contiguous(), x, lig, group, idx, mask, e_w, q,
                Branch(*params[:7]), Branch(*params[7:14]), gate=gate,
                x_src=x_src, **ctx.opts)
        d_gate = rest.pop(0) if gate is not None else ()
        d_xs = rest.pop(0) if x_src is not None else None
        return (None, None, None, d_x, d_xs, None, None, None, None, d_ew,
                d_q, *dk, *dv, *d_gate)


def edge_attention(x: torch.Tensor, lig: torch.Tensor,
                   group: Optional[torch.Tensor], idx: torch.Tensor,
                   mask: torch.Tensor, e_w: torch.Tensor, q: torch.Tensor,
                   k: Branch, v: Branch, *, n_heads: int, pos_mode: bool,
                   gate: Optional[Gate] = None,
                   x_src: Optional[torch.Tensor] = None,
                   rows: Optional[Rows] = None) -> torch.Tensor:
    """Args (float32 unless noted):
        x [B, N, 3] coordinates; lig [B, N] 1.0 on ligand(+prior) nodes;
        group [B, N] decomposition group ids, or None for 4 edge types;
        idx [B, N, K] int32 sources; mask / e_w [B, N, K]; q [B, N, H];
        k, v: Branch with t_row / t_src [B, N, H], w_feat [F*21, H],
        wo [H, H] (v in pos mode [H, heads]), bo, ln_scale, ln_bias;
        gate: optional m-gate (wm [H], bm [1]), node mode only;
        x_src: optional [B, N, 3] coordinates the sources are read from
        (the gather_bf16 hi + lo table), None for x;
        rows: optional (start, count) destination-row window of every
        molecule, in [0, N]; the other rows' output is 0.
    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    its gradient launches the backward kernel.
    """
    rows = _row_window(rows, idx.shape[1])
    with span('ops.edge_attention'):
        if on_cpu(q):
            return edge_attention_reference(
                x, lig, group, idx, mask, e_w, q, k, v, n_heads=n_heads,
                pos_mode=pos_mode, gate=gate, x_src=x_src, rows=rows)
        return _EdgeAttention.apply(n_heads, pos_mode, rows, x, x_src, lig,
                                    group, idx, mask, e_w, q, *k, *v,
                                    *(gate or ()))


def edge_attention_backward(g: torch.Tensor, x, lig, group, idx, mask, e_w,
                            q, k: Branch, v: Branch, *, n_heads: int,
                            pos_mode: bool, gate: Optional[Gate] = None,
                            x_src: Optional[torch.Tensor] = None,
                            rows: Optional[Rows] = None):
    """Gradients of edge_attention for the output cotangent g ([B, N, H],
    pos mode [B, N, 3]): (d_x, d_e_w, d_q, d_k, d_v), d_k and d_v as Branch
    (d t_row, d t_src and the five parameter gradients), then with a gate
    (d_wm, d_bm), and with an x_src d_x_src (d_x then holds only the
    destinations' part); with a row window, those of the windowed forward
    (g's rows outside it count as 0). CPU tensors run the plain version;
    CUDA tensors launch the backward kernel."""
    rows = _row_window(rows, idx.shape[1])
    if on_cpu(q):
        return edge_attention_backward_reference(
            g, x, lig, group, idx, mask, e_w, q, k, v, n_heads=n_heads,
            pos_mode=pos_mode, gate=gate, x_src=x_src, rows=rows)
    B, N, K = idx.shape
    H = q.shape[-1]
    named, n_et = _checks(x, lig, group, idx, mask, e_w, q, k, v, n_heads,
                          pos_mode, gate, x_src)
    named.append(('g', g, (B, N, 3 if pos_mode else H), torch.float32))
    check_inputs(q.device, named)
    dev = q.device
    start, n = rows or (0, N)
    d_x = torch.zeros((B, N, 3), device=dev)
    d_xs = None if x_src is None else torch.zeros((B, N, 3), device=dev)
    d_ew = torch.empty((B, N, K), device=dev)
    d_q, d_trow_k, d_trow_v = (torch.empty((B, N, H), device=dev)
                               for _ in range(3))
    d_tsrc_k, d_tsrc_v = (torch.zeros((B, N, H), device=dev)
                          for _ in range(2))
    row = kernel_query('edge_attention', 'edge_attention_bwd_route',
                       (K, H, n_heads), dev)
    blocks = backward_blocks(B * N, dev, per_sm=2 if row else 1)
    pg = ParamGrads(blocks, n_et * 21, H, n_heads if pos_mode else H, dev,
                    extra=() if gate is None else ((H,), (1,)))
    # the per-row kernel alone reads the transposed Wo and the scratch
    woT_k = k.wo.t().contiguous() if row else None
    woT_v = v.wo.t().contiguous() if row and not pos_mode else None
    wm, bm = gate or (None, None)
    scratch = (backward_scratch('edge_attention',
                                [K, H, n_heads, int(gate is not None)],
                                blocks, dev) if row else None)
    route = ctypes.c_int(0)               # 1: row buffers in the scratch
    launched_row = ctypes.c_int(0)        # 1: the per-row kernel launched
    fn = _build.load('edge_attention', 'edge_attention_bwd', 40, 10)
    args = ([ptr(x), ptr(x if x_src is None else x_src), ptr(lig),
             ptr(group), ptr(idx), ptr(mask), ptr(e_w), ptr(q), ptr(g)]
            + branch_ptrs(k) + [ptr(woT_k)]
            + branch_ptrs(v) + [ptr(woT_v), ptr(wm), ptr(bm)]
            + [ptr(t) for t in (d_x, d_x if d_xs is None else d_xs, d_ew,
                                d_q, d_trow_k, d_tsrc_k, d_trow_v, d_tsrc_v,
                                pg.slots, pg.out, scratch)]
            + [ctypes.byref(route), ctypes.byref(launched_row), B, N, K, H,
               n_heads, n_et, int(pos_mode), start, n, blocks])
    launch(fn, args, dev, 'edge_attention_backward')
    _count(edge_attention_backward, gate, x_src)
    edge_attention_backward.scratch_launches += route.value
    edge_attention_backward.row_launches += launched_row.value
    grads = (d_x, d_ew, d_q) + pg.branches(d_trow_k, d_tsrc_k, d_trow_v,
                                           d_tsrc_v)
    if gate is not None:
        grads += (tuple(pg.extra()),)
    return grads if x_src is None else grads + (d_xs,)


edge_attention.launches = edge_attention.gated_launches = 0
edge_attention.gather_launches = edge_attention.row_launches = 0
edge_attention.window_launches = 0
edge_attention_backward.launches = edge_attention_backward.gated_launches = 0
edge_attention_backward.gather_launches = 0
edge_attention_backward.scratch_launches = 0
edge_attention_backward.row_launches = 0
