"""kNN edge attention: wrapper, plain version and launch counts of the CUDA
kernels in csrc/edge_attention.cu, which replace the Pallas kernels of
decompdiff_tpu/ops/pallas/edge_kernel.py (forward _edge_fwd_call /
_edge_kernel, backward _edge_bwd_call / _edge_bwd_kernel).

For every destination node i and each of its K kNN sources s = idx[i, k]:

    edge_type = 4-way one-hot of (src is ligand, dst is ligand)
                [+ 2-way one-hot of same decomposition group]
    edge_feat = [outer(edge_type, RBF20(|x_i - x_s|)), edge_type]   (F*21)
    pre_m     = edge_feat @ We_m + t_row_m[i] + t_src_m[s]          (m = k, v)
    k, v      = relu(LayerNorm(pre_m)) @ Wo_m + bo_m ;  v *= e_w
    alpha     = masked softmax over K of the head-grouped q[i] . k / sqrt(hd)
    node mode:  out[i] = sum_k alpha v                              [B, N, H]
    pos mode:   out[i] = sum_k mean_h(alpha v) (x_i - x_s)          [B, N, 3]

`t_row` is h @ Wi + be and `t_src` is h @ Wj (per-node products, computed
by the caller with torch.matmul); in pos mode Wo_v is [H, heads].

On CUDA tensors `edge_attention` is differentiable: its autograd node saves
only the inputs, and `edge_attention_backward` recomputes the rest in the
backward kernel and returns the gradients of x, e_w, q and both branches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from decompdiff_tpu_torch.models.common import (
    fixed_rbf, outer_product, safe_norm)
from decompdiff_tpu_torch.ops import _build
from decompdiff_tpu_torch.ops.common import (
    Branch, ParamGrads, attend, autograd_grads, backward_blocks,
    branch_checks, branch_mlp, branch_ptrs, check_heads, check_inputs,
    launch, on_cpu, ptr)


def gather_nodes(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """h [B, N, F], idx [B, N, K] -> [B, N, K, F]."""
    B, N, K = idx.shape
    flat = idx.reshape(B, N * K, 1).long().expand(-1, -1, h.shape[-1])
    return torch.gather(h, 1, flat).reshape(B, N, K, h.shape[-1])


def edge_attention_reference(x, lig, group, idx, mask, e_w, q,
                             k: Branch, v: Branch, *, n_heads: int,
                             pos_mode: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the order of the JAX dense
    path (models/uni_transformer_bond.py NodeEdgeAttention/PosEdgeAttention)."""
    rel = x[:, :, None, :] - gather_nodes(x, idx)            # x_dst - x_src
    dist = safe_norm(rel, dim=-1)
    lig_src = gather_nodes(lig[..., None], idx)[..., 0] > 0.5
    lig_dst = (lig > 0.5)[:, :, None]
    type_id = torch.where(lig_src & lig_dst, 0,
                          torch.where(lig_src & ~lig_dst, 1,
                                      torch.where(~lig_src & lig_dst, 2, 3)))
    edge_type = F.one_hot(type_id, 4).to(x.dtype)
    if group is not None:
        same = gather_nodes(group[..., None], idx)[..., 0] == group[:, :, None]
        edge_type = torch.cat(
            [edge_type, F.one_hot(same.long(), 2).to(x.dtype)], dim=-1)
    edge_feat = torch.cat([outer_product(edge_type, fixed_rbf(dist)),
                           edge_type], dim=-1)

    def branch(p: Branch):
        pre = (edge_feat @ p.w_feat + p.t_row[:, :, None, :]
               + gather_nodes(p.t_src, idx))
        return branch_mlp(pre, p)

    kk = branch(k)
    vv = branch(v) * e_w[..., None]
    return attend(q, kk, vv, mask > 0.5, n_heads, rel if pos_mode else None)


def edge_attention_backward_reference(g, x, lig, group, idx, mask, e_w, q,
                                      k: Branch, v: Branch, *, n_heads: int,
                                      pos_mode: bool):
    """Plain version of the backward: autograd through the plain forward.
    Returns (d_x, d_e_w, d_q, d_k, d_v), d_k and d_v as Branch."""
    def fn(x, e_w, q, *kv):
        return edge_attention_reference(
            x, lig, group, idx, mask, e_w, q, Branch(*kv[:7]),
            Branch(*kv[7:]), n_heads=n_heads, pos_mode=pos_mode)
    d = autograd_grads(fn, g, [x, e_w, q, *k, *v])
    return d[0], d[1], d[2], Branch(*d[3:10]), Branch(*d[10:])


def _checks(x, lig, group, idx, mask, e_w, q, k, v, n_heads, pos_mode):
    """check_inputs entries of the kernel's inputs, and the edge-type count."""
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
    for tag, p, dout in (('k', k, H), ('v', v, n_heads if pos_mode else H)):
        named += branch_checks(tag, p, (B, N, H), (B, N, H), n_et * 21, H,
                               dout)
    return named, n_et


def _forward(x, lig, group, idx, mask, e_w, q, k, v, n_heads, pos_mode):
    B, N, K = idx.shape
    H = q.shape[-1]
    named, n_et = _checks(x, lig, group, idx, mask, e_w, q, k, v, n_heads,
                          pos_mode)
    check_inputs(q.device, named)
    out = torch.empty((B, N, 3 if pos_mode else H), device=q.device,
                      dtype=torch.float32)
    fn = _build.load('edge_attention', 'edge_attention_fwd', 22, 7)
    args = ([ptr(x), ptr(lig), ptr(group), ptr(idx), ptr(mask), ptr(e_w),
             ptr(q)] + branch_ptrs(k) + branch_ptrs(v) + [ptr(out)]
            + [B, N, K, H, n_heads, n_et, int(pos_mode)])
    launch(fn, args, q.device, 'edge_attention')
    edge_attention.launches += 1
    return out


class _EdgeAttention(torch.autograd.Function):
    """Forward kernel, saving only the inputs; backward kernel."""

    @staticmethod
    def forward(ctx, n_heads, pos_mode, x, lig, group, idx, mask, e_w, q,
                *kv):
        ctx.opts = dict(n_heads=n_heads, pos_mode=pos_mode)
        ctx.save_for_backward(x, lig, group, idx, mask, e_w, q, *kv)
        return _forward(x, lig, group, idx, mask, e_w, q, Branch(*kv[:7]),
                        Branch(*kv[7:]), n_heads, pos_mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, lig, group, idx, mask, e_w, q, *kv = ctx.saved_tensors
        d_x, d_ew, d_q, dk, dv = edge_attention_backward(
            g.contiguous(), x, lig, group, idx, mask, e_w, q,
            Branch(*kv[:7]), Branch(*kv[7:]), **ctx.opts)
        return (None, None, d_x, None, None, None, None, d_ew, d_q, *dk, *dv)


def edge_attention(x: torch.Tensor, lig: torch.Tensor,
                   group: Optional[torch.Tensor], idx: torch.Tensor,
                   mask: torch.Tensor, e_w: torch.Tensor, q: torch.Tensor,
                   k: Branch, v: Branch, *, n_heads: int,
                   pos_mode: bool) -> torch.Tensor:
    """Args (float32 unless noted):
        x [B, N, 3] coordinates; lig [B, N] 1.0 on ligand(+prior) nodes;
        group [B, N] decomposition group ids, or None for 4 edge types;
        idx [B, N, K] int32 sources; mask / e_w [B, N, K]; q [B, N, H];
        k, v: Branch with t_row / t_src [B, N, H], w_feat [F*21, H],
        wo [H, H] (v in pos mode [H, heads]), bo, ln_scale, ln_bias.
    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    its gradient launches the backward kernel.
    """
    if on_cpu(q):
        return edge_attention_reference(x, lig, group, idx, mask, e_w, q, k,
                                        v, n_heads=n_heads, pos_mode=pos_mode)
    return _EdgeAttention.apply(n_heads, pos_mode, x, lig, group, idx, mask,
                                e_w, q, *k, *v)


def edge_attention_backward(g: torch.Tensor, x, lig, group, idx, mask, e_w,
                            q, k: Branch, v: Branch, *, n_heads: int,
                            pos_mode: bool):
    """Gradients of edge_attention for the output cotangent g ([B, N, H],
    pos mode [B, N, 3]): (d_x, d_e_w, d_q, d_k, d_v), d_k and d_v as Branch
    (d t_row, d t_src and the five parameter gradients). CPU tensors run the
    plain version; CUDA tensors launch the backward kernel."""
    if on_cpu(q):
        return edge_attention_backward_reference(
            g, x, lig, group, idx, mask, e_w, q, k, v, n_heads=n_heads,
            pos_mode=pos_mode)
    B, N, K = idx.shape
    H = q.shape[-1]
    named, n_et = _checks(x, lig, group, idx, mask, e_w, q, k, v, n_heads,
                          pos_mode)
    named.append(('g', g, (B, N, 3 if pos_mode else H), torch.float32))
    check_inputs(q.device, named)
    dev = q.device
    d_x = torch.zeros((B, N, 3), device=dev)
    d_ew = torch.empty((B, N, K), device=dev)
    d_q, d_trow_k, d_trow_v = (torch.empty((B, N, H), device=dev)
                               for _ in range(3))
    d_tsrc_k, d_tsrc_v = (torch.zeros((B, N, H), device=dev)
                          for _ in range(2))
    blocks = backward_blocks(B * N, dev)
    pg = ParamGrads(blocks, n_et * 21, H, n_heads if pos_mode else H, dev)
    woT_k = k.wo.t().contiguous()
    woT_v = None if pos_mode else v.wo.t().contiguous()
    fn = _build.load('edge_attention', 'edge_attention_bwd', 33, 8)
    args = ([ptr(x), ptr(lig), ptr(group), ptr(idx), ptr(mask), ptr(e_w),
             ptr(q), ptr(g)] + branch_ptrs(k) + [ptr(woT_k)]
            + branch_ptrs(v) + [ptr(woT_v)]
            + [ptr(t) for t in (d_x, d_ew, d_q, d_trow_k, d_tsrc_k, d_trow_v,
                                d_tsrc_v, pg.slots, pg.out)]
            + [B, N, K, H, n_heads, n_et, int(pos_mode), blocks])
    launch(fn, args, dev, 'edge_attention_backward')
    edge_attention_backward.launches += 1
    dk, dv = pg.branches(d_trow_k, d_tsrc_k, d_trow_v, d_tsrc_v)
    return d_x, d_ew, d_q, dk, dv


edge_attention.launches = 0
edge_attention_backward.launches = 0
