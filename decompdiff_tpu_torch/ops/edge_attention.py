"""kNN edge attention: wrapper, plain version and launch count of the CUDA
kernel csrc/edge_attention.cu, which replaces the Pallas kernel
decompdiff_tpu/ops/pallas/edge_kernel.py (_edge_fwd_call / _edge_kernel).

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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from decompdiff_tpu_torch.models.common import (
    fixed_rbf, outer_product, safe_norm)
from decompdiff_tpu_torch.ops import _build
from decompdiff_tpu_torch.ops.common import (
    Branch, attend, branch_mlp, branch_ptrs, check_heads, check_inputs,
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
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if on_cpu(q):
        return edge_attention_reference(x, lig, group, idx, mask, e_w, q, k,
                                        v, n_heads=n_heads, pos_mode=pos_mode)
    B, N, K = idx.shape
    H = q.shape[-1]
    check_heads(H, n_heads)
    n_et = 4 if group is None else 6
    f32 = torch.float32
    dv = n_heads if pos_mode else H
    named = [('x', x, (B, N, 3), f32), ('lig', lig, (B, N), f32),
             ('idx', idx, (B, N, K), torch.int32),
             ('mask', mask, (B, N, K), f32), ('e_w', e_w, (B, N, K), f32),
             ('q', q, (B, N, H), f32)]
    if group is not None:
        named.append(('group', group, (B, N), f32))
    for tag, p, dout in (('k', k, H), ('v', v, dv)):
        named += [(f'{tag}.t_row', p.t_row, (B, N, H), f32),
                  (f'{tag}.t_src', p.t_src, (B, N, H), f32),
                  (f'{tag}.w_feat', p.w_feat, (n_et * 21, H), f32),
                  (f'{tag}.wo', p.wo, (H, dout), f32),
                  (f'{tag}.bo', p.bo, (dout,), f32),
                  (f'{tag}.ln_scale', p.ln_scale, (H,), f32),
                  (f'{tag}.ln_bias', p.ln_bias, (H,), f32)]
    check_inputs(q.device, named)
    out = torch.empty((B, N, 3 if pos_mode else H), device=q.device,
                      dtype=f32)
    fn = _build.load('edge_attention', 'edge_attention_fwd', 22, 7)
    args = ([ptr(x), ptr(lig), ptr(group), ptr(idx), ptr(mask), ptr(e_w),
             ptr(q)] + branch_ptrs(k) + branch_ptrs(v) + [ptr(out)]
            + [B, N, K, H, n_heads, n_et, int(pos_mode)])
    launch(fn, args, q.device, 'edge_attention')
    edge_attention.launches += 1
    return out


edge_attention.launches = 0
