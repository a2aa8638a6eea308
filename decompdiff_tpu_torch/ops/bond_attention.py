"""Dense bond-graph attention: wrapper, plain version and launch count of the
CUDA kernel csrc/bond_attention.cu, which replaces the Pallas kernel
decompdiff_tpu/ops/pallas/bond_kernel.py (_bond_fwd_call / _bond_kernel).

For every ligand atom i (destination) and every ligand atom j (source):

    pre_m = h_bond[i, j] @ We_m + t_row_m[i] + t_src_m[j]            (m = k, v)
    k, v  = relu(LayerNorm(pre_m)) @ Wo_m + bo_m
    alpha = softmax over j under bond_mask[i, j] of the head-grouped q[i] . k
    node mode:  out[i] = sum_j alpha v                             [B, Nl, H]
    pos mode:   out[i] = sum_j mean_h(alpha v) (x_i - x_j)         [B, Nl, 3]

`t_row` is h @ Wi + be and `t_src` is h @ Wj; in pos mode Wo_v is [H, heads].
"""

from __future__ import annotations

from typing import Optional

import torch

from decompdiff_tpu_torch.ops import _build
from decompdiff_tpu_torch.ops.common import (
    Branch, attend, branch_mlp, branch_ptrs, check_heads, check_inputs,
    launch, on_cpu, ptr)


def bond_attention_reference(h_bond, x, mask, q, k: Branch, v: Branch, *,
                             n_heads: int, pos_mode: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the order of the JAX dense
    path (models/uni_transformer_bond.py NodeBondAttention/PosBondAttention)."""
    def branch(p: Branch):
        pre = (h_bond @ p.w_feat + p.t_row[:, :, None, :]
               + p.t_src[:, None, :, :])
        return branch_mlp(pre, p)

    rel = x[:, :, None, :] - x[:, None, :, :] if pos_mode else None
    return attend(q, branch(k), branch(v), mask > 0.5, n_heads, rel)


def bond_attention(h_bond: torch.Tensor, x: Optional[torch.Tensor],
                   mask: torch.Tensor, q: torch.Tensor, k: Branch, v: Branch,
                   *, n_heads: int, pos_mode: bool) -> torch.Tensor:
    """Args (float32): h_bond [B, Nl, Nl, H]; x [B, Nl, 3] ligand coordinates
    (pos mode only, else None); mask [B, Nl, Nl] bond mask; q [B, Nl, H];
    k, v: Branch with t_row / t_src [B, Nl, H], w_feat [H, H],
    wo [H, H] (v in pos mode [H, heads]), bo, ln_scale, ln_bias.
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if on_cpu(q):
        return bond_attention_reference(h_bond, x, mask, q, k, v,
                                        n_heads=n_heads, pos_mode=pos_mode)
    B, Nl, _, H = h_bond.shape
    check_heads(H, n_heads)
    if pos_mode and x is None:
        raise ValueError('pos mode needs the ligand coordinates x')
    f32 = torch.float32
    dv = n_heads if pos_mode else H
    named = [('h_bond', h_bond, (B, Nl, Nl, H), f32),
             ('mask', mask, (B, Nl, Nl), f32), ('q', q, (B, Nl, H), f32)]
    if pos_mode:
        named.append(('x', x, (B, Nl, 3), f32))
    for tag, p, dout in (('k', k, H), ('v', v, dv)):
        named += [(f'{tag}.t_row', p.t_row, (B, Nl, H), f32),
                  (f'{tag}.t_src', p.t_src, (B, Nl, H), f32),
                  (f'{tag}.w_feat', p.w_feat, (H, H), f32),
                  (f'{tag}.wo', p.wo, (H, dout), f32),
                  (f'{tag}.bo', p.bo, (dout,), f32),
                  (f'{tag}.ln_scale', p.ln_scale, (H,), f32),
                  (f'{tag}.ln_bias', p.ln_bias, (H,), f32)]
    check_inputs(q.device, named)
    out = torch.empty((B, Nl, 3 if pos_mode else H), device=q.device,
                      dtype=f32)
    fn = _build.load('bond_attention', 'bond_attention_fwd', 19, 5)
    args = ([ptr(h_bond), ptr(x if pos_mode else None), ptr(mask), ptr(q)]
            + branch_ptrs(k) + branch_ptrs(v) + [ptr(out)]
            + [B, Nl, H, n_heads, int(pos_mode)])
    launch(fn, args, q.device, 'bond_attention')
    bond_attention.launches += 1
    return out


bond_attention.launches = 0
