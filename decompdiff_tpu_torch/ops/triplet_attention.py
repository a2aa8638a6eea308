"""Bond-triplet angular attention: wrapper, plain version and launch count
of the CUDA kernel csrc/triplet_attention.cu, which replaces the Pallas
kernel decompdiff_tpu/ops/pallas/triplet_kernel.py (_fwd_call / _kernel).

For every bond edge (j -> i) and every third ligand atom k:

    ang   = [a, sin(f a), cos(f a)], a = angle[i, j, k], f = 1,2,3,1,1/2,1/3
    pre_m = ang @ Wa_m + t_src_m[j, k] + t_row_m[i, j]              (m = k, v)
    k, v  = relu(LayerNorm(pre_m)) @ Wo_m + bo_m
    alpha = softmax over k under bond[i, j] bond[j, k] (k != i) of the
            head-grouped q[i, j] . k
    out[i, j] = sum_k alpha v                                  [B, Nl, Nl, H]

`t_src` is the factorized (k -> j) term with the angular bias folded in and
`t_row` the (i, j) term; both are computed by the caller.
"""

from __future__ import annotations

import torch

from decompdiff_tpu_torch.models.common import ANGULAR_DIM, angular_encoding
from decompdiff_tpu_torch.ops import _build
from decompdiff_tpu_torch.ops.common import (
    Branch, attend, branch_mlp, branch_ptrs, check_heads, check_inputs,
    launch, on_cpu, ptr)


def triplet_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, Nl, Nl] bond mask -> [B, i, j, k] triplet mask: bond (j -> i)
    real, bond (k -> j) real and k != i."""
    bm = mask > 0.5
    Nl = bm.shape[-1]
    eye = torch.eye(Nl, dtype=torch.bool, device=bm.device)
    return bm[:, :, :, None] & bm[:, None, :, :] & ~eye[None, :, None, :]


def triplet_attention_reference(angle, mask, q, k: Branch, v: Branch, *,
                                n_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the order of the JAX dense
    path (models/uni_transformer_bond.py BondTripletAttention)."""
    a_feat = angular_encoding(angle)                          # [B,i,j,k,13]

    def branch(p: Branch):
        pre = (a_feat @ p.w_feat + p.t_src[:, None, :, :, :]
               + p.t_row[:, :, :, None, :])
        return branch_mlp(pre, p)

    return attend(q, branch(k), branch(v), triplet_mask(mask), n_heads)


def triplet_attention(angle: torch.Tensor, mask: torch.Tensor,
                      q: torch.Tensor, k: Branch, v: Branch, *,
                      n_heads: int) -> torch.Tensor:
    """Args (float32): angle [B, Nl(i), Nl(j), Nl(k)] angles at vertex i;
    mask [B, Nl, Nl] bond mask; q [B, Nl, Nl, H]; k, v: Branch with
    t_row [B, Nl(i), Nl(j), H], t_src [B, Nl(j), Nl(k), H], w_feat [13, H],
    wo [H, H], bo, ln_scale, ln_bias.
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if on_cpu(q):
        return triplet_attention_reference(angle, mask, q, k, v,
                                           n_heads=n_heads)
    B, Nl = angle.shape[:2]
    H = q.shape[-1]
    check_heads(H, n_heads)
    f32 = torch.float32
    named = [('angle', angle, (B, Nl, Nl, Nl), f32),
             ('mask', mask, (B, Nl, Nl), f32), ('q', q, (B, Nl, Nl, H), f32)]
    for tag, p in (('k', k), ('v', v)):
        named += [(f'{tag}.t_row', p.t_row, (B, Nl, Nl, H), f32),
                  (f'{tag}.t_src', p.t_src, (B, Nl, Nl, H), f32),
                  (f'{tag}.w_feat', p.w_feat, (ANGULAR_DIM, H), f32),
                  (f'{tag}.wo', p.wo, (H, H), f32),
                  (f'{tag}.bo', p.bo, (H,), f32),
                  (f'{tag}.ln_scale', p.ln_scale, (H,), f32),
                  (f'{tag}.ln_bias', p.ln_bias, (H,), f32)]
    check_inputs(q.device, named)
    out = torch.empty((B, Nl, Nl, H), device=q.device, dtype=f32)
    fn = _build.load('triplet_attention', 'triplet_attention_fwd', 18, 4)
    args = ([ptr(angle), ptr(mask), ptr(q)] + branch_ptrs(k) + branch_ptrs(v)
            + [ptr(out)] + [B, Nl, H, n_heads])
    launch(fn, args, q.device, 'triplet_attention')
    triplet_attention.launches += 1
    return out


triplet_attention.launches = 0
