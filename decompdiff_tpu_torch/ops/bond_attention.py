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
only the inputs, and `bond_attention_backward` recomputes the rest in the
backward kernel. Its launches with the row buffers in a device-memory
scratch (wide H; the launcher decides and reports it) also count in
`bond_attention_backward.scratch_launches`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from decompdiff_tpu_torch.ops import _build
from decompdiff_tpu_torch.ops.common import (
    Branch, ParamGrads, attend, autograd_grads, backward_blocks,
    backward_scratch, branch_checks, branch_mlp, branch_ptrs, check_heads,
    check_inputs, launch, on_cpu, ptr)


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
    d_hb = torch.zeros((B, Nl, Nl, H), device=dev)
    d_x = torch.zeros((B, Nl, 3), device=dev) if pos_mode else None
    d_q, d_trow_k, d_trow_v = (torch.empty((B, Nl, H), device=dev)
                               for _ in range(3))
    d_tsrc_k, d_tsrc_v = (torch.zeros((B, Nl, H), device=dev)
                          for _ in range(2))
    blocks = backward_blocks(B * Nl, dev)
    pg = ParamGrads(blocks, H, H, n_heads if pos_mode else H, dev)
    woT_k, weT_k, weT_v = (w.t().contiguous()
                           for w in (k.wo, k.w_feat, v.w_feat))
    woT_v = None if pos_mode else v.wo.t().contiguous()
    scratch = backward_scratch('bond_attention', [Nl, H, n_heads], blocks,
                               dev)
    route = ctypes.c_int(0)               # 1: row buffers in the scratch
    fn = _build.load('bond_attention', 'bond_attention_bwd', 34, 6)
    args = ([ptr(h_bond), ptr(x if pos_mode else None), ptr(mask), ptr(q),
             ptr(g)] + branch_ptrs(k) + [ptr(woT_k), ptr(weT_k)]
            + branch_ptrs(v) + [ptr(woT_v), ptr(weT_v)]
            + [ptr(t) for t in (d_hb, d_x, d_q, d_trow_k, d_tsrc_k, d_trow_v,
                                d_tsrc_v, pg.slots, pg.out, scratch)]
            + [ctypes.byref(route), B, Nl, H, n_heads, int(pos_mode),
               blocks])
    launch(fn, args, dev, 'bond_attention_backward')
    bond_attention_backward.launches += 1
    bond_attention_backward.scratch_launches += route.value
    dk, dv = pg.branches(d_trow_k, d_tsrc_k, d_trow_v, d_tsrc_v)
    return d_hb, d_x, d_q, dk, dv


bond_attention.launches = bond_attention.row_launches = 0
bond_attention_backward.launches = 0
bond_attention_backward.scratch_launches = 0
