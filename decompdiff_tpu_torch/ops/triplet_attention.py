"""Bond-triplet angular attention: wrapper, plain version and launch counts
of the CUDA kernels in csrc/triplet_attention.cu, which replace the Pallas
kernels of decompdiff_tpu/ops/pallas/triplet_kernel.py (forward _fwd_call /
_kernel, backward _bwd_call / _bwd_kernel).

For every bond edge (j -> i) and every third ligand atom k:

    ang   = [a, sin(f a), cos(f a)], a = angle[i, j, k], f = 1,2,3,1,1/2,1/3
    pre_m = ang @ Wa_m + t_src_m[j, k] + t_row_m[i, j]              (m = k, v)
    k, v  = relu(LayerNorm(pre_m)) @ Wo_m + bo_m
    alpha = softmax over k under bond[i, j] bond[j, k] (k != i) of the
            head-grouped q[i, j] . k
    out[i, j] = sum_k alpha v                                  [B, Nl, Nl, H]

`t_src` is the factorized (k -> j) term with the angular bias folded in and
`t_row` the (i, j) term; both are computed by the caller.

`bf16=True` is the TPU kernel's `bf16` option (config key `pallas_bf16`):
the two second linears take y and Wo rounded to bf16, with float32
accumulation, in the forward only. The gradient stays the float32 one
(triplet_kernel.py: "the backward kernel is always f32"): its backward
recomputes the forward without the rounding. The launches of the two
forward variants are counted apart (`triplet_attention.launches`,
`triplet_attention.bf16_launches`).

The forward launcher chooses its kernel by width: for H in 32, 64, 128 the
pipelined tensor-core kernel (two warpgroups on wgmma, csrc/wgmma.cuh), for
every other width that check_heads admits the per-row kernel
(csrc/row_attention.cuh), both with the bf16 option. It reports the route it
took: the per-row launches, of either variant, also count in
`triplet_attention.row_launches`, the pipelined ones in
`triplet_attention.pipelined_launches` and, while spans are recorded, in the
counter `ops.triplet_attention.pipelined` (utils/profiling.py).

On CUDA tensors `triplet_attention` is differentiable: its autograd node
saves only the inputs, and `triplet_attention_backward` recomputes the rest
in a backward kernel, which the launcher also chooses by width and reports:
for H in 32, 64, 128 with at most 16 heads and Nl up to 64 (the top of
the ligand ladder) the head-factorized kernel (csrc/head_bwd.cuh: the
cotangents of k and v factorize by head, so no per-triplet [H, H] product
is left; one block per SM; its d t_src sums accumulate in the outputs),
otherwise the per-row kernel (csrc/row_attention_bwd.cuh; two blocks per
SM), whose launches also count in `triplet_attention_backward.row_launches`,
and, with the row buffers in a device-memory scratch (wide H or large Nl),
in `triplet_attention_backward.scratch_launches`. Every backward launch
also counts in `triplet_attention_backward.nl_launches`, a dict by Nl.
`triplet_attention_backward_factored` is the head-factorized algorithm in
plain PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from decompdiff_tpu_torch.models.common import (
    ANGULAR_DIM, ANGULAR_FREQS, angular_encoding, layer_norm)
from decompdiff_tpu_torch.ops import _build
from decompdiff_tpu_torch.ops.common import (
    Branch, ParamGrads, attend, autograd_grads, backward_blocks,
    backward_scratch, branch_checks, branch_mlp, branch_ptrs, check_heads,
    check_inputs, feat_product, kernel_query, launch, on_cpu, ptr)
from decompdiff_tpu_torch.utils.profiling import count, span


def triplet_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, Nl, Nl] bond mask -> [B, i, j, k] triplet mask: bond (j -> i)
    real, bond (k -> j) real and k != i."""
    bm = mask > 0.5
    Nl = bm.shape[-1]
    eye = torch.eye(Nl, dtype=torch.bool, device=bm.device)
    return bm[:, :, :, None] & bm[:, None, :, :] & ~eye[None, :, None, :]


def triplet_attention_reference(angle, mask, q, k: Branch, v: Branch, *,
                                n_heads: int, bf16: bool = False,
                                compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the order of the JAX dense
    path (models/uni_transformer_bond.py BondTripletAttention). bf16: the
    second linears multiply y and Wo rounded to bf16 in float32, where
    bf16 x bf16 products are exact (triplet_kernel.py:121-126).
    compute_dtype: the JAX dense path's rounding of the angular code @ Wa
    under the config key (ops/common.py feat_product); the kernel has
    none."""
    a_feat = angular_encoding(angle)                          # [B,i,j,k,13]

    def branch(p: Branch):
        pre = (feat_product(a_feat, p.w_feat, compute_dtype)
               + p.t_src[:, None, :, :, :] + p.t_row[:, :, :, None, :])
        if not bf16:
            return branch_mlp(pre, p)
        y = torch.relu(layer_norm(pre, p.ln_scale, p.ln_bias))
        return y.bfloat16().float() @ p.wo.bfloat16().float() + p.bo

    return attend(q, branch(k), branch(v), triplet_mask(mask), n_heads)


def triplet_attention_backward_reference(g, angle, mask, q, k: Branch,
                                         v: Branch, *, n_heads: int):
    """Plain version of the backward: autograd through the plain forward.
    Returns (d_angle, d_q, d_k, d_v), d_k and d_v as Branch."""
    def fn(angle, q, *kv):
        return triplet_attention_reference(
            angle, mask, q, Branch(*kv[:7]), Branch(*kv[7:]), n_heads=n_heads)
    d = autograd_grads(fn, g, [angle, q, *k, *v])
    return d[0], d[1], Branch(*d[2:9]), Branch(*d[9:])


def triplet_attention_backward_factored(g, angle, mask, q, k: Branch,
                                        v: Branch, *, n_heads: int):
    """The head-factorized backward that the backward kernel computes at H
    in 32, 64, 128, in plain PyTorch (for tests; no path calls it). Returns
    what triplet_attention_backward_reference returns.

    q[i, j] and g[i, j] belong to the row, so the cotangents of k and v
    factorize by head: d k[k, c] = scale dh[k, h(c)] q[c] and
    d v[k, c] = alpha[k, h(c)] g[c]. With Qk[h] = Wo_k[:, h] q[h] and
    Gv[h] = Wo_v[:, h] g[h] ([heads, H] per row) no per-triplet [H, H]
    product is left: the logits are scale (y_k . Qk[h] + q_h . bo_k,h), d
    alpha is y_v . Gv[h] + g_h . bo_v,h, d y_k = scale sum_h dh Qk[h],
    d y_v = sum_h alpha Gv[h], and d q and d Wo come from the per-row sums
    Yd[h] = sum_k dh[k, h] y_k[k] and Ya[h] = sum_k alpha[k, h] y_v[k]."""
    B, Nl = angle.shape[:2]
    H = q.shape[-1]
    hd = H // n_heads
    scale = 1.0 / math.sqrt(hd)
    a_feat = angular_encoding(angle)                          # [B,i,j,k,13]
    freqs = torch.as_tensor(ANGULAR_FREQS, dtype=angle.dtype,
                            device=angle.device)
    af = angle[..., None] * freqs
    d_code = torch.cat([torch.ones_like(angle[..., None]),
                        freqs * torch.cos(af), -freqs * torch.sin(af)], -1)

    def recompute(p: Branch):
        pre = (a_feat @ p.w_feat + p.t_src[:, None, :, :, :]
               + p.t_row[:, :, :, None, :])
        mu = pre.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((pre - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
        xhat = (pre - mu) * rstd
        return xhat, rstd, torch.relu(xhat * p.ln_scale + p.ln_bias)

    def heads(t):                                   # [..., H] -> [..., NH, hd]
        return t.reshape(t.shape[:-1] + (n_heads, hd))

    xk, rk, yk = recompute(k)
    xv, rv, yv = recompute(v)
    wok, wov = heads(k.wo), heads(v.wo)             # [H(in), NH, hd]
    Qk = torch.einsum('xhd,bijhd->bijhx', wok, heads(q))
    Gv = torch.einsum('xhd,bijhd->bijhx', wov, heads(g))
    logit = scale * (torch.einsum('bijkx,bijhx->bijkh', yk, Qk)
                     + heads(q * k.bo).sum(-1)[..., None, :])
    d_alpha = (torch.einsum('bijkx,bijhx->bijkh', yv, Gv)
               + heads(g * v.bo).sum(-1)[..., None, :])
    valid = triplet_mask(mask)[..., None]
    m = torch.where(valid, logit, -1e30).amax(3, keepdim=True).clamp_min(
        -1e29)
    e = torch.where(valid, torch.exp(logit - m), 0.0)
    alpha = e / e.sum(3, keepdim=True).clamp_min(1e-16)
    dh = alpha * (d_alpha - (alpha * d_alpha).sum(3, keepdim=True))

    def branch_bwd(dy, xhat, rstd, y, p: Branch):
        du = torch.where(y > 0, dy, 0.0)
        dx = du * p.ln_scale
        d_pre = rstd * (dx - dx.mean(-1, keepdim=True)
                        - xhat * (dx * xhat).mean(-1, keepdim=True))
        return d_pre, (du * xhat).sum((0, 1, 2, 3)), du.sum((0, 1, 2, 3))

    dpk, dlns_k, dlnb_k = branch_bwd(
        scale * torch.einsum('bijkh,bijhx->bijkx', dh, Qk), xk, rk, yk, k)
    dpv, dlns_v, dlnb_v = branch_bwd(
        torch.einsum('bijkh,bijhx->bijkx', alpha, Gv), xv, rv, yv, v)
    d_angle = ((dpk @ k.w_feat.t() + dpv @ v.w_feat.t()) * d_code).sum(-1)
    Yd = torch.einsum('bijkh,bijkx->bijhx', dh, yk)
    Ya = torch.einsum('bijkh,bijkx->bijhx', alpha, yv)
    sdh, sal = dh.sum(3), alpha.sum(3)               # [B, i, j, NH]
    d_q = scale * (torch.einsum('bijhx,xhd->bijhd', Yd, wok)
                   + heads(k.bo) * sdh[..., None]).reshape(q.shape)
    dwo_k = scale * torch.einsum('bijhx,bijhd->xhd', Yd, heads(q))
    dwo_v = torch.einsum('bijhx,bijhd->xhd', Ya, heads(g))
    dbo_k = scale * (heads(q) * sdh[..., None]).sum((0, 1, 2))
    dbo_v = (heads(g) * sal[..., None]).sum((0, 1, 2))

    def grads(d_pre, dwo, dbo, dlns, dlnb):
        return Branch(d_pre.sum(3), d_pre.sum(1),
                      torch.einsum('bijkt,bijkc->tc', a_feat, d_pre),
                      dwo.reshape(H, H), dbo.reshape(H), dlns, dlnb)

    return (d_angle, d_q, grads(dpk, dwo_k, dbo_k, dlns_k, dlnb_k),
            grads(dpv, dwo_v, dbo_v, dlns_v, dlnb_v))


def _checks(angle, mask, q, k, v, n_heads):
    """check_inputs entries of the kernel's inputs."""
    B, Nl = angle.shape[:2]
    H = q.shape[-1]
    check_heads(H, n_heads)
    f32 = torch.float32
    named = [('angle', angle, (B, Nl, Nl, Nl), f32),
             ('mask', mask, (B, Nl, Nl), f32), ('q', q, (B, Nl, Nl, H), f32)]
    for tag, p in (('k', k), ('v', v)):
        named += branch_checks(tag, p, (B, Nl, Nl, H), (B, Nl, Nl, H),
                               ANGULAR_DIM, H, H)
    return named


def _forward(angle, mask, q, k, v, n_heads, bf16):
    B, Nl = angle.shape[:2]
    H = q.shape[-1]
    check_inputs(q.device, _checks(angle, mask, q, k, v, n_heads))
    out = torch.empty((B, Nl, Nl, H), device=q.device, dtype=torch.float32)
    row = ctypes.c_int(0)                 # 1: the per-row kernel launched
    fn = _build.load('triplet_attention', 'triplet_attention_fwd', 19, 5)
    args = ([ptr(angle), ptr(mask), ptr(q)] + branch_ptrs(k) + branch_ptrs(v)
            + [ptr(out), ctypes.byref(row)] + [B, Nl, H, n_heads, int(bf16)])
    launch(fn, args, q.device, 'triplet_attention')
    if bf16:
        triplet_attention.bf16_launches += 1
    else:
        triplet_attention.launches += 1
    triplet_attention.row_launches += row.value
    if not row.value:
        triplet_attention.pipelined_launches += 1
        count('ops.triplet_attention.pipelined')
    return out


class _TripletAttention(torch.autograd.Function):
    """Forward, saving only the inputs: the kernel on CUDA tensors, the
    plain bf16 version on CPU tensors. Backward: triplet_attention_backward
    (the float32 backward kernel, or its plain version on the CPU), so a
    bf16 forward has the float32 gradient, as the TPU kernel's custom VJP
    gives it."""

    @staticmethod
    def forward(ctx, n_heads, bf16, angle, mask, q, *kv):
        ctx.n_heads = n_heads
        ctx.save_for_backward(angle, mask, q, *kv)
        k, v = Branch(*kv[:7]), Branch(*kv[7:])
        if on_cpu(q):
            return triplet_attention_reference(angle, mask, q, k, v,
                                               n_heads=n_heads, bf16=bf16)
        return _forward(angle, mask, q, k, v, n_heads, bf16)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        angle, mask, q, *kv = ctx.saved_tensors
        with span('ops.triplet_attention.backward'):
            d_angle, d_q, dk, dv = triplet_attention_backward(
                g.contiguous(), angle, mask, q, Branch(*kv[:7]),
                Branch(*kv[7:]), n_heads=ctx.n_heads)
        return (None, None, d_angle, None, d_q, *dk, *dv)


def triplet_attention(angle: torch.Tensor, mask: torch.Tensor,
                      q: torch.Tensor, k: Branch, v: Branch, *,
                      n_heads: int, bf16: bool = False) -> torch.Tensor:
    """Args (float32): angle [B, Nl(i), Nl(j), Nl(k)] angles at vertex i;
    mask [B, Nl, Nl] bond mask; q [B, Nl, Nl, H]; k, v: Branch with
    t_row [B, Nl(i), Nl(j), H], t_src [B, Nl(j), Nl(k), H], w_feat [13, H],
    wo [H, H], bo, ln_scale, ln_bias; bf16: one bf16 pass of the second
    linears in the forward (the gradient stays float32).
    CPU tensors run the plain version (with bf16, under an autograd node
    whose backward is the float32 plain backward); CUDA tensors launch the
    kernel, and its gradient launches the backward kernel.
    """
    with span('ops.triplet_attention'):
        if on_cpu(q) and not bf16:
            return triplet_attention_reference(angle, mask, q, k, v,
                                               n_heads=n_heads)
        return _TripletAttention.apply(n_heads, bf16, angle, mask, q, *k,
                                       *v)


def triplet_attention_backward(g: torch.Tensor, angle, mask, q, k: Branch,
                               v: Branch, *, n_heads: int):
    """Gradients of triplet_attention for the output cotangent g
    [B, Nl, Nl, H]: (d_angle, d_q, d_k, d_v), d_k and d_v as Branch. CPU
    tensors run the plain version; CUDA tensors launch the backward
    kernel."""
    if on_cpu(q):
        return triplet_attention_backward_reference(
            g, angle, mask, q, k, v, n_heads=n_heads)
    B, Nl = angle.shape[:2]
    H = q.shape[-1]
    named = _checks(angle, mask, q, k, v, n_heads)
    named.append(('g', g, (B, Nl, Nl, H), torch.float32))
    check_inputs(q.device, named)
    dev = q.device
    d_angle = torch.zeros((B, Nl, Nl, Nl), device=dev)
    d_q, d_trow_k, d_tsrc_k, d_trow_v, d_tsrc_v = (
        torch.empty((B, Nl, Nl, H), device=dev) for _ in range(5))
    row = kernel_query('triplet_attention', 'triplet_attention_bwd_route',
                       (Nl, H, n_heads), dev)
    blocks = backward_blocks(B * Nl, dev, per_sm=2 if row else 1)
    pg = ParamGrads(blocks, ANGULAR_DIM, H, H, dev)
    # the per-row kernel alone reads the transposed Wo and the scratch
    woT_k, woT_v = ((k.wo.t().contiguous(), v.wo.t().contiguous()) if row
                    else (None, None))
    scratch = (backward_scratch('triplet_attention', [Nl, H, n_heads],
                                blocks, dev) if row else None)
    route = ctypes.c_int(0)               # 1: row buffers in the scratch
    launched_row = ctypes.c_int(0)        # 1: the per-row kernel launched
    fn = _build.load('triplet_attention', 'triplet_attention_bwd', 31, 5)
    args = ([ptr(angle), ptr(mask), ptr(q), ptr(g)] + branch_ptrs(k)
            + [ptr(woT_k)] + branch_ptrs(v) + [ptr(woT_v)]
            + [ptr(t) for t in (d_angle, d_q, d_trow_k, d_tsrc_k, d_trow_v,
                                d_tsrc_v, pg.slots, pg.out, scratch)]
            + [ctypes.byref(route), ctypes.byref(launched_row), B, Nl, H,
               n_heads, blocks])
    launch(fn, args, dev, 'triplet_attention_backward')
    triplet_attention_backward.launches += 1
    by_nl = triplet_attention_backward.nl_launches
    by_nl[Nl] = by_nl.get(Nl, 0) + 1
    triplet_attention_backward.scratch_launches += route.value
    triplet_attention_backward.row_launches += launched_row.value
    dk, dv = pg.branches(d_trow_k, d_tsrc_k, d_trow_v, d_tsrc_v)
    return d_angle, d_q, dk, dv


triplet_attention.launches = triplet_attention.bf16_launches = 0
triplet_attention.row_launches = triplet_attention.pipelined_launches = 0
triplet_attention_backward.launches = 0
triplet_attention_backward.scratch_launches = 0
triplet_attention_backward.row_launches = 0
triplet_attention_backward.nl_launches = {}
