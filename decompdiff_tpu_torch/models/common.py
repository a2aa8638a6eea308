"""Shared feature blocks (port of decompdiff_tpu/models/common.py).

Parity targets (ref models/common.py): GaussianSmearing (:11-31),
AngularEncoding (:34-54), ShiftedSoftplus (:66-72), MLP (:85-105),
outer_product edge features (:116-123).

`Dense` and `LayerNorm` keep the flax parameter names and layouts
(`kernel` is [in, out]) so a state_dict key is the flax path joined with '.'.
Their `dtype` is flax's compute dtype (config key `compute_dtype`): the
parameters stay float32 and are cast where flax casts them
(flax/linen/linear.py Dense, linen/normalization.py _normalize,
linen/dtypes.py promote_dtype). Without one, an input and the parameters
are promoted to a common dtype, as flax promotes them: a bf16 input with
float32 parameters computes in float32 (torch.matmul does not promote, so
the cast is explicit).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The custom RBF offsets used whenever fix_offset=True (ref models/common.py:18).
FIXED_RBF_OFFSETS = np.array(
    [0, 1, 1.25, 1.5, 1.75, 2, 2.25, 2.5, 2.75, 3, 3.5, 4, 4.5, 5, 5.5, 6, 7, 8, 9, 10],
    dtype=np.float32)
FIXED_RBF_COEFF = -0.5

ANGULAR_FREQS = np.array([1.0, 2.0, 3.0, 1.0, 1.0 / 2, 1.0 / 3], np.float32)
ANGULAR_DIM = 1 + 2 * len(ANGULAR_FREQS)  # 13


def gaussian_smearing(dist: torch.Tensor, offsets: torch.Tensor,
                      coeff: float) -> torch.Tensor:
    """dist [...] -> [..., num_gaussians] (ref models/common.py:29-31)."""
    d = dist[..., None] - offsets
    return torch.exp(coeff * d * d)


def fixed_rbf(dist: torch.Tensor) -> torch.Tensor:
    """The fix_offset=True expansion used on every hot path."""
    offsets = torch.as_tensor(FIXED_RBF_OFFSETS, device=dist.device)
    return gaussian_smearing(dist, offsets, FIXED_RBF_COEFF)


def linspace_rbf(dist: torch.Tensor, start: float, stop: float,
                 num_gaussians: int) -> torch.Tensor:
    """fix_offset=False variant (ref models/common.py:20-23)."""
    offsets = torch.linspace(start, stop, num_gaussians, device=dist.device)
    coeff = -0.5 / float((stop - start) / (num_gaussians - 1)) ** 2
    return gaussian_smearing(dist, offsets, coeff)


def angular_encoding(x: torch.Tensor) -> torch.Tensor:
    """x [...] -> [..., 13] = [x, sin(f x), cos(f x)], f = 1,2,3,1,1/2,1/3
    (ref models/common.py:34-54)."""
    xf = x[..., None] * torch.as_tensor(ANGULAR_FREQS, device=x.device)
    return torch.cat([x[..., None], torch.sin(xf), torch.cos(xf)], dim=-1)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid. Below float32 it is computed as JAX lowers
    lax.logistic, 1 / (1 + exp(-x)) with every step rounded to x's dtype
    (each torch op on a bf16 tensor rounds its result); torch.sigmoid
    rounds once, which moves a third of bf16 results by one unit."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - float(np.log(2.0))


def outer_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., A], [..., B] -> [..., A*B], a-index major:
    out[..., i*B + j] = a[..., i] * b[..., j]."""
    out = a[..., :, None] * b[..., None, :]
    return out.reshape(out.shape[:-2] + (a.shape[-1] * b.shape[-1],))


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """Numerically-safe masked softmax; fully-masked rows return all zeros."""
    logits = logits.float()
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(mask, logits, neg)
    m = masked.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(mask, torch.exp(masked - m), 0.0)
    denom = e.sum(dim=dim, keepdim=True)
    return e / torch.clamp(denom, min=1e-16)


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """Gradient-safe L2 norm (grad at 0 is 0, not NaN)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps))


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with eps 1e-5."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps=1e-5)


class Dense(nn.Module):
    """flax.linen.Dense: y = x @ kernel + bias, kernel [in, out]. With a
    `dtype`, x, kernel and bias are cast to it, and the product and the
    bias sum are each rounded to it (two roundings, as flax's dot_general
    then `y += bias`)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_dim))
        else:
            self.register_parameter('bias', None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm(epsilon=1e-5): params `scale` and `bias`. The
    statistics and the affine map run in float32 whatever the input's
    dtype; the result is cast once, to `dtype` or else to the input's
    dtype promoted with the parameters'."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.scale.dtype)
        return layer_norm(x.float(), self.scale, self.bias).to(dt)


class MLP(nn.Module):
    """Linear -> LayerNorm -> ReLU -> ... -> Linear (ref models/common.py:85-105).

    num_layer counts Linear layers; norm/activation follow every layer except
    the last (unless act_last). Submodules are named like flax's automatic
    names (Dense_0, LayerNorm_0, Dense_1, ...); `dtype` is their compute
    dtype.
    """

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 num_layer: int = 2, norm: bool = True,
                 act_last: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layer, self.norm, self.act_last = num_layer, norm, act_last
        dim = in_dim
        for i in range(num_layer):
            nxt = out_dim if i == num_layer - 1 else hidden_dim
            setattr(self, f'Dense_{i}', Dense(dim, nxt, dtype=dtype))
            if (i < num_layer - 1 or act_last) and norm:
                setattr(self, f'LayerNorm_{i}', LayerNorm(nxt, dtype=dtype))
            dim = nxt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layer):
            x = getattr(self, f'Dense_{i}')(x)
            if i < self.num_layer - 1 or self.act_last:
                if self.norm:
                    x = getattr(self, f'LayerNorm_{i}')(x)
                x = torch.relu(x)
        return x
