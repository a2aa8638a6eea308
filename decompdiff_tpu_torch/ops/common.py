"""What the three attention kernels share: the per-branch argument bundle,
the attention step of their plain versions, and the wrappers' input checks.

All three kernels compute, for every destination row and each of its
sources, two "branches" (k and v) of the form

    pre = feat @ w_feat + t_row[row] + t_src[source]
    y   = relu(LayerNorm(pre) * ln_scale + ln_bias)
    out = y @ wo + bo

followed by a masked softmax over the sources of the head-grouped q . k.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence

import torch

from decompdiff_tpu_torch.models.common import layer_norm, masked_softmax


class Branch(NamedTuple):
    """One k or v branch. `t_row` carries the first linear's bias."""
    t_row: torch.Tensor     # per-destination-row term
    t_src: torch.Tensor     # per-source term
    w_feat: torch.Tensor    # [F, H] per-pair feature projection
    wo: torch.Tensor        # [H, Dout]
    bo: torch.Tensor        # [Dout]
    ln_scale: torch.Tensor  # [H]
    ln_bias: torch.Tensor   # [H]


def branch_mlp(pre: torch.Tensor, p: Branch) -> torch.Tensor:
    """LayerNorm -> relu -> second linear of one branch (plain version)."""
    y = torch.relu(layer_norm(pre, p.ln_scale, p.ln_bias))
    return y @ p.wo + p.bo


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid: torch.Tensor, n_heads: int,
           rel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked multi-head attention of one query row over its M sources.

    q [..., H]; k [..., M, H]; valid [..., M] bool.
    Node mode (rel None): v [..., M, H] -> sum_m alpha v, [..., H].
    Pos mode: v [..., M, heads], rel [..., M, 3] ->
        mean over heads of sum_m alpha v rel, [..., 3].
    """
    H = q.shape[-1]
    hd = H // n_heads
    qh = q.reshape(q.shape[:-1] + (1, n_heads, hd))
    kh = k.reshape(k.shape[:-1] + (n_heads, hd))
    logits = (qh * kh).sum(-1) / math.sqrt(hd)               # [..., M, heads]
    alpha = masked_softmax(logits, valid[..., None], dim=-2)
    if rel is None:
        vh = v.reshape(v.shape[:-1] + (n_heads, hd))
        out = (alpha[..., None] * vh).sum(-3)                # [..., heads, hd]
        return out.reshape(q.shape)
    out = (alpha[..., None] * v[..., None] * rel[..., None, :]).sum(-3)
    return out.mean(-2)                                      # [..., 3]


# ---------------------------------------------------------------------------
# wrapper side
# ---------------------------------------------------------------------------

def on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA tensors (kernel);
    raises for any other device."""
    if t.device.type == 'cpu':
        return True
    if t.device.type == 'cuda':
        return False
    raise ValueError(f'unsupported device {t.device}: the kernels take CUDA '
                     'tensors and their plain versions CPU tensors')


def check_inputs(device: torch.device,
                 named: Sequence[tuple]) -> None:
    """Each entry is (name, tensor, shape, dtype); raises unless the tensor
    lies on `device`, has that dtype and shape, and is contiguous."""
    for name, t, shape, dtype in named:
        if t.device != device:
            raise ValueError(f'{name} is on {t.device}, expected {device}')
        if t.dtype != dtype:
            raise TypeError(f'{name} has dtype {t.dtype}, expected {dtype}')
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                             f'expected {tuple(shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def check_heads(H: int, n_heads: int) -> None:
    """The kernels run one thread per hidden channel and reduce a head's
    lanes inside one warp."""
    if H % 32 or H > 1024:
        raise ValueError(f'hidden width {H} must be a multiple of 32, <= 1024')
    if H % n_heads:
        raise ValueError(f'{n_heads} heads do not divide width {H}')
    hd = H // n_heads
    if hd > 32 or 32 % hd:
        raise ValueError(f'head width {hd} must divide 32')


def branch_ptrs(p: Branch) -> list:
    return [ctypes.c_void_p(t.data_ptr()) for t in p]


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def launch(fn, args: list, device: torch.device, name: str) -> None:
    """Call a C launcher on the current stream and raise on a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed with cudaError {rc}')
