"""What the three attention kernels share: the per-branch argument bundle,
the attention step of their plain versions, the wrappers' input checks, and
the backward plumbing (parameter-gradient buffers, the plain backward by
autograd).

All three kernels compute, for every destination row and each of its
sources, two "branches" (k and v) of the form

    pre = feat @ w_feat + t_row[row] + t_src[source]
    y   = relu(LayerNorm(pre) * ln_scale + ln_bias)
    out = y @ wo + bo

followed by a masked softmax over the sources of the head-grouped q . k.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence

import torch

from decompdiff_tpu_torch.models.common import layer_norm, masked_softmax
from decompdiff_tpu_torch.ops import _build


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


def launch(fn, args: list, device: torch.device, name: str,
           stream: bool = True) -> None:
    """Call a C launcher on the current stream (or, without `stream`, a C
    function that takes none) and raise on a CUDA error."""
    with torch.cuda.device(device):
        if stream:
            args = args + [ctypes.c_void_p(
                torch.cuda.current_stream(device).cuda_stream)]
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed with cudaError {rc}')


def branch_checks(tag: str, p: Branch, row_shape: tuple, src_shape: tuple,
                  feat_rows: int, H: int, dout: int) -> list:
    """The check_inputs entries of one branch."""
    f32 = torch.float32
    return [(f'{tag}.t_row', p.t_row, row_shape, f32),
            (f'{tag}.t_src', p.t_src, src_shape, f32),
            (f'{tag}.w_feat', p.w_feat, (feat_rows, H), f32),
            (f'{tag}.wo', p.wo, (H, dout), f32),
            (f'{tag}.bo', p.bo, (dout,), f32),
            (f'{tag}.ln_scale', p.ln_scale, (H,), f32),
            (f'{tag}.ln_bias', p.ln_bias, (H,), f32)]


# ---------------------------------------------------------------------------
# backward plumbing
# ---------------------------------------------------------------------------

def backward_blocks(items: int, device: torch.device, per_sm: int = 2) -> int:
    """Blocks of a backward launch: `per_sm` per SM (each loops over rows or
    work items), and no more than there are work items."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(items, per_sm * sms))


@functools.lru_cache(maxsize=None)
def kernel_query(kernel: str, symbol: str, sizes: tuple,
                 device: torch.device) -> int:
    """The int that the query `symbol` of csrc/<kernel>.cu reports for these
    sizes (a property of the build and the card, so asked once)."""
    query = _build.load(kernel, symbol, 1, len(sizes), stream=False)
    value = ctypes.c_int(0)
    launch(query, [ctypes.byref(value)] + list(sizes), device,
           f'{kernel}_backward', stream=False)
    return value.value


def backward_scratch(kernel: str, sizes: list, blocks: int,
                     device: torch.device) -> Optional[torch.Tensor]:
    """The device-memory scratch of a backward launch of csrc/<kernel>.cu at
    these sizes: None when its row buffers fit in shared memory, else
    `blocks` times the floats per block that its <kernel>_bwd_scratch
    reports."""
    per_block = kernel_query(kernel, f'{kernel}_bwd_scratch', tuple(sizes),
                             device)
    if per_block == 0:
        return None
    return torch.empty(blocks * per_block, device=device)


class ParamGrads:
    """The parameter-gradient buffers of a backward launch: per-block slots
    [G, P] that the kernel fills (zeroed, unless `stored`: the kernel stores
    every element rather than adding to it), and the flat [P] sum over
    blocks that its second pass writes. Both branches, each laid out as
    [w_feat (F, H) | wo (H, dout) | bo (dout) | ln_scale (H) | ln_bias (H)],
    then the `extra` shapes of a kernel's own parameters."""

    def __init__(self, blocks: int, feat_rows: int, H: int, dout_v: int,
                 device: torch.device, extra: Sequence[tuple] = (),
                 stored: bool = False):
        self.shapes = [s for dout in (H, dout_v) for s in (
            (feat_rows, H), (H, dout), (dout,), (H,), (H,))] + list(extra)
        size = sum(math.prod(s) for s in self.shapes)
        self.slots = (torch.empty if stored else torch.zeros)(
            (blocks, size), device=device)
        self.out = torch.empty(size, device=device)

    def views(self):
        flat = torch.split(self.out, [math.prod(s) for s in self.shapes])
        return [t.view(s) for t, s in zip(flat, self.shapes)]

    def branches(self, t_row_k, t_src_k, t_row_v, t_src_v):
        """The k and v Branch gradients, from the kernel's per-node
        gradients and the summed parameter gradients."""
        views = self.views()
        return (Branch(t_row_k, t_src_k, *views[:5]),
                Branch(t_row_v, t_src_v, *views[5:10]))

    def extra(self) -> list:
        """The summed gradients of the `extra` parameters."""
        return self.views()[10:]


def autograd_grads(fn, g: torch.Tensor,
                   inputs: Sequence[Optional[torch.Tensor]]) -> list:
    """The plain backward: gradients of fn(*inputs) for the cotangent g, by
    autograd, on the inputs' device; zeros for an input the output does not
    depend on, None for an input that is None."""
    leaves = [None if t is None else t.detach().requires_grad_(True)
              for t in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
    live = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(out, live, g, allow_unused=True))
    result = []
    for t in leaves:
        if t is None:
            result.append(None)
            continue
        d = next(grads)
        result.append(torch.zeros_like(t) if d is None else d)
    return result
