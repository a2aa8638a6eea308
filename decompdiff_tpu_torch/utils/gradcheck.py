"""Hold a backward kernel's gradients against plain autograd's.

Both sides run in float32 with other summation orders, so every gradient is
held elementwise: |got - want| <= GRAD_RTOL |want| + GRAD_ATOL max(1,
|want|max). One thing moves a gradient further. A relu gate whose input
y = LayerNorm(pre) lies within float32 rounding of 0 can fall on the other
side in the kernel's recomputed LayerNorm than in torch's (a flip), and
the gradient through it then differs by its whole upstream value. A call
holds millions of gates (tens of millions at H = 1024), and a few flip.

So `compare_backward` takes the full cotangent first. Where a gradient
lies outside the tolerance under it, it finds the ambiguous gates (a
nonzero upstream gradient and |y| within GATE_MARGIN times the plain
version's largest float32 error of y, measured against float64) and the
output rows that explain the elements outside (`implicated_rows`), zeroes
the cotangent on those rows only, and compares every gradient again:

- an element outside in a row-local gradient (ROW_LOCAL: d q, d e_w,
  d h_bond, d angle, d t_row of either branch) must lie on a row that holds
  an ambiguous gate, or the comparison fails; that row is zeroed;
- where no row-local gradient has one, an element outside at channel c of a
  per-channel gradient of a branch (CHANNEL_AXIS: its t_src, w_feat, wo,
  ln_scale, ln_bias) implicates the rows that hold an ambiguous gate of
  that branch at channel c.

Row-local rows go first because a flip's LayerNorm backward spreads a
1/H share of its change over every channel of its pair, which can put a
large flip's source gradients outside at channels where no gate flipped.
It repeats while that adds rows, at most MAX_ROUNDS times, and passes when
every gradient holds with at most MAX_ZEROED of the live rows (those with a
nonzero upstream gradient at some gate) zeroed.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, List, Optional

import torch

from decompdiff_tpu_torch.models.common import layer_norm
from decompdiff_tpu_torch.ops.common import Branch

GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
GATE_MARGIN = 8.0
# the share of live rows that may be zeroed; a bound on what the readings
# need (PERF.md section 7), whatever the width
MAX_ZEROED = 0.1
MAX_ROUNDS = 3
# each backward wrapper's differentiable inputs, ahead of the two Branch
# gradients (and the gate's and x_src's)
DIFF_INPUTS = {'edge_attention': ('x', 'e_w', 'q'),
               'bond_attention': ('h_bond', 'x', 'q'),
               'triplet_attention': ('angle', 'q')}
ROW_LOCAL = ('q', 'e_w', 'h_bond', 'angle', 'k.t_row', 'v.t_row')
CHANNEL_AXIS = {'t_src': -1, 'w_feat': -1, 'wo': 0, 'ln_scale': 0,
                'ln_bias': 0}


def grad_labels(op: str, kw: dict) -> tuple:
    """The names of the flat gradients of op's backward wrapper."""
    return DIFF_INPUTS[op] + tuple(
        f'{b}.{f}' for b in 'kv' for f in Branch._fields) + (
        ('gate.wm', 'gate.bm') if kw.get('gate') is not None else ()) + (
        ('x_src',) if kw.get('x_src') is not None else ())


def flat_grads(grads) -> list:
    """A backward wrapper's result as a flat list (Branch fields and the
    gate's (d wm, d bm) spread)."""
    out = []
    for g in grads:
        out += list(g) if isinstance(g, tuple) else [g]
    return out


def outside(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The elements of gradient a outside the tolerance of b (moved to a's
    device); a non-finite element of a counts as outside."""
    b = b.to(a.device)
    scale = max(1.0, float(b.abs().max()))
    return ~((a - b).abs() <= GRAD_ATOL * scale + GRAD_RTOL * b.abs())


def _cast(a, dtype):
    if isinstance(a, Branch):
        return Branch(*(_cast(t, dtype) for t in a))
    if isinstance(a, tuple):                     # the m-gate (wm, bm)
        return tuple(_cast(t, dtype) for t in a)
    if torch.is_tensor(a) and a.is_floating_point():
        return a.detach().to(dtype)
    return a


def ambiguous_gates(op: str, g: torch.Tensor, args, kw):
    """(gates, live, tau) for cotangent g of op's plain version on these
    inputs: gates[b] (b = 0: k, 1: v) is True at the branch's relu gates
    [rows..., sources, H] with a nonzero upstream gradient and |y| within
    tau = GATE_MARGIN x max |y - y64| of 0, where y64 is y from the same
    inputs in float64; live is True at the output rows g.shape[:-1] that
    hold a gate with a nonzero upstream gradient."""
    mod = importlib.import_module(f'decompdiff_tpu_torch.ops.{op}')
    plain, mlp = getattr(mod, f'{op}_reference'), mod.branch_mlp

    def run(dtype):
        """The plain output, and per branch call y and relu(y) as a leaf."""
        recs = []

        def record(pre, p):
            y = layer_norm(pre, p.ln_scale, p.ln_bias)
            r = torch.relu(y).detach().requires_grad_(True)
            recs.append((y.detach(), r))
            return r @ p.wo + p.bo
        mod.branch_mlp = record
        try:
            with torch.enable_grad():
                out = plain(*(_cast(a, dtype) for a in args),
                            **{k: _cast(a, dtype) for k, a in kw.items()})
        finally:
            mod.branch_mlp = mlp
        return out, recs

    out, recs = run(torch.float32)
    ups = torch.autograd.grad(out, [r for _, r in recs], g)
    recs64 = run(torch.float64)[1]
    tau = GATE_MARGIN * max(float((y - y64).abs().max())
                            for (y, _), (y64, _) in zip(recs, recs64))
    nd = g.ndim - 1
    live = torch.zeros(g.shape[:-1], dtype=torch.bool, device=g.device)
    gates = []
    for (y, _), u in zip(recs, ups):
        hot = u != 0
        gates.append((y.abs() <= tau) & hot)
        live = live | hot.flatten(nd).any(-1)
    return gates, live, tau


def implicated_rows(outs: dict, gates: list, nd: int):
    """(rows, unexplained): the output rows (bool, the first nd dims of a
    gate) that explain the elements outside (`outs`: label -> bool mask),
    and the labels of row-local gradients with an element outside on a row
    that holds no ambiguous gate."""
    ambiguous = gates[0].flatten(nd).any(-1) | gates[1].flatten(nd).any(-1)
    rows = torch.zeros_like(ambiguous)
    unexplained = []
    for label in ROW_LOCAL:
        if label in outs:
            hit = outs[label].flatten(nd).any(-1)
            if bool((hit & ~ambiguous).any()):
                unexplained.append(label)
            rows = rows | (hit & ambiguous)
    if bool(rows.any()) or unexplained:
        return rows, unexplained
    for label, out in outs.items():
        branch, _, field = label.rpartition('.')
        if branch in ('k', 'v') and field in CHANNEL_AXIS:
            axis = CHANNEL_AXIS[field]
            chans = out.movedim(axis, 0).reshape(out.shape[axis], -1)
            hit = gates['kv'.index(branch)] & chans.any(-1)
            rows = rows | hit.flatten(nd).any(-1)
    return rows, unexplained


@dataclasses.dataclass
class Verdict:
    ok: bool
    message: str
    g: torch.Tensor          # the cotangent of the last comparison
    got: list                # the kernel's flat gradients for g
    errors: dict             # label -> (max abs error, error / scale,
                             #           elements outside) for g
    full_outside: int        # elements outside under the full cotangent
    zeroed: int = 0          # output rows zeroed
    live: int = 0
    ambiguous: int = 0       # live rows that hold an ambiguous gate
    tau: float = 0.0


def compare_backward(op: str, kernel: Callable, plain: Callable,
                     g: torch.Tensor, args, kw: dict,
                     retry: bool = True) -> Verdict:
    """Every gradient of kernel(g) against plain(g) (each returns op's
    backward wrapper's result), with the cotangent zeroed where needed on
    the rows that implicated_rows finds (not at all without `retry`). args
    and kw: op's inputs on g's device, for ambiguous_gates."""
    labels = grad_labels(op, kw)
    nd = g.ndim - 1
    zero: Optional[torch.Tensor] = None
    gates: List[torch.Tensor] = []
    live = None
    tau, full, unexplained = 0.0, None, []
    for rnd in range(MAX_ROUNDS + 1):
        gz = g if zero is None else g * (~zero)[..., None].to(g.dtype)
        got, want = flat_grads(kernel(gz)), flat_grads(plain(gz))
        if len(got) != len(labels) or len(want) != len(labels):
            return Verdict(False, f'{len(got)} gradients, expected '
                           f'{len(labels)}', gz, got, {}, 0)
        outs, errors = {}, {}
        for label, a, b in zip(labels, got, want):
            if b is None:
                if a is not None:
                    return Verdict(False, f'd {label} should be None', gz,
                                   got, {}, 0)
                continue
            if a is None or a.shape != b.shape:
                return Verdict(False, f'd {label}: shape '
                               f'{None if a is None else tuple(a.shape)}, '
                               f'expected {tuple(b.shape)}', gz, got, {}, 0)
            outs[label] = outside(a, b)
            scale = max(1.0, float(b.abs().max()))
            err = float((a - b.to(a.device)).abs().max())
            errors[label] = (err, err / scale, int(outs[label].sum()))
        n_out = sum(e[2] for e in errors.values())
        if full is None:
            full = n_out
        if n_out == 0 or not retry or rnd == MAX_ROUNDS:
            break
        if zero is None:
            gates, live, tau = ambiguous_gates(op, g, args, kw)
            zero = torch.zeros_like(live)
        rows, unexplained = implicated_rows(outs, gates, nd)
        if unexplained or not bool((rows & ~zero).any()):
            break
        zero = zero | rows
    v = Verdict(n_out == 0, '', gz, got, errors, full)
    if zero is not None:
        ambiguous = (gates[0].flatten(nd).any(-1)
                     | gates[1].flatten(nd).any(-1))
        v.zeroed, v.live = int(zero.sum()), int(live.sum())
        v.ambiguous, v.tau = int(ambiguous.sum()), tau
    if unexplained:
        v.ok = False
        v.message = (f'd {", d ".join(unexplained)}: elements outside on '
                     'rows that hold no ambiguous gate')
    elif v.zeroed > MAX_ZEROED * v.live:
        v.ok = False
        v.message = (f'{v.zeroed} of {v.live} rows zeroed, more than '
                     f'{MAX_ZEROED:.0%}')
    elif not v.ok:
        v.message = ', '.join(f'd {k}: {e[2]} elements outside, max '
                              f'err/scale {e[1]:.3e}'
                              for k, e in errors.items() if e[2])
    return v
