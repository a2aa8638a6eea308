"""The backward comparison that the card tests and chip_smoke.py use
(decompdiff_tpu_torch/utils/gradcheck.py), on the CPU: a fake kernel is the
plain backward plus a change that sits on one output row or one channel, as
a flipped relu gate's would, or elsewhere, as a fault's would. Where a
comparison passes, it must zero only the rows that explain the change.
"""

import numpy as np
import pytest
import torch

from decompdiff_tpu_torch.ops import bond_attention as bond_ops
from decompdiff_tpu_torch.ops.common import Branch
from decompdiff_tpu_torch.utils import gradcheck

B, NL, H, HEADS = 2, 8, 32, 4
ROW = (1, 3)          # the output row a fake flip sits on


def _case(pos_mode=False):
    rng = np.random.default_rng(0)

    def rand(*shape, scale=0.3):
        return torch.as_tensor(rng.normal(size=shape) * scale,
                               dtype=torch.float32)

    def branch(dout):
        return Branch(rand(B, NL, H, scale=1.0), rand(B, NL, H, scale=1.0),
                      rand(H, H), rand(H, dout), rand(dout), 1.0 + rand(H),
                      rand(H))

    bm = (torch.ones(NL, NL) - torch.eye(NL)).expand(B, NL, NL).contiguous()
    args = (rand(B, NL, NL, H, scale=1.0),
            rand(B, NL, 3, scale=2.0) if pos_mode else None, bm,
            rand(B, NL, H, scale=1.0), branch(H),
            branch(HEADS if pos_mode else H))
    kw = dict(n_heads=HEADS, pos_mode=pos_mode)
    g = rand(B, NL, 3 if pos_mode else H, scale=1.0)
    return args, kw, g


def _plain(args, kw):
    return lambda g: bond_ops.bond_attention_backward_reference(g, *args,
                                                                **kw)


def _faulty(args, kw, label, index, always=False):
    """The plain backward with 1 added to gradient `label` at `index` while
    the cotangent's row ROW is nonzero (as a flip on that row: zeroing the
    row takes it away), or, with `always`, whatever the cotangent."""
    labels = gradcheck.grad_labels('bond_attention', kw)
    plain = _plain(args, kw)

    def kernel(g):
        grads = gradcheck.flat_grads(plain(g))
        if always or bool(g[ROW].abs().sum() > 0):
            i = labels.index(label)
            grads[i] = grads[i].clone()
            grads[i][index] += 1.0
        return grads
    return kernel


def _compare(args, kw, g, kernel, margin, monkeypatch):
    monkeypatch.setattr(gradcheck, 'GATE_MARGIN', margin)
    return gradcheck.compare_backward('bond_attention', kernel,
                                      _plain(args, kw), g, args, kw)


@pytest.mark.parametrize('pos_mode', [False, True], ids=['node', 'pos'])
def test_plain_against_itself_zeroes_nothing(pos_mode, monkeypatch):
    args, kw, g = _case(pos_mode)
    v = _compare(args, kw, g, lambda g: gradcheck.flat_grads(
        _plain(args, kw)(g)), 1e9, monkeypatch)
    assert v.ok and v.full_outside == 0 and v.zeroed == 0 and v.live == 0


@pytest.mark.parametrize('label', ['q', 'h_bond', 'k.t_row', 'v.t_row'])
def test_row_local_flip_zeroes_its_row_only(label, monkeypatch):
    """Every gate ambiguous (a huge margin): the row that holds the change
    is zeroed, and no other."""
    args, kw, g = _case()
    v = _compare(args, kw, g, _faulty(args, kw, label, ROW),
                 1e9, monkeypatch)
    assert v.ok, v.message
    assert v.full_outside > 0 and v.zeroed == 1 and v.live == B * NL
    assert float(v.g[ROW].abs().max()) == 0.0
    assert float(v.g.abs().sum()) > 0.0


def test_row_local_change_without_ambiguous_gate_fails(monkeypatch):
    """No gate ambiguous (margin 0): a change on a row fails, though zeroing
    the row would take it away."""
    args, kw, g = _case()
    v = _compare(args, kw, g, _faulty(args, kw, 'q', ROW), 0.0,
                 monkeypatch)
    assert not v.ok and 'no ambiguous gate' in v.message


def test_change_that_zeroing_keeps_fails(monkeypatch):
    """A change that stays whatever the cotangent (a fault) fails with
    every gate ambiguous."""
    args, kw, g = _case()
    v = _compare(args, kw, g, _faulty(args, kw, 'q', ROW, always=True),
                 1e9, monkeypatch)
    assert not v.ok


def test_channel_change_zeroes_the_rows_of_its_channel(monkeypatch):
    """A change on one channel of a source gradient implicates every row
    with an ambiguous gate of that branch at that channel: with every gate
    ambiguous, all rows, more than MAX_ZEROED."""
    args, kw, g = _case()
    v = _compare(args, kw, g, _faulty(args, kw, 'k.t_src', (0, 2, 5)), 1e9,
                 monkeypatch)
    assert not v.ok and v.zeroed == B * NL and 'more than' in v.message


def test_no_retry_compares_the_full_cotangent_only(monkeypatch):
    args, kw, g = _case()
    monkeypatch.setattr(gradcheck, 'GATE_MARGIN', 1e9)
    v = gradcheck.compare_backward(
        'bond_attention', _faulty(args, kw, 'q', ROW),
        _plain(args, kw), g, args, kw, retry=False)
    assert not v.ok and v.zeroed == 0 and torch.equal(v.g, g)
