"""counts/work.py against a brute-force count at tiny shapes: the port's
plain path runs one denoiser call on a ragged batch, every attention call's
inputs are captured, and the valid rows, pairs and triplets are counted
from the masks the call received, the bytes from its tensors."""

import copy
import itertools

import numpy as np
import pytest
import torch

from perfbench.core import spec
from perfbench.counts import work
from perfbench.rehearse import TINY_MODEL

OPS = ('edge_attention', 'bond_attention', 'triplet_attention')
PROTEIN, LIGAND = (20, 17), (7, 5)


def _captured(model_type):
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.ops import (bond_attention, edge_attention,
                                          triplet_attention)
    from decompdiff_tpu_torch.utils.testing import random_complex_batch
    mods = dict(zip(OPS, (edge_attention, bond_attention, triplet_attention)))
    name = 'decompdiff_bond' if model_type == 'uni_o2_bond' else \
        'targetdiff_o2'
    cell = spec.load_cell({'decompdiff_bond': 'bond.sample.b100',
                           'targetdiff_o2': 'o2.sample.b100'}[name])
    cfg = dict(copy.deepcopy(cell.model), **TINY_MODEL, use_pallas=False)
    model = DecompDiffModel.create(cfg, 8, device='cpu', seed=0)
    batch = random_complex_batch(
        np.random.default_rng(0), batch_size=2, num_protein=24, num_ligand=8,
        num_groups=4, real_protein=np.array(PROTEIN),
        real_ligand=np.array(LIGAND), device='cpu')
    calls, originals = [], {}
    for op, mod in mods.items():
        orig = originals[op] = getattr(mod, f'{op}_reference')

        def record(*args, _op=op, _orig=orig, **kw):
            out = _orig(*args, **kw)
            calls.append((_op, kw.get('pos_mode', False), args, out))
            return out
        setattr(mod, f'{op}_reference', record)
    try:
        with torch.no_grad():
            model.apply(batch, batch.ligand_pos, batch.ligand_v,
                        batch.bond_type,
                        torch.zeros(2, dtype=torch.long))
    finally:
        for op, mod in mods.items():
            setattr(mod, f'{op}_reference', originals[op])
    shapes = work.Shapes(Np=24, Nl=8, protein=PROTEIN, ligand=LIGAND,
                         H=cfg['hidden_dim'], heads=cfg['n_heads'],
                         K=cfg['knn'], layers=cfg['num_layers'],
                         model_type=model_type, classes=8, bond_classes=5)
    return calls, shapes


def _tensors(args):
    for a in args:
        if torch.is_tensor(a):
            yield a
        elif isinstance(a, tuple):
            yield from _tensors(a)


def _brute(op, pos, args, H, nh):
    """(valid pairs by loops over the call's own mask, FLOPs from them)."""
    if op == 'edge_attention':
        mask = args[4] > 0.5
        pairs = sum(bool(mask[idx]) for idx in itertools.product(
            *map(range, mask.shape)))
        first = 2 * 2 * 21 * H
    elif op == 'bond_attention':
        mask = args[2] > 0.5
        pairs = sum(bool(mask[idx]) for idx in itertools.product(
            *map(range, mask.shape)))
        first = 2 * 2 * H * H
    else:
        m = args[1] > 0.5
        B, Nl = m.shape[:2]
        pairs = sum(bool(m[b, i, j]) and bool(m[b, j, k]) and i != k
                    for b in range(B) for i in range(Nl) for j in range(Nl)
                    for k in range(Nl))
        first = 2 * 2 * 13 * H
    # k second linear, q.k, v second linear and alpha.v (pos: alpha v rel
    # over heads)
    v = (2 * H * nh + 2 * H + 6 * nh) if pos else (2 * H * H + 2 * H)
    return pairs, pairs * (first + 2 * H * H + 2 * H + v)


@pytest.mark.parametrize('model_type', ['uni_o2_bond', 'uni_o2'])
def test_forward_counts_match_the_calls(model_type):
    calls, s = _captured(model_type)
    counted = work.forward_calls(s)
    assert sorted(c[0] for c in counted) == sorted(c[0] for c in calls)
    by_key = {}
    for op, f, b in counted:
        by_key.setdefault(op, []).append((f, b))
    for op, pos, args, out in calls:
        pairs, flops = _brute(op, pos, args, s.H, s.heads)
        assert pairs > 0
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(args))
        nbytes += out.numel() * out.element_size()
        assert (flops, nbytes) in by_key[op], (op, pos, flops, nbytes,
                                               by_key[op])


def test_backward_rows_match_the_masks():
    calls, s = _captured('uni_o2_bond')
    e, rows, pairs, trip, trows, nodes, lig = work._valid(s)
    from decompdiff_tpu_torch.ops.triplet_attention import triplet_mask
    for op, pos, args, out in calls:
        if op == 'edge_attention':
            m = args[4] > 0.5
            assert int(m.sum()) == e and int(m.any(-1).sum()) == rows
        elif op == 'bond_attention':
            m = args[2] > 0.5
            assert int(m.sum()) == pairs
            assert int(m.any(-1).sum()) == work.rows_bond(s)
        else:
            m = triplet_mask(args[1])
            assert int(m.sum()) == trip and int(m.any(-1).sum()) == trows
    assert len(work.backward_calls(s)) == len(calls)


def test_least_time_takes_the_larger_bound():
    peaks = work.PEAKS
    assert work.least_seconds(peaks['flops_per_s'], 0) == 1.0
    assert work.least_seconds(0, peaks['bytes_per_s']) == 1.0
