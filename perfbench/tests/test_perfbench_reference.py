"""The frozen reference against the port at a tiny size on the CPU (the
port's plain path): the denoiser of both refine nets, then whole cells
(a sampling step, three training steps) through the harness. The test
imports both; perfbench/reference imports nothing of the port."""

import ast
import copy
import time

import numpy as np
import pytest
import torch

from perfbench.core import spec
from perfbench.rehearse import TINY_MODEL, tiny
from perfbench.reference.nets import denoise
from perfbench.run import measure

CELLS = ('bond.sample.b100', 'bond.train.b64', 'o2.sample.b100')


def test_reference_imports_nothing_of_the_program():
    for path in (spec.ROOT / 'perfbench' / 'reference').glob('*.py'):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ''] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split('.')[0] in ('torch', 'numpy', 'math',
                                           'statistics', 'bisect',
                                           'contextlib', '__future__',
                                           'perfbench'), \
                    (path.name, n)
                assert not n.startswith(('perfbench.core', 'perfbench.counts'))


@pytest.mark.parametrize('cell', ['bond.sample.b100', 'o2.sample.b100'])
def test_denoiser_matches_the_port(cell):
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.utils.testing import random_complex_batch
    cfg = dict(copy.deepcopy(spec.load_cell(cell).model), **TINY_MODEL,
               use_pallas=False)
    model = DecompDiffModel.create(cfg, 8, device='cpu', seed=3)
    batch = random_complex_batch(
        np.random.default_rng(1), batch_size=3, num_protein=24,
        num_ligand=8, num_groups=4, real_protein=np.array([24, 19, 11]),
        real_ligand=np.array([8, 6, 4]), device='cpu')
    state = (batch.ligand_pos, batch.ligand_v, batch.bond_type)
    with torch.no_grad():
        got = model.apply(batch, *state, torch.zeros(3, dtype=torch.long))
        P = {k: v.detach() for k, v in model.denoiser.named_parameters()}
        b = {f: getattr(batch, f) for f in batch.__dataclass_fields__}
        want = denoise(P, cfg, b, *state)
    assert set(got) == set(want)
    lig = batch.ligand_mask
    for k in want:
        m = lig if k != 'pred_bond' else batch.bond_mask
        diff = (got[k] - want[k])[m].abs().max()
        assert diff <= 1e-5 * want[k][m].abs().max(), (k, float(diff))


@pytest.mark.parametrize('cell', CELLS)
def test_cell_on_the_cpu_is_correct(cell):
    c = tiny(spec.load_cell(cell))
    result, numbers = measure(c, 7, 1.0, 0, torch.device('cpu'),
                              time.time())[:2]
    line = result.line(numbers)
    assert line['correct'], line['checks']
    assert line['attempted'] > 0
    if 'step_err' in numbers:
        assert numbers['step_err'] < 1e-5
    else:
        assert numbers['batch_err'] == 0 and numbers['loss_gap'] < 1e-5
        assert numbers['wloss_gap'] < 1e-5


def test_a_knn_tie_leaves_its_molecule_out():
    """A ligand atom whose nearest two nodes lie at one distance ties its
    graph's last edge (k = 1): that molecule is left out and counted, the
    other still compared."""
    from perfbench.reference import compare
    from perfbench.reference.nets import knn_margin
    g = torch.Generator().manual_seed(0)
    protein = 5.0 + 10.0 * torch.rand((2, 6, 3), generator=g)
    lig = torch.tensor([[[0.0, 0, 0], [0.5, 0, 0], [0, 0.7, 0]],
                        [[0.0, 0, 0], [0.5, 0, 0], [-0.5, 0, 0]]])
    b = {'protein_pos': protein, 'protein_mask': torch.ones(2, 6, dtype=bool),
         'ligand_mask': torch.ones(2, 3, dtype=bool)}
    margin = knn_margin(b, lig, 1)
    assert margin[0] > 0.5 and margin[1] == 0
    lm, bm = b['ligand_mask'], torch.ones(2, 3, 3, dtype=bool)
    ref = {'pred_ligand_pos': lig, 'pred_ligand_v': torch.ones(2, 3, 4),
           'x_next': lig, 'v_scores': torch.zeros(2, 3, 4),
           'knn_margin': margin}
    prog = {'pred_ligand_pos': lig.clone(), 'pred_ligand_v': ref[
        'pred_ligand_v'].clone(), 'x': lig.clone(),
        'v': torch.zeros(2, 3, dtype=torch.long)}
    prog['x'][1] += 1.0                    # the tied molecule differs
    got = compare.sampling_numbers(prog, ref, lm, bm)
    assert got['ties'] == 1 and got['step_err'] == 0
    prog['x'][0, 0, 0] += 1.0              # the other one is still judged
    assert compare.sampling_numbers(prog, ref, lm, bm)['step_err'] > 0.1
