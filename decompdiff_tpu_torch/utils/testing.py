"""Synthetic fixture builders for tests and the chip smoke run (port of
decompdiff_tpu/utils/testing.py). The numpy draws are the same, in the same
order, so one seed gives bit-identical batches in both packages."""

from __future__ import annotations

import numpy as np
import torch

from decompdiff_tpu_torch.constants import PROTEIN_FEATURE_DIM
from decompdiff_tpu_torch.data.batch import ComplexBatch, make_bond_mask
from decompdiff_tpu_torch.device import DeviceLike, resolve_device


DEFAULT_MODEL_CONFIG = {
    # released hyperparameters (ref configs/training.yml)
    'model_mean_type': 'C0',
    'beta_schedule': 'sigmoid',
    'beta_start': 1.0e-7,
    'beta_end': 2.0e-3,
    'v_beta_schedule': 'cosine',
    'v_beta_s': 0.01,
    'num_diffusion_timesteps': 1000,
    'loss_pos_type': 'mse',
    'sample_time_method': 'symmetric',
    'bond_diffusion': True,
    'bond_net_type': 'lin',
    'num_bond_classes': 5,
    'prior_types': False,
    'h_node_in_bond_net': True,
    'add_prior_node': False,
    'time_emb_dim': 0,
    'time_emb_mode': 'simple',
    'center_pos_mode': 'protein',
    'node_indicator': True,
    'model_type': 'uni_o2_bond',
    'num_blocks': 1,
    'num_layers': 6,
    'hidden_dim': 128,
    'n_heads': 16,
    'edge_feat_dim': 4,
    'num_r_gaussian': 20,
    'knn': 32,
    'act_fn': 'relu',
    'norm': True,
    'cutoff_mode': 'knn',
    'r_max': 10.0,
    'x2h_out_fc': False,
    'sync_twoup': False,
    'use_global_ew': True,
}


def uni_o2_model_config(**overrides) -> dict:
    """The released widths (DEFAULT_MODEL_CONFIG) with the non-bond uni_o2
    refine net, its m-gated edge weights, and the pre_att bond head (the
    bond-diffusion setting tests/test_uni_o2.py builds)."""
    cfg = dict(DEFAULT_MODEL_CONFIG, model_type='uni_o2', ew_net_type='m',
               bond_diffusion=True, bond_net_type='pre_att')
    cfg.update(overrides)
    return cfg


def tiny_model_config(**overrides) -> dict:
    """A scaled-down config for fast CPU tests."""
    cfg = dict(DEFAULT_MODEL_CONFIG)
    cfg.update({
        'num_layers': 2,
        'hidden_dim': 32,
        'n_heads': 4,
        'knn': 8,
        'num_diffusion_timesteps': 50,
    })
    cfg.update(overrides)
    return cfg


def random_complex_batch(rng: np.random.Generator, batch_size=2,
                         num_protein=24, num_ligand=10, num_groups=4,
                         num_classes=8, feat_dim=PROTEIN_FEATURE_DIM + 2,
                         real_protein=None, real_ligand=None,
                         device: DeviceLike = None) -> ComplexBatch:
    """A random but internally-consistent padded complex batch."""
    device = resolve_device(device)
    B, Np, Nl, A = batch_size, num_protein, num_ligand, num_groups
    real_p = np.full(B, Np if real_protein is None else real_protein)
    real_l = np.full(B, Nl if real_ligand is None else real_ligand)

    protein_mask = np.arange(Np)[None, :] < real_p[:, None]
    ligand_mask = np.arange(Nl)[None, :] < real_l[:, None]

    protein_pos = rng.normal(size=(B, Np, 3)).astype(np.float32) * 4.0
    ligand_pos = rng.normal(size=(B, Nl, 3)).astype(np.float32) * 2.0
    protein_feat = (rng.random((B, Np, feat_dim)) < 0.15).astype(np.float32)

    num_arms = rng.integers(1, A, size=(B,))
    # group id per atom: arms 0..num_arms-1, scaffold = num_arms
    decomp = np.zeros((B, Nl), np.int64)
    for b in range(B):
        decomp[b] = rng.integers(0, num_arms[b] + 1, size=(Nl,))
    prior_mask = np.arange(A)[None, :] <= num_arms[:, None]
    prior_centers = rng.normal(size=(B, A, 3)).astype(np.float32) * 3.0
    prior_stds = (0.6 + rng.random((B, A, 3))).astype(np.float32)
    prior_num = np.zeros((B, A), np.int64)
    for b in range(B):
        for a in range(A):
            prior_num[b, a] = int(((decomp[b] == a) & ligand_mask[b]).sum())

    ligand_v = rng.integers(0, num_classes, size=(B, Nl))
    arm_ind = (decomp < num_arms[:, None]).astype(np.int64)
    ligand_aux = np.stack([1 - arm_ind, arm_ind], axis=-1).astype(np.float32)

    bond_type = rng.integers(0, 5, size=(B, Nl, Nl))
    bond_type = np.triu(bond_type, 1)
    bond_type = bond_type + bond_type.transpose(0, 2, 1)
    bond_mask = make_bond_mask(ligand_mask)
    bond_type = np.where(bond_mask, bond_type, 0)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return ComplexBatch(
        protein_pos=t(protein_pos),
        protein_feat=t(protein_feat),
        protein_mask=t(protein_mask),
        ligand_pos=t(ligand_pos),
        ligand_v=t(ligand_v, torch.int32),
        ligand_aux=t(ligand_aux),
        ligand_mask=t(ligand_mask),
        ligand_decomp_idx=t(decomp, torch.int32),
        bond_type=t(bond_type, torch.int32),
        bond_mask=t(bond_mask),
        prior_centers=t(prior_centers),
        prior_stds=t(prior_stds),
        prior_num_atoms=t(prior_num, torch.int32),
        prior_mask=t(prior_mask),
        num_arms=t(num_arms, torch.int32),
    )


# --- ragged complexes for the float64 reference oracle -----------------------
# (tests/reference_oracle.py takes reference-style ragged arrays; the model
# takes their padded batch. The draws are tests/test_oracle_parity.py's.)

def ragged_complexes(rng: np.random.Generator,
                     sizes=((14, 6, 2), (11, 5, 1))) -> list:
    """One dict per complex of (protein atoms, ligand atoms, arms) in
    `sizes`: protein and ligand positions, features, atom types (8
    classes), decomposition, priors and a symmetric bond-type matrix (5
    classes)."""
    graphs = []
    for (n_p, n_l, n_arms) in sizes:
        g = {}
        g['protein_pos'] = rng.normal(size=(n_p, 3)) * 4.0
        g['protein_feat'] = (rng.random((n_p, PROTEIN_FEATURE_DIM + 2))
                             < 0.2).astype(np.float64)
        g['ligand_pos'] = rng.normal(size=(n_l, 3)) * 2.0
        g['ligand_v'] = rng.integers(0, 8, size=(n_l,))
        g['num_arms'] = n_arms
        g['decomp_idx'] = rng.integers(0, n_arms + 1, size=(n_l,))
        arm_ind = (g['decomp_idx'] < n_arms).astype(np.float64)
        g['aux'] = np.stack([1 - arm_ind, arm_ind], -1)
        g['prior_centers'] = rng.normal(size=(n_arms + 1, 3)) * 2.0
        g['prior_stds'] = 0.6 + rng.random((n_arms + 1, 3))
        bt = rng.integers(0, 5, size=(n_l, n_l))
        bt = np.triu(bt, 1)
        g['bond_mat'] = bt + bt.T
        graphs.append(g)
    return graphs


def ragged_arrays(graphs) -> dict:
    """The complexes concatenated as the reference batches them: per-atom
    arrays with batch vectors, the all-pairs ligand bond edge list (src j,
    dst i; 'bond_local' holds (graph, i, j) per edge) and per-atom priors."""
    out = {key: np.concatenate([g[key] for g in graphs]) for key in (
        'protein_pos', 'protein_feat', 'ligand_pos', 'ligand_v', 'aux')}
    out['batch_protein'] = np.concatenate(
        [np.full(len(g['protein_pos']), i) for i, g in enumerate(graphs)])
    out['batch_ligand'] = np.concatenate(
        [np.full(len(g['ligand_pos']), i) for i, g in enumerate(graphs)])
    src, dst, btype, bbatch, local = [], [], [], [], []
    off = 0
    for gi, g in enumerate(graphs):
        n = len(g['ligand_pos'])
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                src.append(off + j)
                dst.append(off + i)
                btype.append(g['bond_mat'][i, j])
                bbatch.append(gi)
                local.append((gi, i, j))
        off += n
    out['bond_index'] = np.array([src, dst], np.int64)
    out['bond_type'] = np.array(btype, np.int64)
    out['batch_bond'] = np.array(bbatch, np.int64)
    out['bond_local'] = local
    out['atom_centers'] = np.concatenate(
        [g['prior_centers'][g['decomp_idx']] for g in graphs])
    out['atom_stds'] = np.concatenate(
        [g['prior_stds'][g['decomp_idx']] for g in graphs])
    return out


def padded_complex_batch(graphs, n_p_pad=16, n_l_pad=8, a_pad=4,
                         device: DeviceLike = None) -> ComplexBatch:
    """The padded batch of ragged_complexes (padded ligand slots far away,
    so that they never enter a kNN graph; they are masked anyway)."""
    B = len(graphs)
    fp = graphs[0]['protein_feat'].shape[1]
    pp = np.zeros((B, n_p_pad, 3), np.float32)
    pf = np.zeros((B, n_p_pad, fp), np.float32)
    pm = np.zeros((B, n_p_pad), bool)
    lp = np.zeros((B, n_l_pad, 3), np.float32)
    lv = np.zeros((B, n_l_pad), np.int32)
    la = np.zeros((B, n_l_pad, 2), np.float32)
    lm = np.zeros((B, n_l_pad), bool)
    di = np.zeros((B, n_l_pad), np.int32)
    bt = np.zeros((B, n_l_pad, n_l_pad), np.int32)
    pc = np.zeros((B, a_pad, 3), np.float32)
    ps = np.ones((B, a_pad, 3), np.float32)
    pn = np.zeros((B, a_pad), np.int32)
    pmask = np.zeros((B, a_pad), bool)
    arms = np.zeros((B,), np.int32)
    for b, g in enumerate(graphs):
        n_p, n_l, n_a = (len(g['protein_pos']), len(g['ligand_pos']),
                         g['num_arms'])
        pp[b, :n_p] = g['protein_pos']
        pf[b, :n_p] = g['protein_feat']
        pm[b, :n_p] = True
        lp[b, :n_l] = g['ligand_pos']
        lp[b, n_l:] = 1e3
        lv[b, :n_l] = g['ligand_v']
        la[b, :n_l] = g['aux']
        lm[b, :n_l] = True
        di[b, :n_l] = g['decomp_idx']
        bt[b, :n_l, :n_l] = g['bond_mat']
        pc[b, :n_a + 1] = g['prior_centers']
        ps[b, :n_a + 1] = g['prior_stds']
        pmask[b, :n_a + 1] = True
        arms[b] = n_a
        for a in range(n_a + 1):
            pn[b, a] = int((g['decomp_idx'] == a).sum())
    bm = make_bond_mask(lm)
    bt = np.where(bm, bt, 0)
    device = resolve_device(device)
    return ComplexBatch(*(torch.as_tensor(a).to(device) for a in (
        pp, pf, pm, lp, lv, la, lm, di, bt, bm, pc, ps, pn, pmask, arms)))


# --- reference-layout .pt checkpoints ---------------------------------------

class _EasyDict(dict):
    """easydict.EasyDict's behaviour (items mirrored as attributes), for
    writing a reference-layout checkpoint where easydict is not
    installed."""

    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            setattr(self, k, v)

    def __setattr__(self, name, value):
        if isinstance(value, dict) and not isinstance(value, _EasyDict):
            value = _EasyDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(_EasyDict(x) if isinstance(x, dict) else x
                                for x in value)
        super().__setattr__(name, value)
        super().__setitem__(name, value)


_EasyDict.__module__, _EasyDict.__name__ = 'easydict', 'EasyDict'
_EasyDict.__qualname__ = 'EasyDict'


def save_reference_checkpoint(path: str, state_dict: dict, config: dict,
                              iteration: int = 0) -> None:
    """torch.save {'config': config as an easydict.EasyDict, 'model': the
    state dict as float32 tensors, 'iteration'}: the layout of a reference
    DecompDiff checkpoint (ref scripts/train_diffusion_decomp.py:293-300).
    Without easydict the config is written as a class of the same module
    and name, installed in sys.modules for the save only."""
    import sys
    import types
    try:
        from easydict import EasyDict
        installed = False
    except ImportError:
        EasyDict, installed = _EasyDict, True
        sys.modules['easydict'] = types.ModuleType('easydict')
        sys.modules['easydict'].EasyDict = _EasyDict
    try:
        model = {k: torch.as_tensor(np.asarray(v, np.float32))
                 for k, v in state_dict.items()}
        torch.save({'config': EasyDict(config), 'model': model,
                    'iteration': iteration}, path)
    finally:
        if installed:
            del sys.modules['easydict']


# --- raw receptor / ligand files for the data-preparation scripts -----------
# (the port's copy of the two-cavity lattice of the JAX package's alpha-sphere
# tests: a cubic lattice of pseudo-atoms with two spherical cavities, and a
# ligand with a 3-ring arm in each cavity joined by a 3-atom linker)

DUMBBELL_LIGAND_SDF = """dumbbell
  synthetic: ring arms in both cavities + 3-atom linker

  9 10  0  0  0  0  0  0  0  0999 V2000
   -6.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
   -6.0000    1.4000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
   -7.2000    0.7000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
   -3.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    0.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    3.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    6.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    6.0000    1.4000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    7.2000    0.7000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
  1  2  1  0
  2  3  1  0
  3  1  1  0
  1  4  1  0
  4  5  1  0
  5  6  1  0
  6  7  1  0
  7  8  1  0
  8  9  1  0
  9  7  1  0
M  END
$$$$
"""


def dumbbell_lattice(spacing=3.0, half=5, cavity_r=4.0) -> np.ndarray:
    """[(2 half + 1)^3 less the cavities, 3] lattice points outside two
    spheres of radius cavity_r centred at x = +-6 A."""
    import itertools
    pts = []
    for i, j, k in itertools.product(range(-half, half + 1), repeat=3):
        p = np.array([i, j, k], float) * spacing
        if min(np.linalg.norm(p - [6, 0, 0]),
               np.linalg.norm(p + [6, 0, 0])) >= cavity_r:
            pts.append(p)
    return np.stack(pts)


def lattice_pdb_block(pos, elements) -> str:
    """A PDB block of one-atom GLY residues (atom name CA for carbon, O
    otherwise) at pos."""
    lines = ['HEADER    SYNTH CAVITY']
    for n, (p, elem) in enumerate(zip(pos, elements), start=1):
        name = 'CA' if elem == 'C' else 'O'
        lines.append(
            f'ATOM  {n:5d}  {name:<3s} GLY A{n:4d}    '
            f'{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}  1.00  0.00'
            f'          {elem:>2s}')
    lines.append('END')
    return '\n'.join(lines) + '\n'


def rigid_motion(rng: np.random.Generator):
    """A random rotation [3, 3] (det +1) and a translation [3] of up to
    20 A per axis."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q, rng.uniform(-20.0, 20.0, size=3)


# the share of a raw receptor's lattice atoms drawn as oxygen
RAW_POLAR_FRAC = 0.25


def write_raw_pairs(root, n_pairs: int, half: int = 5,
                    seed: int = 0) -> list:
    """Writes n_pairs raw receptor PDB / ligand SDF pairs under root, as
    pair<i>/pair<i>_rec.pdb and pair<i>/pair<i>_lig.sdf (the preprocessing
    names each pair's outputs after its ligand's file name, so the names
    are unique, as CrossDocked's are): the dumbbell lattice at
    `half` (about RAW_POLAR_FRAC of its atoms oxygen) and DUMBBELL_LIGAND_SDF,
    each pair moved by its own seeded rigid motion. Returns the index
    entries [{'protein', 'ligand'}] relative to root, as
    scripts/preprocess_subcomplex_torch.py reads them."""
    import os

    from decompdiff_tpu_torch.data.mol import (
        mol_to_sdf_block, parse_mol_block)
    rng = np.random.default_rng(seed)
    lattice = dumbbell_lattice(half=half)
    index = []
    for i in range(n_pairs):
        rot, shift = rigid_motion(rng)
        elements = np.where(rng.random(len(lattice)) < RAW_POLAR_FRAC, 'O', 'C')
        mol = parse_mol_block(DUMBBELL_LIGAND_SDF)
        mol.pos = (mol.pos @ rot.T + shift).astype(np.float32)
        name = f'pair{i}'
        os.makedirs(os.path.join(root, name), exist_ok=True)
        entry = {'protein': f'{name}/{name}_rec.pdb',
                 'ligand': f'{name}/{name}_lig.sdf'}
        with open(os.path.join(root, entry['protein']), 'w') as f:
            f.write(lattice_pdb_block(lattice @ rot.T + shift, elements))
        with open(os.path.join(root, entry['ligand']), 'w') as f:
            f.write(mol_to_sdf_block(mol, name='dumbbell'))
        index.append(entry)
    return index


# --- data-parallel ranks in spawned processes --------------------------------

def _rank_main(rank, world_size, init_file, target, args, device, threads,
               out):
    import os
    import pickle
    import traceback

    from decompdiff_tpu_torch.parallel.mesh import destroy_mesh, make_mesh
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
    torch.set_num_threads(threads)
    try:
        mesh = make_mesh(device=device, init_method=f'file://{init_file}')
        try:
            result = target(mesh, *args)
        finally:
            destroy_mesh(mesh)
    except BaseException:
        with open(f'{out}.err', 'w') as f:
            f.write(traceback.format_exc())
        raise
    with open(out, 'wb') as f:
        pickle.dump(result, f)


def run_ranks(target, world_size: int, init_file: str, args=(), *,
              device='cpu', timeout: float = 120.0, threads: int = 1) -> list:
    """target(mesh, *args) on `world_size` ranks, each a spawned process
    with `threads` torch threads, joined through a file:// store at
    init_file (a path that does not exist yet: concurrent runs never race
    for a port); returns each rank's result in rank order. `target` and
    its results must pickle. Raises when a rank fails; when one fails or
    the timeout expires, every rank still running is killed first."""
    import multiprocessing
    import os
    import pickle
    import time
    ctx = multiprocessing.get_context('spawn')
    outs = [f'{init_file}.rank{r}.pkl' for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, init_file, target, tuple(args), device, threads,
        outs[r])) for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.exitcode is None for p in procs):
            failed = any(p.exitcode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
            p.join()
    errors = [open(f'{o}.err').read() for o in outs
              if os.path.exists(f'{o}.err')]
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        what = 'failed' if errors or time.monotonic() <= deadline else (
            f'timed out after {timeout} s')
        raise RuntimeError(f'ranks {what}: exit codes {codes}\n'
                           + '\n'.join(errors))
    results = []
    for o in outs:
        with open(o, 'rb') as f:
            results.append(pickle.load(f))
    return results


DP_ROW_DRIFTS = ({'type': 'armsca_prox', 'min_d': 1.2, 'max_d': 1.9},
                 {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0})


def dp_row_pairs(model, batch, full_protein, t, world: int = 2) -> dict:
    """What `world` data-parallel ranks compute for a batch, stage by stage
    of a guided sampling step, beside what one process computes:
    {stage: (the whole batch's, the ranks' rows joined in rank order)} for
    the protein centroid (center_by_protein), the guidance gradient of each
    of DP_ROW_DRIFTS (sampler._guidance_grad) and each prediction of one
    denoiser call at t. Each rank takes its rows of the batch and of the
    full protein (parallel/mesh.py shard_batch) and the whole batch's
    centroid offset, as under a mesh; no process group is needed."""
    from decompdiff_tpu_torch.models.diffusion_model import (
        center_by_protein)
    from decompdiff_tpu_torch.parallel.mesh import Mesh, shard_batch
    from decompdiff_tpu_torch.sampling import sampler
    B = batch.batch_size
    meshes = [Mesh(r, world, r, model.device, None) for r in range(world)]

    def joined(fn):
        """torch.cat over the ranks of fn(mesh, its rows of a [B, ...]
        tensor's, its batch, its full protein)."""
        return torch.cat([fn(m, lambda x, m=m: x[m.rows(B)],
                             shard_batch(batch, m),
                             shard_batch(full_protein, m)) for m in meshes])

    pairs = {'protein centroid': (
        center_by_protein(batch, batch.ligand_pos)[2],
        joined(lambda m, rows, b, f: center_by_protein(b, b.ligand_pos)[2]))}
    pc, xt, off = center_by_protein(batch, batch.ligand_pos)
    for drift in DP_ROW_DRIFTS:
        cfg = sampler.SampleConfig(energy_drift=(drift,))
        pairs[f'{drift["type"]} gradient'] = (
            sampler._guidance_grad(model, cfg, batch.replace(
                protein_pos=pc), xt, t, off, full_protein),
            joined(lambda m, rows, b, f: sampler._guidance_grad(
                model, cfg, b.replace(protein_pos=rows(pc)), rows(xt),
                rows(t), rows(off), f, m)))
    with torch.no_grad():
        whole = model.apply(batch, batch.ligand_pos, batch.ligand_v,
                            batch.bond_type, t)
        for k in sorted(whole):
            pairs[f'denoiser {k}'] = (whole[k], joined(
                lambda m, rows, b, f: model.apply(
                    b, b.ligand_pos, b.ligand_v, b.bond_type, rows(t))[k]))
    return pairs
