"""Host-side generation initialization — per prior mode, build the
records and initial types the sampler starts from (port of
decompdiff_tpu/sampling/init.py; the same draws from the caller's
np.random.Generator, in the same order).

Behavioral parity with ref scripts/sample_diffusion_decomp.py:56-316:
  * subpocket: pocket sizes -> atom counts (modes prior/ref/ref_large), init
    positions ~ N(pocket centroid, 1)  (ref :80-147)
  * ref_prior: golden mu/sigma + reference atom counts (ref :149-201)
  * beta_prior: AlphaSpace2 priors; atom-count modes old (linear fit of count
    vs std), v2 (prior counts), stat (NumAtomsSampler)  (ref :203-295)
  * init atom/bond types ~ dataset marginals or uniform Gumbel (ref :297-316)
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from decompdiff_tpu_torch.data.transforms import (
    add_decomp_indicator, compute_noise_dist, featurize_protein_atom)
from decompdiff_tpu_torch.priors.atom_num import (
    NumAtomsSampler, get_space_size, sample_atom_num)

# linear count~std fit used by beta_prior 'old' mode (ref :269-270)
_OLD_M, _OLD_B = 12.41, -4.98


def _sample_part_atom_counts(raw: dict, prior_mode: str, num_atoms_mode: str,
                             rng: np.random.Generator,
                             arms_natoms_config=None,
                             scaffold_natoms_config=None,
                             natoms_sampler: Optional[NumAtomsSampler] = None):
    """Returns (arm_counts [num_arms], scaffold_count, centers [A,3], stds [A,3])."""
    num_arms = int(raw['num_arms'])
    protein_pos = np.asarray(raw['protein_pos'], np.float32)

    if prior_mode == 'subpocket':
        arm_centers = []
        arm_sizes = []
        for mask in raw['pocket_atom_masks']:
            arm_centers.append(protein_pos[mask].mean(0))
            arm_sizes.append(get_space_size(protein_pos[mask]))
        sca_center = protein_pos.mean(0)
        sca_size = get_space_size(protein_pos)
        centers = np.stack(arm_centers + [sca_center])
        stds = np.ones_like(centers)
        ref_mask = np.asarray(raw['ligand_atom_mask'])
        arm_counts, sca_count = [], 0
        for arm_i in range(num_arms):
            if num_atoms_mode == 'prior':
                arm_counts.append(sample_atom_num(
                    arm_sizes[arm_i], arms_natoms_config, rng))
            elif num_atoms_mode == 'ref':
                arm_counts.append(int((ref_mask == arm_i).sum()))
            elif num_atoms_mode == 'ref_large':
                inc = math.ceil(10 / (num_arms + 2))
                arm_counts.append(int((ref_mask == arm_i).sum()) + inc)
            else:
                raise ValueError(num_atoms_mode)
        if num_atoms_mode == 'prior':
            sca_count = sample_atom_num(sca_size, scaffold_natoms_config, rng)
        elif num_atoms_mode == 'ref':
            sca_count = int((ref_mask == -1).sum())
        else:
            sca_count = int((ref_mask == -1).sum()) + \
                2 * math.ceil(10 / (num_arms + 2))
        return arm_counts, sca_count, centers, stds

    # ref_prior / beta_prior share the center/std tables from the transform
    nd = compute_noise_dist(raw, prior_mode)
    centers, stds = nd['centers'].copy(), nd['stds'].copy()

    if prior_mode == 'ref_prior':
        arm_counts = [int(p[0]) for p in raw['arms_prior']]
        sca_count = int(raw['scaffold_prior'][0][0]) \
            if len(raw['scaffold_prior']) == 1 else 0
        return arm_counts, sca_count, centers, stds

    if prior_mode == 'beta_prior':
        if num_atoms_mode == 'v2':
            arm_counts = [int(p[0]) for p in raw['arms_prior']]
            sca_count = int(raw['scaffold_prior'][0][0]) \
                if len(raw['scaffold_prior']) else 0
        elif num_atoms_mode == 'old':
            arm_counts = []
            for arm_i in range(num_arms):
                s = float(stds[arm_i, 0])
                lo = max(int(np.floor((_OLD_M - 2.0) * s + _OLD_B)), 2)
                hi = max(int(np.ceil((_OLD_M + 3.0) * s + _OLD_B)), 2)
                arm_counts.append(int(rng.integers(lo, hi + 1)))
            s = float(stds[-1, 0])
            lo = max(int(np.ceil((_OLD_M - 2.0) * s + _OLD_B)), 2)
            hi = max(int(np.ceil((_OLD_M + 3.0) * s + _OLD_B)), 2)
            sca_count = int(rng.integers(lo, hi + 1))
        elif num_atoms_mode == 'stat':
            assert natoms_sampler is not None, "'stat' needs a NumAtomsSampler"
            arm_centers = centers[:num_arms]
            arm_counts, arm_stds = natoms_sampler.sample_arm_natoms(
                arm_centers, protein_pos, rng)
            stds[:num_arms] = arm_stds
            if len(raw['scaffold_prior']) > 0:
                sca_count, sca_std = natoms_sampler.sample_sca_natoms(
                    centers[-1], arm_centers, arm_stds, protein_pos, rng)
                stds[-1] = sca_std
            else:
                sca_count = 0
                # 'stat' REPLACES the transform's std table with the sampled
                # stds, scaffold row 0 when there is no scaffold prior (ref
                # sample_diffusion_decomp.py:229-230,320-321) — the model's
                # prior-node features see this table
                stds[-1] = 0.0
        else:
            raise ValueError(num_atoms_mode)
        return arm_counts, sca_count, centers, stds

    raise ValueError(prior_mode)


def build_generation_records(raw: dict, n_samples: int, prior_mode: str,
                             num_atoms_mode: str = 'ref',
                             rng: Optional[np.random.Generator] = None,
                             arms_natoms_config=None,
                             scaffold_natoms_config=None,
                             natoms_sampler=None) -> List[dict]:
    """One featurized record per generated sample, with freshly-sampled atom
    counts and init positions (stored in 'ligand_pos')."""
    rng = rng or np.random.default_rng()
    num_arms = int(raw['num_arms'])
    protein_feat_cache = None
    records = []
    for _ in range(n_samples):
        arm_counts, sca_count, centers, stds = _sample_part_atom_counts(
            raw, prior_mode, num_atoms_mode, rng,
            arms_natoms_config, scaffold_natoms_config, natoms_sampler)
        atom_mask = np.concatenate(
            [np.full(c, i, np.int64) for i, c in enumerate(arm_counts)]
            + [np.full(sca_count, -1, np.int64)])
        n_atoms = len(atom_mask)
        init_pos = np.empty((n_atoms, 3), np.float32)
        offset = 0
        for i, c in enumerate(arm_counts):
            init_pos[offset:offset + c] = centers[i] + \
                rng.standard_normal((c, 3)).astype(np.float32) * stds[i]
            offset += c
        init_pos[offset:] = centers[-1] + \
            rng.standard_normal((sca_count, 3)).astype(np.float32) * stds[-1]

        gen_raw = dict(raw)
        gen_raw['ligand_atom_mask'] = atom_mask
        gen_raw['ligand_pos'] = init_pos
        ind = add_decomp_indicator(gen_raw)
        if protein_feat_cache is None:
            pf = featurize_protein_atom(
                raw['protein_element'], raw['protein_atom_to_aa_type'],
                raw['protein_is_backbone'])
            protein_feat_cache = np.concatenate(
                [pf, ind['protein_contact']], -1)
        part_counts = np.array(arm_counts + [sca_count], np.int64)
        records.append({
            'protein_pos': np.asarray(raw['protein_pos'], np.float32),
            'protein_feat': protein_feat_cache,
            'ligand_pos': init_pos,
            'ligand_v': np.zeros(n_atoms, np.int64),  # sampled on device
            'ligand_aux': ind['ligand_aux'],
            'ligand_decomp_idx': ind['decomp_idx'],
            'bond_type': np.zeros((n_atoms, n_atoms), np.int64),
            'prior_centers': centers,
            'prior_stds': stds,
            'prior_num_atoms': part_counts,
            'num_arms': num_arms,
        })
    return records


def init_types_host(rng: np.random.Generator, records, num_classes: int,
                    num_bond_classes: int, atom_prior_probs=None,
                    bond_prior_probs=None):
    """Sample initial atom/bond types host-side (marginal or uniform;
    ref :297-316). Mutates the records' ligand_v / bond_type in place."""
    for r in records:
        n = len(r['ligand_v'])
        if atom_prior_probs is not None:
            p = np.asarray(atom_prior_probs, np.float64)
            r['ligand_v'] = rng.choice(num_classes, size=n, p=p / p.sum())
        else:
            r['ligand_v'] = rng.integers(0, num_classes, size=n)
        # directed fc edges are initialized independently, like the
        # reference's per-edge draws (ref :141-147); reconstruction later
        # reads the i<j direction
        if bond_prior_probs is not None:
            p = np.asarray(bond_prior_probs, np.float64)
            bt = rng.choice(num_bond_classes, size=(n, n), p=p / p.sum())
        else:
            bt = rng.integers(0, num_bond_classes, size=(n, n))
        np.fill_diagonal(bt, 0)
        r['bond_type'] = bt
    return records
