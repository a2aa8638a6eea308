"""Synthetic complexes for tests and the card smoke run (port of the
generator of scripts/make_synthetic_data.py: the same draws, in the same
order, so one seed gives the same records).

Chemically-shaped random complexes: pocket point clouds + chain-bonded
ligands with arm/scaffold decompositions and golden priors, so the sampling
entry point runs without CrossDocked data.
"""

from __future__ import annotations

import numpy as np

from decompdiff_tpu_torch.data.store import DDStoreWriter
from decompdiff_tpu_torch.priors.golden import compute_golden_prior


def geometry_correlated_types(ligand_pos, protein_pos, n_ligand):
    """Atom types a denoiser can actually learn from geometry (the old
    rng.choice types were pure noise, pinning atom AUROC at chance): chain
    endpoints become O, interior atoms nearer the pocket than the
    per-complex median become N, the rest C. Both signals are visible to
    the model — endpoints have a single <1.8 A neighbor, pocket proximity
    is in the knn context — so validation atom AUROC (ref
    train_diffusion_decomp.py:28-42 protocol) can rise above 0.5."""
    d_prot = np.linalg.norm(
        ligand_pos[:, None] - protein_pos[None], axis=-1).min(1)
    types = np.full(n_ligand, 6, np.int64)
    interior = np.arange(1, n_ligand - 1)
    if interior.size:  # n_ligand <= 2 has no interior (median([]) is NaN)
        near = d_prot[interior] < np.median(d_prot[interior])
        types[interior[near]] = 7
    types[0] = types[n_ligand - 1] = 8
    return types


def synthetic_complex(rng, n_protein=None, n_ligand=None, num_arms=None,
                      random_types=False):
    n_protein = n_protein or int(rng.integers(80, 128))
    n_ligand = n_ligand or int(rng.integers(12, 16))
    num_arms = num_arms or int(rng.integers(1, 4))

    protein_pos = rng.normal(size=(n_protein, 3)).astype(np.float32) * 6
    # ligand: chain with ~1.5 A spacing curled near the pocket center
    steps = rng.normal(size=(n_ligand, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    ligand_pos = np.cumsum(steps * 1.5, axis=0).astype(np.float32)
    ligand_pos -= ligand_pos.mean(0)

    # split chain into arms + scaffold segments
    cuts = sorted(rng.choice(np.arange(2, n_ligand - 2), size=num_arms,
                             replace=False))
    atom_mask = np.full(n_ligand, -1, np.int64)
    prev = 0
    for i, c in enumerate(cuts):
        atom_mask[prev:c] = i
        prev = c

    src = np.arange(n_ligand - 1)
    bond_index = np.stack([np.concatenate([src, src + 1]),
                           np.concatenate([src + 1, src])])
    bond_type = rng.choice([1, 1, 1, 2], size=n_ligand - 1)
    bond_type = np.concatenate([bond_type, bond_type])

    pocket_atom_masks = np.zeros((num_arms, n_protein), bool)
    for a in range(num_arms):
        center = ligand_pos[atom_mask == a].mean(0)
        d = np.linalg.norm(protein_pos - center, axis=-1)
        pocket_atom_masks[a] = d < np.quantile(d, 0.3)

    arms, sca, prior_masks = compute_golden_prior(
        ligand_pos, atom_mask, protein_pos, num_arms)
    return {
        'protein_pos': protein_pos,
        'protein_element': rng.choice([6, 6, 6, 7, 8, 16], size=n_protein),
        'protein_atom_to_aa_type': rng.integers(0, 20, size=n_protein),
        'protein_is_backbone': rng.random(n_protein) < 0.4,
        'ligand_pos': ligand_pos,
        'ligand_element': (
            rng.choice([6, 6, 6, 7, 8], size=n_ligand) if random_types
            else geometry_correlated_types(ligand_pos, protein_pos,
                                           n_ligand)),
        'ligand_bond_index': bond_index,
        'ligand_bond_type': bond_type,
        'ligand_atom_is_aromatic': np.zeros(n_ligand, bool),
        'ligand_atom_mask': atom_mask,
        'pocket_atom_masks': pocket_atom_masks,
        'num_arms': num_arms,
        'num_scaffold': 1,
        'arms_prior': arms,
        'scaffold_prior': sca,
        'pocket_prior_masks': prior_masks,
    }


def write_synthetic_store(path: str, complexes, seed: int = 0) -> None:
    """A DDStore of synthetic complexes keyed synth/<i>, as
    scripts/make_synthetic_data.py writes one: one complex for each dict
    of synthetic_complex arguments in `complexes` ({} for its random
    sizes), drawn in turn from one generator."""
    rng = np.random.default_rng(seed)
    with DDStoreWriter(path, meta={'synthetic': True}) as w:
        for i, kwargs in enumerate(complexes):
            rec = synthetic_complex(rng, **kwargs)
            rec['src_ligand_filename'] = f'synth/{i:05d}.sdf'
            w.append(f'synth/{i:05d}', rec)
