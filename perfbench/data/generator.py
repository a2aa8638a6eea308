"""Synthetic protein-ligand complexes for the benchmark, drawn from a seed.

A frozen copy of the port's generator (decompdiff_tpu_torch/data/synthetic.py,
synthetic_complex, and priors/golden.py compute_golden_prior), resized to
CrossDocked's sizes: a receptor of 3,000-3,600 atoms, a pocket cut from it of
290-320 atoms (the port's 320 rung), and a reference ligand of 25-32 atoms
(the 32 rung) with 2-4 arms and a scaffold. The ranges come from the
traffic file. Every seed gets the same set of sizes, spread evenly over
each range (one complex: the middle of each range), and the seed draws
only which complex gets which size, the geometry and the types: a run's
work then does not move with its seed. The draws are numpy's, from
np.random.default_rng(seed), so one seed gives one set of complexes on any
machine.

A record holds the raw keys of the port's store (decompdiff_tpu_torch/data
/store.py records, as data/dataset.py make_raw_record writes them), so the
port's DecompDataset featurizes it; the reference featurizes the same dict
with its own copy (reference/featurize.py).
"""

from __future__ import annotations

import numpy as np

POCKET_PRIOR_CONTACT_THRESHOLD = 6.0   # ref utils/prior.py:129
PROTEIN_DENSITY = 0.05                 # heavy atoms per cubic angstrom
LIGAND_CLEARANCE = 3.0                 # no receptor atom nearer the ligand


def _iso_aniso(pos: np.ndarray):
    mu = pos.mean(0)
    centered = (pos - mu[None]).reshape(-1, 1)
    iso_cov = (centered.T @ centered / centered.shape[0]) * np.eye(3)
    c = pos - mu[None]
    return mu, iso_cov, mu, c.T @ c / pos.shape[0]


def golden_prior(ligand_pos, atom_mask, protein_pos, num_arms):
    """(arms_prior, scaffold_prior, pocket_prior_masks): per arm and for the
    scaffold (atom_num, iso_mu, iso_cov, aniso_mu, aniso_cov), and their 6 A
    pocket-contact masks (ref utils/prior.py:126-159)."""
    arms, masks = [], []
    for arm in range(num_arms):
        pos = ligand_pos[atom_mask == arm]
        mu, iso, amu, aniso = _iso_aniso(pos)
        arms.append((pos.shape[0], mu, iso, amu, aniso))
        masks.append(np.linalg.norm(protein_pos - mu, axis=-1)
                     < POCKET_PRIOR_CONTACT_THRESHOLD)
    sca = []
    pos = ligand_pos[atom_mask == -1]
    if pos.shape[0]:
        mu, iso, amu, aniso = _iso_aniso(pos)
        sca.append((pos.shape[0], mu, iso, amu, aniso))
        masks.append(np.linalg.norm(protein_pos - mu, axis=-1)
                     < POCKET_PRIOR_CONTACT_THRESHOLD)
    return arms, sca, np.stack(masks)


def _types(ligand_pos, protein_pos, n):
    """C, with chain ends O and interior atoms nearer the pocket than the
    median N (synthetic.py geometry_correlated_types)."""
    d = np.linalg.norm(ligand_pos[:, None] - protein_pos[None],
                       axis=-1).min(1)
    types = np.full(n, 6, np.int64)
    interior = np.arange(1, n - 1)
    near = d[interior] < np.median(d[interior])
    types[interior[near]] = 7
    types[0] = types[n - 1] = 8
    return types


def size_set(lo: int, hi: int, n: int) -> np.ndarray:
    """n sizes spread evenly over [lo, hi]: lo + floor((i + 1/2) (hi - lo +
    1) / n) for i < n."""
    return lo + ((np.arange(n) + 0.5) * (hi - lo + 1) / n).astype(np.int64)


def draw_complex(rng: np.random.Generator, n_lig: int, num_arms: int,
                 n_pocket: int, n_rec: int) -> dict:
    """One complex of these sizes: a chain ligand (1.5 A steps) cut into
    arms and a scaffold, buried in a receptor ball of n_rec atoms, and the
    pocket of the n_pocket receptor atoms nearest the ligand. Returns the
    raw record (pocket as its protein) with 'receptor_pos' [Nf, 3] beside
    it."""
    steps = rng.normal(size=(n_lig, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    ligand_pos = np.cumsum(steps * 1.5, axis=0).astype(np.float32)
    ligand_pos -= ligand_pos.mean(0)

    # receptor: uniform in a ball at protein density, with a cavity around
    # the ligand; drawn with room to spare, then cut to n_rec atoms
    radius = (3 * n_rec / (4 * np.pi * PROTEIN_DENSITY)) ** (1 / 3)
    cand = rng.normal(size=(2 * n_rec, 3))
    cand /= np.linalg.norm(cand, axis=-1, keepdims=True)
    cand *= radius * rng.random(2 * n_rec)[:, None] ** (1 / 3)
    cand = cand.astype(np.float32)
    d_lig = np.linalg.norm(cand[:, None] - ligand_pos[None], axis=-1).min(1)
    receptor = cand[d_lig > LIGAND_CLEARANCE][:n_rec]
    pocket_idx = np.argsort(
        np.linalg.norm(receptor[:, None] - ligand_pos[None],
                       axis=-1).min(1), kind='stable')[:n_pocket]
    protein_pos = receptor[np.sort(pocket_idx)]

    cuts = sorted(rng.choice(np.arange(2, n_lig - 2), size=num_arms,
                             replace=False))
    atom_mask = np.full(n_lig, -1, np.int64)
    prev = 0
    for i, c in enumerate(cuts):
        atom_mask[prev:c] = i
        prev = c
    src = np.arange(n_lig - 1)
    bond_index = np.stack([np.concatenate([src, src + 1]),
                           np.concatenate([src + 1, src])])
    bond_type = rng.choice([1, 1, 1, 2], size=n_lig - 1)
    bond_type = np.concatenate([bond_type, bond_type])

    pocket_atom_masks = np.zeros((num_arms, n_pocket), bool)
    for a in range(num_arms):
        d = np.linalg.norm(protein_pos - ligand_pos[atom_mask == a].mean(0),
                           axis=-1)
        pocket_atom_masks[a] = d < np.quantile(d, 0.3)
    arms, sca, prior_masks = golden_prior(ligand_pos, atom_mask, protein_pos,
                                          num_arms)
    return {
        'protein_pos': protein_pos,
        'protein_element': rng.choice([6, 6, 6, 7, 8, 16], size=n_pocket),
        'protein_atom_to_aa_type': rng.integers(0, 20, size=n_pocket),
        'protein_is_backbone': rng.random(n_pocket) < 0.4,
        'ligand_pos': ligand_pos,
        'ligand_element': _types(ligand_pos, protein_pos, n_lig),
        'ligand_bond_index': bond_index,
        'ligand_bond_type': bond_type,
        'ligand_atom_is_aromatic': np.zeros(n_lig, bool),
        'ligand_atom_mask': atom_mask,
        'pocket_atom_masks': pocket_atom_masks,
        'num_arms': num_arms,
        'num_scaffold': 1,
        'arms_prior': arms,
        'scaffold_prior': sca,
        'pocket_prior_masks': prior_masks,
        'receptor_pos': receptor,
    }


KEYS = ('ligand_atoms', 'arms', 'pocket_atoms', 'receptor_atoms')


def draw_complexes(seed: int, n: int, sizes: dict) -> list:
    """n complexes drawn in turn from one generator seeded `seed`, their
    sizes the seed's order of each range's size set."""
    rng = np.random.default_rng(seed)
    table = np.stack([rng.permutation(size_set(*sizes[k], n)) for k in KEYS],
                     1)
    return [draw_complex(rng, *map(int, row)) for row in table]
