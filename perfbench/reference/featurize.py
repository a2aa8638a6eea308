"""Featurization and padding of raw complexes, in plain numpy (a frozen copy
of the paths the cells use of the port's data/transforms.py featurize_sample
and data/collate.py collate: prior mode ref_prior, ligand atoms 'basic',
fully connected bonds, no order feature; ref utils/transforms.py).

`batch_arrays` returns the padded arrays under the names and dtypes of the
port's ComplexBatch fields. The harness builds the sampling batch with it,
and the reference re-derives each training batch with it from the raw
records the loader read.
"""

from __future__ import annotations

import bisect

import numpy as np

PROTEIN_ELEMENTS = (1, 6, 7, 8, 16, 34)
NUM_AA_TYPES = 20
LIGAND_ELEMENTS_BASIC = (1, 6, 7, 8, 9, 15, 16, 17)   # 8 classes
MIN_PRIOR_STD = 0.6
PROTEIN_BUCKETS = (128, 192, 256, 320, 384, 448, 512, 640, 768)
LIGAND_BUCKETS = (16, 24, 32, 40, 48, 64)
GROUP_BUCKETS = (4, 8, 12)


def bucket(n: int, ladder) -> int:
    i = bisect.bisect_left(ladder, n)
    if i == len(ladder):
        raise ValueError(f'size {n} exceeds the largest bucket {ladder[-1]}')
    return ladder[i]


def protein_features(raw: dict) -> np.ndarray:
    """[Np, 29]: element and residue one-hots, backbone flag, and the
    pocket-contact one-hot of the decomposition indicator."""
    el = (np.asarray(raw['protein_element'])[:, None]
          == np.asarray(PROTEIN_ELEMENTS)[None]).astype(np.float32)
    aa = np.eye(NUM_AA_TYPES, dtype=np.float32)[
        np.asarray(raw['protein_atom_to_aa_type'])]
    bb = np.asarray(raw['protein_is_backbone'], np.float32)[:, None]
    masks = np.asarray(raw['pocket_atom_masks'])
    contact = (masks.sum(0) > 0).astype(np.int64)
    return np.concatenate([el, aa, bb, np.eye(2, dtype=np.float32)[contact]],
                          -1)


def ligand_decomposition(atom_mask, num_arms: int):
    """(aux [Nl, 2], group index [Nl]): the arm/scaffold one-hot and the
    group of each atom, the scaffold's being num_arms."""
    atom_mask = np.asarray(atom_mask)
    idx = np.where(atom_mask == -1, num_arms, atom_mask).astype(np.int64)
    aux = np.eye(2, dtype=np.float32)[(atom_mask >= 0).astype(np.int64)]
    return aux, idx


def prior_tables(raw: dict):
    """(centers [A, 3], stds [A, 3], atom counts [A]) of the ref_prior mode:
    arms, then the scaffold (or the pocket centroid when there is none)."""
    centers, stds = [], []
    for num, mu, cov, _a, _b in raw['arms_prior']:
        centers.append(np.asarray(mu, np.float32).reshape(3))
        s = float(np.sqrt(np.asarray(cov).flat[0])) if num > 1 else 0.0
        stds.append(np.full(3, max(s, MIN_PRIOR_STD), np.float32))
    if len(raw['scaffold_prior']):
        num, mu, cov, _a, _b = raw['scaffold_prior'][0]
        centers.append(np.asarray(mu, np.float32).reshape(3))
        s = float(np.sqrt(np.asarray(cov).flat[0])) if num > 1 else 0.0
        stds.append(np.full(3, max(s, MIN_PRIOR_STD), np.float32))
    else:
        centers.append(np.asarray(raw['protein_pos'], np.float32).mean(0))
        stds.append(np.full(3, MIN_PRIOR_STD, np.float32))
    mask = np.asarray(raw['ligand_atom_mask'])
    counts = np.array([(mask == i).sum() for i in range(int(raw['num_arms']))]
                      + [(mask == -1).sum()], np.int64)
    return np.stack(centers), np.stack(stds), counts


def featurize(raw: dict) -> dict:
    """One raw complex -> the flat record of the port's featurize_sample."""
    n = len(raw['ligand_element'])
    v = np.array([LIGAND_ELEMENTS_BASIC.index(int(z))
                  for z in raw['ligand_element']], np.int64)
    aux, idx = ligand_decomposition(raw['ligand_atom_mask'],
                                    int(raw['num_arms']))
    bonds = np.zeros((n, n), np.int64)
    bi = np.asarray(raw['ligand_bond_index'])
    if bi.size:
        bonds[bi[1], bi[0]] = np.asarray(raw['ligand_bond_type'])
    centers, stds, counts = prior_tables(raw)
    return {'protein_pos': np.asarray(raw['protein_pos'], np.float32),
            'protein_feat': protein_features(raw),
            'ligand_pos': np.asarray(raw['ligand_pos'], np.float32),
            'ligand_v': v, 'ligand_aux': aux, 'ligand_decomp_idx': idx,
            'bond_type': bonds, 'prior_centers': centers,
            'prior_stds': stds, 'prior_num_atoms': counts,
            'num_arms': int(raw['num_arms'])}


def bucket_key(rec: dict) -> tuple:
    return (bucket(len(rec['protein_pos']), PROTEIN_BUCKETS),
            bucket(len(rec['ligand_pos']), LIGAND_BUCKETS),
            bucket(len(rec['prior_centers']), GROUP_BUCKETS))


def _pad(arrays, n, fill=0, dtype=None):
    first = np.asarray(arrays[0])
    out = np.full((len(arrays), n) + first.shape[1:], fill,
                  dtype or first.dtype)
    for b, a in enumerate(arrays):
        out[b, :len(a)] = a
    return out


def _lengths(counts, n):
    return np.arange(n)[None, :] < np.asarray(counts)[:, None]


def batch_arrays(records: list, shape=None) -> dict:
    """Pad featurized records to one batch (Np, Nl, A rounded up to the
    port's bucket ladders unless `shape` gives them). Field names and dtypes
    are those of the port's ComplexBatch."""
    Np, Nl, A = shape or tuple(max(x) for x in zip(*map(bucket_key,
                                                         records)))
    lig_n = [len(r['ligand_pos']) for r in records]
    ligand_mask = _lengths(lig_n, Nl)
    bond_mask = (ligand_mask[:, :, None] & ligand_mask[:, None, :]
                 & ~np.eye(Nl, dtype=bool)[None])
    bond_type = np.zeros((len(records), Nl, Nl), np.int32)
    for b, r in enumerate(records):
        n = lig_n[b]
        bond_type[b, :n, :n] = r['bond_type']
    prior_mask = _lengths([len(r['prior_centers']) for r in records], A)
    f32 = np.float32
    return {
        'protein_pos': _pad([r['protein_pos'] for r in records], Np, 0, f32),
        'protein_feat': _pad([r['protein_feat'] for r in records], Np, 0,
                             f32),
        'protein_mask': _lengths([len(r['protein_pos']) for r in records],
                                 Np),
        'ligand_pos': _pad([r['ligand_pos'] for r in records], Nl, 0, f32),
        'ligand_v': _pad([r['ligand_v'] for r in records], Nl, 0, np.int32),
        'ligand_aux': _pad([r['ligand_aux'] for r in records], Nl, 0, f32),
        'ligand_mask': ligand_mask,
        'ligand_decomp_idx': _pad([r['ligand_decomp_idx'] for r in records],
                                  Nl, 0, np.int32),
        'bond_type': np.where(bond_mask, bond_type, 0).astype(np.int32),
        'bond_mask': bond_mask,
        'prior_centers': _pad([r['prior_centers'] for r in records], A, 0,
                              f32),
        # padded groups keep std 1, so padded atoms stay harmless
        'prior_stds': _pad([r['prior_stds'] for r in records], A, 1.0, f32),
        'prior_num_atoms': _pad([r['prior_num_atoms'] for r in records], A,
                                0, np.int32),
        'prior_mask': prior_mask,
        'num_arms': np.array([r['num_arms'] for r in records], np.int32),
    }
