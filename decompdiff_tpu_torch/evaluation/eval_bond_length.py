"""Bond-length / pair-distance JSD metrics vs CrossDocked ground truth.

Behavioral parity with ref utils/evaluation/eval_bond_length.py:22-140.
The ground-truth empirical histograms live in
assets/crossdocked_distributions.json (data tables extracted from the
reference; see the file's _provenance field).

Port of decompdiff_tpu/evaluation/eval_bond_length.py,
the same numpy in the same order.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import distance as sci_distance

from decompdiff_tpu_torch.data.mol import MolRecord

BondKey = Tuple[int, int, int]  # (z1, z2, bond_class), z1 <= z2

_ASSET = os.path.join(os.path.dirname(__file__), 'assets',
                      'crossdocked_distributions.json')


def _load_reference():
    with open(_ASSET) as f:
        d = json.load(f)
    bond = {tuple(map(int, k.replace('|', '-').split('-'))): np.asarray(v)
            for k, v in d['bond_distributions'].items()}
    pair_bins = {k: np.asarray(v) for k, v in d['pair_bins'].items()}
    pair = {k: np.asarray(v) for k, v in d['pair_distributions'].items()}
    return np.asarray(d['distance_bins']), bond, pair_bins, pair


DISTANCE_BINS, REF_BOND_DISTRIBUTIONS, PAIR_BINS, REF_PAIR_DISTRIBUTIONS = \
    _load_reference()


def get_distribution(distances: Sequence[float],
                     bins=DISTANCE_BINS) -> np.ndarray:
    """Empirical distribution over searchsorted bins (ref :22-33)."""
    counts = collections.Counter(np.searchsorted(bins, distances))
    arr = np.array([counts.get(i, 0) for i in range(len(bins) + 1)], float)
    return arr / max(arr.sum(), 1)


def bond_distances_from_mol(mol) -> List[Tuple[BondKey, float]]:
    """(z1, z2, bond_class) -> length samples (ref :128-140). Accepts a
    MolRecord or an RDKit mol."""
    out = []
    if isinstance(mol, MolRecord):
        seen = set()
        for e in range(mol.bond_index.shape[1]):
            a, b = int(mol.bond_index[0, e]), int(mol.bond_index[1, e])
            if (min(a, b), max(a, b)) in seen:
                continue
            seen.add((min(a, b), max(a, b)))
            d = float(np.linalg.norm(mol.pos[a] - mol.pos[b]))
            out.append(((int(mol.element[a]), int(mol.element[b]),
                         int(mol.bond_type[e])), d))
    else:  # rdkit mol
        from decompdiff_tpu_torch.constants import (
            BOND_AROMATIC, BOND_DOUBLE, BOND_SINGLE, BOND_TRIPLE)
        from rdkit import Chem
        bt_map = {Chem.BondType.SINGLE: BOND_SINGLE,
                  Chem.BondType.DOUBLE: BOND_DOUBLE,
                  Chem.BondType.TRIPLE: BOND_TRIPLE,
                  Chem.BondType.AROMATIC: BOND_AROMATIC}
        pos = mol.GetConformer().GetPositions()
        for bond in mol.GetBonds():
            a, b = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
            d = float(np.linalg.norm(pos[a] - pos[b]))
            out.append(((bond.GetBeginAtom().GetAtomicNum(),
                         bond.GetEndAtom().GetAtomicNum(),
                         bt_map.get(bond.GetBondType(), 0)), d))
    return out


def pair_distances_from_pos(pos, elements) -> List[Tuple[Tuple[int, int], float]]:
    """All unordered atom-pair distances (ref :117-126)."""
    pos = np.asarray(pos)
    n = len(elements)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    out = []
    for s in range(n):
        for e in range(s + 1, n):
            out.append(((int(elements[s]), int(elements[e])), float(d[s, e])))
    return out


def _format_key(k: BondKey) -> BondKey:
    z1, z2, c = k
    return (z2, z1, c) if z1 > z2 else (z1, z2, c)


def get_bond_length_profile(bond_lengths) -> Dict[BondKey, np.ndarray]:
    """ref :43-49."""
    profile = collections.defaultdict(list)
    for key, d in bond_lengths:
        profile[_format_key(key)].append(d)
    return {k: get_distribution(v) for k, v in profile.items()}


def _key_str(k: BondKey) -> str:
    return f'{k[0]}-{k[1]}|{k[2]}'


def eval_bond_length_profile(profile) -> Dict[str, Optional[float]]:
    """JSD per tracked bond type (ref :57-69)."""
    metrics = {}
    for key, gt in REF_BOND_DISTRIBUTIONS.items():
        if key not in profile:
            metrics[f'JSD_{_key_str(key)}'] = None
        else:
            metrics[f'JSD_{_key_str(key)}'] = float(
                sci_distance.jensenshannon(gt, profile[key]))
    return metrics


def get_pair_length_profile(pair_lengths) -> Dict[str, np.ndarray]:
    """ref :73-81."""
    cc = [d for k, d in pair_lengths if k == (6, 6) and d < 2]
    all_d = [d for _, d in pair_lengths if d < 12]
    return {
        'CC_2A': get_distribution(cc, bins=PAIR_BINS['CC_2A']),
        'All_12A': get_distribution(all_d, bins=PAIR_BINS['All_12A']),
    }


def eval_pair_length_profile(profile) -> Dict[str, Optional[float]]:
    """ref :84-90."""
    metrics = {}
    for k, gt in REF_PAIR_DISTRIBUTIONS.items():
        metrics[f'JSD_{k}'] = (float(sci_distance.jensenshannon(gt, profile[k]))
                               if k in profile else None)
    return metrics


def plot_distance_hist(pair_length_profile, metrics=None, save_path=None):
    """Step-histogram comparison of the generated pair-distance profiles
    against the CrossDocked ground-truth distributions
    (ref eval_bond_length.py:93-113). With save_path the figure is written
    instead of shown (the headless default here)."""
    import matplotlib
    if save_path is not None:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    gt_profile = REF_PAIR_DISTRIBUTIONS
    plt.figure(figsize=(6 * len(gt_profile), 4))
    for idx, (k, gt_distribution) in enumerate(gt_profile.items()):
        plt.subplot(1, len(gt_profile), idx + 1)
        x = PAIR_BINS[k]
        plt.step(x, gt_distribution[1:])
        plt.step(x, pair_length_profile[k][1:])
        plt.legend(['True', 'Learned'])
        if metrics is not None and metrics.get(f'JSD_{k}') is not None:
            plt.title(f'{k} JS div: {metrics["JSD_" + k]:.4f}')
        else:
            plt.title(k)
    if save_path is not None:
        plt.savefig(save_path)
    else:
        plt.show()
    plt.close()
