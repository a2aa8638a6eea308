"""Arm-level metrics: pocket occupancy and polar ratio (port of
decompdiff_tpu/evaluation/eval_arms.py).

Parity with ref utils/evaluation/eval_arms.py:11-29. The occupancy core
(contact masking of alpha centers against ligand atoms) is pure numpy; only
the AlphaSpace pocket objects / mdtraj receptors are external.
"""

from __future__ import annotations

import numpy as np

from decompdiff_tpu_torch.preprocess.subcomplex import mark_in_range

POLAR_ELEMENTS = (7, 8, 16)  # N, O, S


def compute_occupancy_from_alphas(alpha_centers, alpha_nonpolar_space,
                                  pocket_nonpolar_space, ligand_pos,
                                  cutoff: float = 1.6) -> float:
    """Fraction of the pocket's nonpolar alpha space in contact with the
    ligand (ref :11-17), decoupled from AlphaSpace objects."""
    contact = mark_in_range(alpha_centers, ligand_pos, cutoff=cutoff)
    occupied = float(np.sum(np.asarray(alpha_nonpolar_space) * contact))
    return occupied / max(float(pocket_nonpolar_space), 1e-9)


def compute_occupancy(pocket, ligand_pos) -> float:
    """AlphaSpace2 pocket object front end (ref :11-17)."""
    centers = np.stack([a.centroid for a in pocket.alphas])
    spaces = np.array([a.nonpolar_space for a in pocket.alphas])
    return compute_occupancy_from_alphas(centers, spaces,
                                         pocket.nonpolar_space, ligand_pos)


def compute_polar_ratio(receptor_elements, pocket, ligand_elements):
    """Pocket-object front end (ref :20-29): the pocket's lining atoms are
    sliced out of the receptor's atomic numbers (the mdtraj
    `receptor.atom_slice(pocket.lining_atoms_idx)` analog) and compared
    against the ligand's. Works with first-party AlphaPocket objects
    (``lining_atom_idx``) and alphaspace2 pockets (``lining_atoms_idx``)."""
    lining = getattr(pocket, 'lining_atom_idx', None)
    if lining is None:
        lining = pocket.lining_atoms_idx
    receptor = np.asarray(receptor_elements)
    return compute_polar_ratio_from_elements(receptor[np.asarray(lining)],
                                             ligand_elements)


def compute_polar_ratio_from_elements(pocket_elements, ligand_elements):
    """Polar-atom fractions for pocket lining atoms and ligand atoms
    (ref :20-29), on plain atomic-number arrays."""
    pocket = np.asarray(pocket_elements)
    ligand = np.asarray([z for z in np.asarray(ligand_elements) if z != 0])
    pocket_ratio = (float(np.isin(pocket, POLAR_ELEMENTS).mean())
                    if len(pocket) else 0.0)
    ligand_ratio = (float(np.isin(ligand, POLAR_ELEMENTS).mean())
                    if len(ligand) else 0.0)
    return pocket_ratio, ligand_ratio
