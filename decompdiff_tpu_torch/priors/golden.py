"""Golden (reference-ligand) decomposed prior (port of
decompdiff_tpu/priors/golden.py).

Parity with ref utils/prior.py:12-45,126-159: per arm/scaffold isotropic and
anisotropic mu/cov from the ground-truth fragment positions, plus 6 Å
pocket-contact masks. Pure numpy; priors are tuples
(atom_num, iso_mu [3], iso_cov [3,3], aniso_mu [3], aniso_cov [3,3]).
"""

from __future__ import annotations

import numpy as np

POCKET_PRIOR_CONTACT_THRESHOLD = 6.0  # ref utils/prior.py:129


def isotropic_covariance(pos: np.ndarray) -> np.ndarray:
    """sigma^2 * I with sigma^2 = mean squared deviation over all 3N coords
    (ref utils/prior.py:12-21)."""
    mu = pos.mean(0, keepdims=True)
    centered = (pos - mu).reshape(-1, 1)
    return (centered.T @ centered / centered.shape[0]) * np.eye(3)


def anisotropic_covariance(pos: np.ndarray) -> np.ndarray:
    """Full 3x3 covariance (ref utils/prior.py:24-32)."""
    mu = pos.mean(0, keepdims=True)
    centered = pos - mu
    return centered.T @ centered / pos.shape[0]


def get_iso_aniso_mu_cov(pos: np.ndarray):
    """ref utils/prior.py:35-45."""
    if pos.shape[0] == 0:
        z = np.zeros_like(pos)
        return z, np.eye(0), z, np.eye(0)
    iso_mu = aniso_mu = pos.mean(0)
    return iso_mu, isotropic_covariance(pos), aniso_mu, \
        anisotropic_covariance(pos)


def compute_golden_prior(ligand_pos: np.ndarray, ligand_atom_mask: np.ndarray,
                         protein_pos: np.ndarray, num_arms: int):
    """Returns (arms_prior, scaffold_prior, pocket_prior_masks)
    (ref utils/prior.py:126-159). ligand_atom_mask: per-atom arm id,
    scaffold = -1."""
    pocket_prior_masks = []
    arms_prior = []
    for arm_id in range(num_arms):
        pos = ligand_pos[ligand_atom_mask == arm_id]
        iso_mu, iso_cov, aniso_mu, aniso_cov = get_iso_aniso_mu_cov(pos)
        arms_prior.append((pos.shape[0], iso_mu, iso_cov, aniso_mu, aniso_cov))
        cdist = np.linalg.norm(protein_pos - iso_mu, axis=-1)
        pocket_prior_masks.append(cdist < POCKET_PRIOR_CONTACT_THRESHOLD)

    scaffold_prior = []
    sca_pos = ligand_pos[ligand_atom_mask == -1]
    if sca_pos.shape[0] > 0:
        iso_mu, iso_cov, aniso_mu, aniso_cov = get_iso_aniso_mu_cov(sca_pos)
        scaffold_prior.append(
            (sca_pos.shape[0], iso_mu, iso_cov, aniso_mu, aniso_cov))
        cdist = np.linalg.norm(protein_pos - iso_mu, axis=-1)
        pocket_prior_masks.append(cdist < POCKET_PRIOR_CONTACT_THRESHOLD)

    return arms_prior, scaffold_prior, np.stack(pocket_prior_masks)
