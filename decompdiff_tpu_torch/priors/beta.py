"""Beta-prior substitution (numpy; port of decompdiff_tpu/priors/beta.py).

Parity with ref utils/prior.py:48-89: replace a sample's golden priors with
AlphaSpace2-derived beta priors loaded from pickles and rebuild 10 Å pocket
masks. Samples here are plain dicts (the host-side record format).
"""

from __future__ import annotations

import pickle

import numpy as np


def _as_cov33(cov) -> np.ndarray:
    cov = np.asarray(cov, np.float32)
    if cov.ndim == 0:
        return float(cov) * np.eye(3, dtype=np.float32)
    return cov.reshape(3, 3) if cov.size == 9 else float(cov.flat[0]) * np.eye(3)


def substitute_with_given_prior(sample: dict, prior_dict: dict,
                                protein_ligand_dist_th: float = 10.0) -> dict:
    """ref utils/prior.py:71-89. Mutates and returns the sample dict."""
    arms = prior_dict['arms_prior']
    scaffold = prior_dict['scaffold_prior']
    assert len(scaffold) <= 1
    sample['num_arms'] = len(arms)
    sample['num_scaffold'] = len(scaffold)

    new_arms, masks = [], []
    protein_pos = np.asarray(sample['protein_pos'], np.float32)
    for (num, mu_i, cov_i, _mu_a, _cov_a) in arms:
        mu = np.asarray(mu_i, np.float32).reshape(3)
        new_arms.append((int(num), mu, _as_cov33(cov_i), None, None))
        dist = np.linalg.norm(protein_pos - mu, axis=-1)
        masks.append(dist < protein_ligand_dist_th)
    sample['arms_prior'] = new_arms
    sample['scaffold_prior'] = [
        (int(num), np.asarray(mu_i, np.float32).reshape(3), _as_cov33(cov_i),
         None, None)
        for (num, mu_i, cov_i, _mu_a, _cov_a) in scaffold]
    sample['pocket_atom_masks'] = np.stack(masks) if masks else \
        np.zeros((0, len(protein_pos)), bool)
    return sample


def substitute_with_beta_prior(sample: dict, beta_prior_path: str,
                               protein_ligand_dist_th: float = 10.0) -> dict:
    """ref utils/prior.py:48-68."""
    with open(beta_prior_path, 'rb') as f:
        beta_prior = pickle.load(f)
    assert len(beta_prior['arms_prior']) == beta_prior['num_arms']
    assert len(beta_prior['scaffold_prior']) == beta_prior['num_scaffold']
    return substitute_with_given_prior(sample, beta_prior,
                                       protein_ligand_dist_th)


def apply_std_coef(sample: dict, std_coef: float) -> dict:
    """Scale all prior covariances by std_coef^2 (ref utils/prior.py:92-105)."""
    for key in ('arms_prior', 'scaffold_prior'):
        sample[key] = [
            (num, mu, cov * std_coef ** 2, a_mu, a_cov)
            for (num, mu, cov, a_mu, a_cov) in sample[key]]
    return sample


def apply_num_atoms_change(sample: dict, delta: int) -> dict:
    """Shift per-part atom counts, floored at 1 (ref utils/prior.py:108-123)."""
    for key in ('arms_prior', 'scaffold_prior'):
        sample[key] = [
            (max(num + delta, 1), mu, cov, a_mu, a_cov)
            for (num, mu, cov, a_mu, a_cov) in sample[key]]
    return sample
