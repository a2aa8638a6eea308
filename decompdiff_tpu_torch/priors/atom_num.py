"""Pocket-size -> ligand-atom-count samplers (port of
decompdiff_tpu/priors/atom_num.py).

Parity with ref utils/evaluation/atom_num.py:13-33 (space size = median of the
10 largest pairwise pocket distances; counts drawn from binned empirical
distributions) and ref utils/prior.py:162-208 (NumAtomsSampler: sklearn
regressors predicting arm/scaffold counts + stds from protein-atom-count
radial features). The empirical tables live in evaluation/assets/*.json
(data extracted from the reference; see _provenance fields).
"""

from __future__ import annotations

import functools
import json
import os
import pickle
from typing import Optional

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          'evaluation', 'assets')


def load_num_config(name_or_path: str) -> dict:
    """Load a {'bounds': [...], 'bins': [(nums, probs), ...]} table from a
    JSON asset name ('atom_num_config', 'arm_num_config',
    'scaffold_num_config') or an explicit .json/.pkl path."""
    if os.path.sep not in name_or_path and not name_or_path.endswith(
            ('.json', '.pkl')):
        name_or_path = os.path.join(_ASSET_DIR, name_or_path + '.json')
    if name_or_path.endswith('.pkl'):
        with open(name_or_path, 'rb') as f:
            return pickle.load(f)
    with open(name_or_path) as f:
        return json.load(f)


@functools.lru_cache(maxsize=1)
def default_config() -> dict:
    """The global atom-count table (read once, on first use)."""
    return load_num_config('atom_num_config')


def get_space_size(pocket_pos: np.ndarray) -> float:
    """Median of the 10 largest pairwise distances (ref atom_num.py:13-16)."""
    pos = np.asarray(pocket_pos, np.float64)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    iu = np.triu_indices(len(pos), k=1)
    vals = np.sort(d[iu])[::-1]
    return float(np.median(vals[:10]))


def _bin_idx(space_size: float, bounds) -> int:
    for i, b in enumerate(bounds):
        if b > space_size:
            return i
    return len(bounds)


def sample_atom_num(space_size: float, config: Optional[dict] = None,
                    rng: Optional[np.random.Generator] = None) -> int:
    """ref atom_num.py:27-33. NOTE the reference quirk: `_get_bin_idx`
    always bins with the GLOBAL atom-config bounds (ref atom_num.py:19-25
    reads CONFIG['bounds']), even when `config` overrides the bins — the
    arm/scaffold tables are indexed by the global pocket-size bin, not by
    their own bounds."""
    config = config or default_config()
    rng = rng or np.random.default_rng()
    nums, probs = config['bins'][
        _bin_idx(space_size, default_config()['bounds'])]
    probs = np.asarray(probs, np.float64)
    probs = probs / probs.sum()
    return int(rng.choice(nums, p=probs))


class NumAtomsSampler:
    """sklearn-regressor-based sampler ('stat' mode;
    ref utils/prior.py:162-208). Requires the natom_models.pkl shipped with
    the reference release."""

    def __init__(self, pred_models: dict):
        self.arm_model = pred_models['arm_model']
        self.armstd_model = pred_models['armstd_model']
        self.sca_model = pred_models['sca_model']
        self.scastd_model = pred_models['scastd_model']

    @classmethod
    def from_pickle(cls, path: str) -> 'NumAtomsSampler':
        with open(path, 'rb') as f:
            return cls(pickle.load(f))

    @staticmethod
    def _radial_features(centers: np.ndarray, protein_pos: np.ndarray):
        d = np.linalg.norm(centers[:, None] - protein_pos[None], axis=-1)
        return np.stack([(d < r).sum(1) for r in np.linspace(1, 10, 50)], 1)

    def sample_arm_natoms(self, arm_centers, protein_pos,
                          rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        x = self._radial_features(np.asarray(arm_centers, np.float64),
                                  np.asarray(protein_pos, np.float64))
        y = self.arm_model.predict(x)
        natoms = self._sample_from_prediction(y, std=0.2, rng=rng)
        stds = self.armstd_model.predict(natoms[:, None]).astype(np.float32)
        return natoms.tolist(), np.repeat(stds.reshape(-1, 1), 3, axis=1)

    def sample_sca_natoms(self, sca_center, arm_centers, arm_stds,
                          protein_pos,
                          rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        sca_center = np.asarray(sca_center, np.float64).reshape(1, 3)
        x_p = self._radial_features(sca_center,
                                    np.asarray(protein_pos, np.float64))
        d = np.linalg.norm(
            sca_center[:, None] - np.asarray(arm_centers).reshape(1, -1, 3),
            axis=-1)
        res = d - np.asarray(arm_stds)[:, 0][None, :]
        x = np.concatenate([x_p, res.sum(1, keepdims=True)], axis=-1)
        y = self.sca_model.predict(x)
        natoms = self._sample_from_prediction(y, std=0.0, rng=rng)
        stds = self.scastd_model.predict(natoms[:, None]).astype(np.float32)
        return int(natoms[0]), np.repeat(stds.reshape(1, 1), 3, axis=1)[0]

    @staticmethod
    def _sample_from_prediction(n, std, min_natoms=2, rng=None):
        rng = rng or np.random.default_rng()
        natoms = np.ceil(n + std * n * rng.standard_normal(len(n))).astype(int)
        return np.maximum(natoms, min_natoms)
