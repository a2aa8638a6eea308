"""Ring-repulsion drift (host-side; port of decompdiff_tpu/guidance/ring.py,
parity with ref utils/guidance_funcs.py:161-230
compute_ring_repulsion_drift).

Limits fused-ring growth during sampling: perceive a distance-bonded graph
(d < bond_d) from the current point cloud, find fused ring systems, and for
systems with more than `max_allow_rings` rings apply a hinge loss
mean(clamp(bond_d - d, 0)) over the top-(num_rings - max_allow) per-ring
maximum candidate bond distances (candidate = both endpoints in < 4 rings
combined, ref :206).

The reference takes torch.autograd.grad of that loss through the pairwise
distances; the bond graph / ring structure is piecewise-constant in the
positions, so the gradient is analytic: for each selected bond (a, b) with
d < bond_d, d(loss)/d(pos_a) = -(pos_a - pos_b)/d / K (K = number of selected
distances), and the per-graph losses are averaged over the batch (ref :228,
:230). This module computes exactly that — no numerical approximation.
Pure python over the lightweight MolRecord machinery (no RDKit needed);
exposed as a SampleConfig.mmff_callback, like the MMFF drift.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Tuple

import numpy as np

from decompdiff_tpu_torch.data.mol import MolRecord
from decompdiff_tpu_torch.utils.chem import _record_rings, get_ring_systems


def _ring_structures(pos: np.ndarray, bond_d: float):
    """Distance-bond graph + rings + fused systems (ref :178-193)."""
    n = len(pos)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    bond_mask = (d < bond_d) & ~np.eye(n, dtype=bool)
    src, dst = np.nonzero(bond_mask)
    keep = src < dst
    bond_index = np.stack([np.concatenate([src[keep], dst[keep]]),
                           np.concatenate([dst[keep], src[keep]])])
    mol = MolRecord(element=np.full(n, 6), pos=pos.astype(np.float32),
                    bond_index=bond_index,
                    bond_type=np.ones(bond_index.shape[1], np.int64),
                    aromatic=np.zeros(n, bool))
    rings = _record_rings(mol)
    systems = get_ring_systems(mol) if rings else []
    return d, bond_mask, rings, systems


def ring_repulsion_single(pos: np.ndarray, bond_d: float = 1.9,
                          max_allow_rings: int = 2):
    """One graph's (energy, grad [n, 3], valid) — the reference loss
    (ref :172-229) and its exact autograd gradient."""
    pos = np.asarray(pos, np.float64)
    n = len(pos)
    grad = np.zeros((n, 3))
    d, bond_mask, rings, systems = _ring_structures(pos, bond_d)
    if not rings:
        return 0.0, grad, 0

    num_atom_rings = np.zeros(n, np.int64)
    for ring in rings:
        for a in ring:
            num_atom_rings[a] += 1

    # per ring: the max candidate bond distance + its endpoints (ref :197-215)
    ringsys_max = defaultdict(list)   # sys -> [(dist, a, b)]
    ringsys_num = defaultdict(int)
    for ring in rings:
        fr_idx = [si for si, fr in enumerate(systems)
                  if ring[0] in fr and ring[1] in fr]
        if not fr_idx:
            continue
        si = fr_idx[0]
        best = None
        for ai, a in enumerate(ring):
            for b in ring:
                if not bond_mask[a, b]:
                    continue
                if num_atom_rings[a] + num_atom_rings[b] >= 4:  # ref :206
                    continue
                if best is None or d[a, b] > best[0]:
                    best = (float(d[a, b]), a, b)
        if best is not None:
            ringsys_max[si].append(best)
        ringsys_num[si] += 1

    selected = []
    for si, entries in ringsys_max.items():
        num_sys = ringsys_num[si]
        if num_sys > max_allow_rings:
            entries = sorted(entries, reverse=True)[:num_sys - max_allow_rings]
            selected += entries
    if not selected:
        return 0.0, grad, 0

    k = len(selected)
    hinges = [max(bond_d - dist, 0.0) for dist, _a, _b in selected]
    energy = float(np.mean(hinges))
    for (dist, a, b), h in zip(selected, hinges):
        if h <= 0.0 or dist < 1e-9:
            continue
        unit = (pos[a] - pos[b]) / dist
        # d/d pos_a of (bond_d - |pa - pb|)/k
        grad[a] -= unit / k
        grad[b] += unit / k
    return energy, grad, 1


def ring_repulsion_energy_single(pos: np.ndarray, bond_d: float = 1.9,
                                 max_allow_rings: int = 2) -> Tuple[float, int]:
    """Energy only (for tests / monitoring)."""
    e, _g, valid = ring_repulsion_single(pos, bond_d, max_allow_rings)
    return e, valid


def make_ring_repulsion_callback(bond_d: float = 1.9,
                                 max_allow_rings: int = 2):
    """Drift callback f(pos, v, mask) -> grad [B, Nl, 3]: the gradient of the
    batch-mean reference loss (ref :228-230 divides by num_graphs)."""

    def callback(pos, v, mask):
        pos = np.asarray(pos, np.float64)
        mask = np.asarray(mask)
        B = pos.shape[0]
        out = np.zeros(pos.shape, np.float32)
        for b in range(B):
            p = pos[b][mask[b]]
            if len(p) < 3:
                continue
            _e, grad, valid = ring_repulsion_single(p, bond_d, max_allow_rings)
            if valid:
                out[b, mask[b]] = (grad / B).astype(np.float32)
        return out

    return callback
