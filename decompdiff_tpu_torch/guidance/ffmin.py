"""First-party force-field relaxation for the conformer-drift guidance (port
of decompdiff_tpu/guidance/ffmin.py: the same float64 numpy and scipy
calls, in the same order).

The reference's `mmff_min` drift (ref utils/guidance_funcs.py:121-158)
reconstructs each molecule from the current point cloud, minimizes it with
RDKit MMFF94s, and drifts the prediction toward the minimized geometry
(grad = pred_pos - minimized_pos, zero on any failure). Without RDKit,
this module supplies a self-contained lightweight
force field over geometry-perceived bonds (reconstruct/ligan.py):

  * harmonic bond stretch to covalent-radius equilibria scaled by bond
    order,
  * cosine-harmonic angle bend with the equilibrium chosen from the
    center atom's steric environment,
  * soft quadratic nonbonded repulsion below a vdW-scaled clash distance
    (1-2 and 1-3 pairs excluded),

minimized with scipy L-BFGS-B and analytic gradients. Only the argmin
matters for the drift, so force constants set relative stiffness, not
physical units. `make_ff_callback` matches the SampleConfig.mmff_callback
contract of guidance/mmff.py — it makes the mmff_min drift executable
without RDKit; when RDKit is installed guidance/mmff.py stays the parity
path (sampling/driver.py prefers it, as scripts/sample.py does).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.optimize import minimize

from decompdiff_tpu_torch.constants import (
    COVALENT_RADII, atomic_numbers_from_index, is_aromatic_from_index)
from decompdiff_tpu_torch.reconstruct.builder import _connected_fragments
from decompdiff_tpu_torch.reconstruct.ligan import perceive_molecule

VDW_RADII = {1: 1.20, 6: 1.70, 7: 1.55, 8: 1.52, 9: 1.47, 15: 1.80,
             16: 1.80, 17: 1.75, 35: 1.85, 53: 1.98}
# equilibrium-length scale per bond order (single/double/triple/aromatic)
ORDER_SCALE = {1: 1.00, 2: 0.87, 3: 0.78, 4: 0.93}
K_BOND, K_ANGLE, K_REP = 300.0, 50.0, 50.0
# repulsion onset at 0.80 * (vdw_i + vdw_j): for two carbons that is
# 2.72 A, safely below an aromatic ring's para distance (~2.78 A in
# benzene) so flat rings carry no residual clash strain, while genuine
# steric overlaps (< ~2.7 A heavy-atom pairs) are still pushed apart
CLASH_SCALE = 0.80


def _equilibrium_angle(z: int, n_neighbors: int, max_order: int) -> float:
    """cos(theta0) for an angle centered on atom with atomic number z.
    max_order uses the bond-type codes (1/2/3 orders, 4 = aromatic)."""
    if n_neighbors >= 4:
        theta = 109.47
    elif n_neighbors == 3:
        theta = 120.0
    elif max_order == 3:
        theta = 180.0  # sp center (e.g. nitrile / alkyne carbon)
    elif max_order == 4:
        theta = 120.0  # 2-neighbor aromatic ring atom
    elif max_order == 2:
        theta = 120.0  # 2-neighbor sp2 center (carbonyl/vinyl/imine)
    elif z in (8, 16):
        theta = 104.5  # divalent O/S bend
    else:
        theta = 109.47
    return float(np.cos(np.deg2rad(theta)))


def build_ff_terms(pos: np.ndarray, element: np.ndarray,
                   bonds: Dict[Tuple[int, int], int]):
    """Precompute term index arrays for ff_energy_grad.

    Returns dict with bond (idx [B,2], d0 [B]), angle (idx [A,3] as
    (i, j=center, k), cos0 [A]) and repulsion (idx [P,2], cutoff [P])
    arrays. `pos` is only used for the atom count.
    """
    n = len(pos)
    element = np.asarray(element)
    # normalize to (min, max) keys: the repulsion exclusion below compares
    # against (a < b) pairs, and callers are allowed to pass either order
    bonds = {(min(int(a), int(b)), max(int(a), int(b))): int(o)
             for (a, b), o in bonds.items()}
    adj = {i: [] for i in range(n)}
    b_idx, b_d0 = [], []
    max_order = np.ones(n, np.int64)
    for (a, b), order in bonds.items():
        adj[a].append(b)
        adj[b].append(a)
        ra = COVALENT_RADII.get(int(element[a]), 0.77)
        rb = COVALENT_RADII.get(int(element[b]), 0.77)
        b_idx.append((a, b))
        b_d0.append((ra + rb) * ORDER_SCALE.get(int(order), 1.0))
        max_order[a] = max(max_order[a], int(order))
        max_order[b] = max(max_order[b], int(order))

    a_idx, a_cos0 = [], []
    for j in range(n):
        nbrs = sorted(adj[j])
        for x in range(len(nbrs)):
            for y in range(x + 1, len(nbrs)):
                a_idx.append((nbrs[x], j, nbrs[y]))
                a_cos0.append(_equilibrium_angle(
                    int(element[j]), len(nbrs), int(max_order[j])))

    bonded = set(bonds)
    one_three = set()
    for (i, j, k) in a_idx:
        one_three.add((min(i, k), max(i, k)))
    p_idx, p_cut = [], []
    for a in range(n):
        for b in range(a + 1, n):
            if (a, b) in bonded or (a, b) in one_three:
                continue
            va = VDW_RADII.get(int(element[a]), 1.7)
            vb = VDW_RADII.get(int(element[b]), 1.7)
            p_idx.append((a, b))
            p_cut.append(CLASH_SCALE * (va + vb))

    def arr(x, width):
        return (np.asarray(x, np.int64).reshape(len(x), width) if len(x)
                else np.zeros((0, width), np.int64))

    return {
        'bond_idx': arr(b_idx, 2), 'bond_d0': np.asarray(b_d0, np.float64),
        'angle_idx': arr(a_idx, 3),
        'angle_cos0': np.asarray(a_cos0, np.float64),
        'rep_idx': arr(p_idx, 2), 'rep_cut': np.asarray(p_cut, np.float64),
    }


def ff_energy_grad(x: np.ndarray, terms: dict):
    """Energy and analytic gradient at flat coordinates x [n*3]."""
    pos = x.reshape(-1, 3)
    grad = np.zeros_like(pos)
    energy = 0.0

    bi = terms['bond_idx']
    if len(bi):
        dvec = pos[bi[:, 0]] - pos[bi[:, 1]]
        d = np.linalg.norm(dvec, axis=1)
        d = np.maximum(d, 1e-8)
        dd = d - terms['bond_d0']
        energy += K_BOND * float((dd ** 2).sum())
        g = (2.0 * K_BOND * dd / d)[:, None] * dvec
        np.add.at(grad, bi[:, 0], g)
        np.add.at(grad, bi[:, 1], -g)

    ai = terms['angle_idx']
    if len(ai):
        u = pos[ai[:, 0]] - pos[ai[:, 1]]
        v = pos[ai[:, 2]] - pos[ai[:, 1]]
        cu = np.maximum(np.linalg.norm(u, axis=1), 1e-8)
        cv = np.maximum(np.linalg.norm(v, axis=1), 1e-8)
        cos = (u * v).sum(1) / (cu * cv)
        cos = np.clip(cos, -1.0, 1.0)
        dc = cos - terms['angle_cos0']
        energy += K_ANGLE * float((dc ** 2).sum())
        coef = (2.0 * K_ANGLE * dc)[:, None]
        dcos_di = v / (cu * cv)[:, None] - (cos / cu ** 2)[:, None] * u
        dcos_dk = u / (cu * cv)[:, None] - (cos / cv ** 2)[:, None] * v
        np.add.at(grad, ai[:, 0], coef * dcos_di)
        np.add.at(grad, ai[:, 2], coef * dcos_dk)
        np.add.at(grad, ai[:, 1], -coef * (dcos_di + dcos_dk))

    pi = terms['rep_idx']
    if len(pi):
        dvec = pos[pi[:, 0]] - pos[pi[:, 1]]
        d = np.maximum(np.linalg.norm(dvec, axis=1), 1e-8)
        pen = np.minimum(d - terms['rep_cut'], 0.0)  # negative inside clash
        energy += K_REP * float((pen ** 2).sum())
        g = (2.0 * K_REP * pen / d)[:, None] * dvec
        np.add.at(grad, pi[:, 0], g)
        np.add.at(grad, pi[:, 1], -g)

    return energy, grad.reshape(-1)


def relax_positions(pos: np.ndarray, element: np.ndarray,
                    bonds: Dict[Tuple[int, int], int],
                    max_iter: int = 200, terms: Optional[dict] = None,
                    return_energy: bool = False):
    """Minimize the lightweight force field from `pos`; returns [n, 3]
    (or (pos, energy-at-minimum) with return_energy). Pass precomputed
    `terms` when relaxing many starts of the same bond graph."""
    pos = np.asarray(pos, np.float64).reshape(-1, 3)
    if terms is None:
        terms = build_ff_terms(pos, element, bonds)
    res = minimize(ff_energy_grad, pos.reshape(-1), args=(terms,),
                   jac=True, method='L-BFGS-B',
                   options={'maxiter': max_iter})
    out = res.x.reshape(-1, 3)
    return (out, float(res.fun)) if return_energy else out


def _is_connected(n: int, bonds) -> bool:
    """Single-component check — the RDKit-free analog of the reference's
    `'.' in Chem.MolToSmiles(mol)` rejection (ref guidance_funcs.py:143-146).
    """
    return len(_connected_fragments(n, bonds)) <= 1


def make_ff_callback(atom_enc_mode: str = 'basic', max_iter: int = 200):
    """f(pos [B, Nl, 3], v [B, Nl], mask [B, Nl]) -> drift [B, Nl, 3] for
    SampleConfig.mmff_callback — drop-in for guidance/mmff.py's
    make_mmff_callback, with geometric bond perception + the first-party
    relaxation instead of RDKit reconstruction + MMFF."""

    def callback(pos, v, mask):
        pos = np.asarray(pos, np.float64)
        v = np.asarray(v)
        mask = np.asarray(mask)
        B, Nl, _ = pos.shape
        out = np.zeros((B, Nl, 3), np.float32)
        for b in range(B):
            m = mask[b]
            if m.sum() < 2:
                continue
            p = pos[b][m]
            element = atomic_numbers_from_index(v[b][m], atom_enc_mode)
            # carry the predicted aromatic channel into perception, like
            # the RDKit parity path does (guidance/mmff.py:36-38);
            # None for mode 'basic'
            aromatic = is_aromatic_from_index(v[b][m], atom_enc_mode)
            try:
                bonds, _ = perceive_molecule(p, element,
                                             indicators=aromatic)
            except Exception:
                continue
            if not bonds or not _is_connected(len(p), bonds):
                continue
            relaxed = relax_positions(p, element, bonds, max_iter=max_iter)
            out[b, m] = (p - relaxed).astype(np.float32)
        return out

    return callback
