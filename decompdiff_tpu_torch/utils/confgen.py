"""Distance-geometry conformer embedding (RDKit-free, host-side numpy).

Role parity with the conformer half of the reference's chemistry utilities:
`EmbedMolecule`/`EmbedMultipleConfs` + force-field ranking (ref
utils/chem.py:32-60) and the conformer generation inside `get_rdkit_rmsd`
(ref utils/evaluation/scoring_func.py:49-69). Classic DG recipe:

1. distance-bounds matrix from the bond graph — bond lengths from the ffmin
   covalent-radius x order-scale table, 1-3 distances by the law of cosines
   on the ffmin equilibrium angles, upper bounds triangle-smoothed
   (Floyd-Warshall), non-bonded lower bounds at the vdW clash onset;
2. random metric-matrix embedding — sample a distance matrix inside the
   bounds, double-center to a Gram matrix, take the top-3 eigenpairs;
3. relax with the first-party force field (guidance/ffmin.py), rank
   conformers by its energy (the reference ranks by MMFF energy).

Divergences from the RDKit path are documented in PARITY.md (UFF/MMFF ->
ffmin, symmetry-aware GetBestRMS -> Kabsch RMSD with identity mapping).

Port of decompdiff_tpu/utils/confgen.py,
the same numpy in the same order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from decompdiff_tpu_torch.guidance.ffmin import (
    CLASH_SCALE, VDW_RADII, build_ff_terms, relax_positions)

_BOND_SLACK = 0.02   # +/-2% window on bonded / 1-3 distances
_EIG_FLOOR = 1e-9


def distance_bounds(element: np.ndarray,
                    bonds: Dict[Tuple[int, int], int]):
    """Lower/upper [n, n] distance-bounds matrices for the bond graph."""
    element = np.asarray(element)
    n = len(element)
    terms = build_ff_terms(np.zeros((n, 3)), element, bonds)
    upper = np.full((n, n), np.inf)
    lower = np.zeros((n, n))
    np.fill_diagonal(upper, 0.0)

    d0 = {}
    for (a, b), d in zip(terms['bond_idx'], terms['bond_d0']):
        a, b = int(a), int(b)
        d0[(min(a, b), max(a, b))] = float(d)
        lower[a, b] = lower[b, a] = d * (1 - _BOND_SLACK)
        upper[a, b] = upper[b, a] = d * (1 + _BOND_SLACK)

    for (i, j, k), cos0 in zip(terms['angle_idx'], terms['angle_cos0']):
        i, j, k = int(i), int(j), int(k)
        dij = d0[(min(i, j), max(i, j))]
        djk = d0[(min(j, k), max(j, k))]
        dik = np.sqrt(max(dij ** 2 + djk ** 2 - 2 * dij * djk * cos0, 1e-12))
        if upper[i, k] != np.inf:
            # already constrained: a direct bond (3-ring) or an earlier
            # angle path — keep the existing, tighter window
            continue
        lower[i, k] = lower[k, i] = dik * (1 - _BOND_SLACK)
        upper[i, k] = upper[k, i] = dik * (1 + _BOND_SLACK)

    # triangle-inequality smoothing of the upper bounds (Floyd-Warshall);
    # n is a ligand-sized atom count, the O(n^3) numpy sweep is trivial
    for k in range(n):
        upper = np.minimum(upper, upper[:, k:k + 1] + upper[k:k + 1, :])

    # non-bonded lower bounds: vdW clash onset (same table the ffmin
    # repulsion term uses)
    vdw = np.array([VDW_RADII.get(int(z), 1.7) for z in element])
    clash = CLASH_SCALE * (vdw[:, None] + vdw[None, :])

    # disconnected bond graphs leave inf between components (no bond path
    # for the smoothing to tighten) — cap at molecule-diameter scale so the
    # uniform sampling below stays finite (RDKit embeds multi-fragment mols
    # fine; generated molecules are routinely multi-fragment)
    inf_mask = np.isinf(upper)
    if inf_mask.any():
        finite = upper[~inf_mask]
        cap = max(float(finite.max()) if finite.size else 0.0,
                  float(clash.max())) + 4.0
        upper[inf_mask] = cap
    unset = lower == 0.0
    np.fill_diagonal(unset, False)
    lower[unset] = clash[unset]
    lower = np.minimum(lower, upper)  # never invert the window
    return lower, upper


def _metric_embed(lower: np.ndarray, upper: np.ndarray,
                  rng: np.random.Generator) -> np.ndarray:
    """Sample a distance matrix inside the bounds and embed it in 3D via
    the Gram (metric) matrix's top eigenpairs."""
    n = len(lower)
    d = rng.uniform(lower, upper)
    d = np.triu(d, 1)
    d = d + d.T
    sq = d ** 2
    j = np.eye(n) - np.full((n, n), 1.0 / n)
    gram = -0.5 * j @ sq @ j
    w, v = np.linalg.eigh(gram)
    top = np.argsort(w)[::-1][:3]
    return v[:, top] * np.sqrt(np.maximum(w[top], _EIG_FLOOR))


def embed_conformer(element: np.ndarray,
                    bonds: Dict[Tuple[int, int], int],
                    rng: np.random.Generator,
                    max_iter: int = 300) -> Tuple[np.ndarray, float]:
    """One DG conformer, force-field relaxed; returns (pos [n, 3], energy)."""
    element = np.asarray(element)
    lower, upper = distance_bounds(element, bonds)
    raw = _metric_embed(lower, upper, rng)
    return relax_positions(raw, element, bonds, max_iter=max_iter,
                           return_energy=True)


def generate_conformers(element: np.ndarray,
                        bonds: Dict[Tuple[int, int], int],
                        n_confs: int = 20,
                        seed: int = 1,
                        max_iter: int = 300) -> List[Tuple[np.ndarray, float]]:
    """n_confs independent DG embeddings, sorted by ffmin energy (the
    reference sorts its conformers by MMFF energy, ref utils/chem.py:55-60).
    Raises ValueError on an empty bond graph (nothing to embed against).
    The bounds matrix and force-field terms are graph-only — computed once
    and shared across all conformers."""
    if not bonds:
        raise ValueError('conformer embedding needs a bond graph')
    element = np.asarray(element)
    lower, upper = distance_bounds(element, bonds)
    terms = build_ff_terms(np.zeros((len(element), 3)), element, bonds)
    out = []
    for i in range(n_confs):
        rng = np.random.default_rng(seed + i)
        raw = _metric_embed(lower, upper, rng)
        out.append(relax_positions(raw, element, bonds, max_iter=max_iter,
                                   terms=terms, return_energy=True))
    out.sort(key=lambda t: t[1])
    return out


def record_bonds(record) -> Dict[Tuple[int, int], int]:
    """Undirected {(a, b): order} view of a MolRecord's directed bonds."""
    from decompdiff_tpu_torch.reconstruct.builder import _undirected_bonds
    return _undirected_bonds(record.bond_index, record.bond_type)
