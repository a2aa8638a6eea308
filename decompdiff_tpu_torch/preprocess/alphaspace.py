"""First-party alpha-sphere pocket detection (AlphaSpace2 replacement;
port of decompdiff_tpu/preprocess/alphaspace.py).

The reference pipeline delegates pocket detection to the external
`alphaspace2` package (ref scripts/data_preparation/preprocess_subcomplex.py
:86-107): Delaunay-tessellate the receptor, keep the tetrahedra whose
circumsphere radius falls inside a window ("alpha spheres"), cluster the
circumcenters into pockets, mark the pockets that contact the binder, and
rank them by nonpolar space. `alphaspace2` (and its mdtraj front end) is
absent from this image, so this module re-implements the geometric core on
scipy/numpy with the same knobs and the same downstream contract: pockets
expose `.alphas` / `.nonpolar_space` / `.isContact` / `.occupancy_nonpolar`
exactly as consumed by the reference driver (preprocess_subcomplex.py
:95-143) and by eval_arms (ref utils/evaluation/eval_arms.py:11-17).

Defaults mirror AlphaSpace2's published parameters: alpha-sphere radius
window [3.2, 5.4] A, pocket linkage cutoff 4.7 A, binder contact cutoff
1.6 A (the same 1.6 the reference passes to mark_in_range for occupancy,
utils/preprocess.py:338-343). Each alpha sphere's "space" is the volume of
its Delaunay tetrahedron, split polar/nonpolar by the polarity of its four
receptor vertex atoms (C and S count as nonpolar).

Documented divergence: AlphaSpace2 clusters with average-linkage
hierarchical clustering; for receptors that produce more than
`_LINKAGE_MAX` alpha spheres the O(M^2) linkage matrix is replaced by
single-linkage connected components over a KD-tree radius graph (same
cutoff). Pocket MEMBERSHIP can differ slightly near cluster boundaries in
that regime; both paths are deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
from scipy.spatial import Delaunay, cKDTree

# C, S: sulfur counts as hydrophobic for alpha-space weighting (AlphaSpace2
# convention) even though eval_arms.POLAR_ELEMENTS counts it polar for the
# lining polar-ratio metric (reference convention) — the sets deliberately
# overlap on S.
NONPOLAR_ELEMENTS = (6, 16)
_LINKAGE_MAX = 6000  # above this, switch to the KD-tree single-linkage path


class AlphaAtom(NamedTuple):
    """One alpha sphere; attribute names match the alphaspace2 objects the
    reference consumes (preprocess_subcomplex.py:139-141)."""
    centroid: np.ndarray       # [3]
    radius: float
    space: float               # tetrahedron volume, A^3
    nonpolar_space: float
    lining_atom_idx: np.ndarray  # [4] receptor atom indices


@dataclass
class AlphaPocket:
    """A cluster of alpha spheres; mirrors the alphaspace2 pocket surface
    used by the reference (`isContact`, `nonpolar_space`,
    `occupancy_nonpolar`, `.alphas`; preprocess_subcomplex.py:95-143)."""
    alpha_centers: np.ndarray          # [M, 3]
    alpha_radii: np.ndarray            # [M]
    alpha_space: np.ndarray            # [M]
    alpha_nonpolar_space: np.ndarray   # [M]
    alpha_lining: np.ndarray           # [M, 4] receptor atom indices
    contact_mask: Optional[np.ndarray] = None  # [M] bool, vs binder
    _alphas: Optional[List[AlphaAtom]] = field(default=None, repr=False)

    @property
    def space(self) -> float:
        return float(self.alpha_space.sum())

    @property
    def nonpolar_space(self) -> float:
        return float(self.alpha_nonpolar_space.sum())

    @property
    def centroid(self) -> np.ndarray:
        return self.alpha_centers.mean(0)

    @property
    def lining_atom_idx(self) -> np.ndarray:
        return np.unique(self.alpha_lining)

    @property
    def isContact(self) -> bool:
        return bool(self.contact_mask is not None and self.contact_mask.any())

    @property
    def occupancy_nonpolar(self) -> float:
        """Fraction of nonpolar space whose alphas touch the binder
        (ref preprocess_subcomplex.py:99-107)."""
        if self.contact_mask is None:
            return 0.0
        occupied = float((self.alpha_nonpolar_space * self.contact_mask).sum())
        return occupied / max(self.nonpolar_space, 1e-9)

    @property
    def alphas(self) -> List[AlphaAtom]:
        if self._alphas is None:
            self._alphas = [
                AlphaAtom(self.alpha_centers[i], float(self.alpha_radii[i]),
                          float(self.alpha_space[i]),
                          float(self.alpha_nonpolar_space[i]),
                          self.alpha_lining[i])
                for i in range(len(self.alpha_centers))]
        return self._alphas


def circumspheres(points: np.ndarray, simplices: np.ndarray):
    """Circumcenters and circumradii of Delaunay tetrahedra, vectorized.

    Solves 2(v_k - v_0) . c = |v_k|^2 - |v_0|^2 per simplex. Degenerate
    (near-flat) tetrahedra are reported with radius = +inf so the radius
    window drops them.
    """
    v = points[simplices]                          # [M, 4, 3]
    a = 2.0 * (v[:, 1:] - v[:, :1])                # [M, 3, 3]
    sq = (v ** 2).sum(-1)                          # [M, 4]
    b = sq[:, 1:] - sq[:, :1]                      # [M, 3]
    det = np.linalg.det(a)
    ok = np.abs(det) > 1e-9
    centers = np.zeros((len(simplices), 3))
    if ok.any():
        centers[ok] = np.linalg.solve(a[ok], b[ok][..., None])[..., 0]
    radii = np.where(ok, np.linalg.norm(centers - v[:, 0], axis=-1), np.inf)
    return centers, radii


def tetra_volumes(points: np.ndarray, simplices: np.ndarray) -> np.ndarray:
    v = points[simplices]
    e = v[:, 1:] - v[:, :1]                        # [M, 3, 3]
    return np.abs(np.linalg.det(e)) / 6.0


def _cluster_alpha_centers(centers: np.ndarray, clust_dist: float):
    """Cluster labels for alpha centers. Average-linkage hierarchy for
    small M (matching alphaspace2); KD-tree single-linkage components for
    large M (see module docstring divergence note)."""
    m = len(centers)
    if m == 1:
        return np.zeros(1, np.int64)
    if m <= _LINKAGE_MAX:
        from scipy.cluster.hierarchy import fcluster, linkage
        z = linkage(centers, method='average')
        return fcluster(z, t=clust_dist, criterion='distance') - 1
    # union-find over the radius graph
    parent = np.arange(m)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    tree = cKDTree(centers)
    for i, j in tree.query_pairs(clust_dist):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
    return np.array([find(i) for i in range(m)])


def find_alpha_spheres(receptor_pos: np.ndarray,
                       min_r: float = 3.2, max_r: float = 5.4):
    """All alpha spheres of a receptor point cloud: Delaunay tetrahedra with
    circumradius in [min_r, max_r]. Returns (centers, radii, space,
    lining [M,4])."""
    pos = np.asarray(receptor_pos, np.float64).reshape(-1, 3)
    if len(pos) < 5:
        raise ValueError(f'need >= 5 receptor atoms, got {len(pos)}')
    tri = Delaunay(pos)
    centers, radii = circumspheres(pos, tri.simplices)
    keep = (radii >= min_r) & (radii <= max_r)
    space = tetra_volumes(pos, tri.simplices[keep])
    return centers[keep], radii[keep], space, tri.simplices[keep]


def find_pockets(receptor_pos: np.ndarray,
                 receptor_element: Optional[np.ndarray] = None,
                 binder_pos: Optional[np.ndarray] = None,
                 min_r: float = 3.2, max_r: float = 5.4,
                 clust_dist: float = 4.7, contact_cutoff: float = 1.6,
                 contact_only: Optional[bool] = None) -> List[AlphaPocket]:
    """Alpha-sphere pockets of a receptor, sorted by nonpolar space
    descending (the reference's ranking, preprocess_subcomplex.py:95).

    Args:
        receptor_pos: [N, 3] receptor (heavy-)atom coordinates.
        receptor_element: [N] atomic numbers; None treats every vertex as
            nonpolar (space == nonpolar_space).
        binder_pos: [L, 3] ligand atoms; enables contact/occupancy fields.
        contact_only: keep only binder-contacting pockets; defaults to
            True when binder_pos is given (ref :95 `if p.isContact`).
    """
    centers, radii, space, lining = find_alpha_spheres(
        receptor_pos, min_r=min_r, max_r=max_r)
    if len(centers) == 0:
        return []
    if receptor_element is not None:
        elem = np.asarray(receptor_element).reshape(-1)
        nonpolar_frac = np.isin(elem[lining], NONPOLAR_ELEMENTS).mean(1)
    else:
        nonpolar_frac = np.ones(len(centers))
    nonpolar_space = space * nonpolar_frac

    labels = _cluster_alpha_centers(centers, clust_dist)
    contact = None
    if binder_pos is not None:
        bp = np.asarray(binder_pos, np.float64).reshape(-1, 3)
        d = np.linalg.norm(centers[:, None] - bp[None], axis=-1)
        contact = (d <= contact_cutoff).any(1)

    pockets = []
    for lab in np.unique(labels):
        sel = labels == lab
        pockets.append(AlphaPocket(
            alpha_centers=centers[sel], alpha_radii=radii[sel],
            alpha_space=space[sel],
            alpha_nonpolar_space=nonpolar_space[sel],
            alpha_lining=lining[sel],
            contact_mask=None if contact is None else contact[sel]))
    if contact_only is None:
        contact_only = binder_pos is not None
    if contact_only:
        pockets = [p for p in pockets if p.isContact]
    pockets.sort(key=lambda p: p.nonpolar_space, reverse=True)
    return pockets
