"""Ligand decomposition: BRICS fragments -> exact atom cover -> arm/scaffold
assignment (L0; port of decompdiff_tpu/preprocess/decompose.py).

Behavioral parity with ref utils/preprocess.py:
  * decompose_molecule (BRICS, dummy->H substitution, substruct matching;
    :18-62) — RDKit-gated
  * find_complete_seg (recursive exact cover of atoms by fragment matches;
    :65-104) -> find_exact_cover here, an explicit-stack search over the same
    candidate structure
  * is_terminal_frag (:115-122) -> bond-array version, no RDKit needed
  * extract_submols (:139-281): linear_sum_assignment of terminal fragments
    to pockets, scaffold = farthest non-arm fragment, nearest-center
    assignment with terminal-validity fallback

The geometric assignment core (assign_fragments) is pure numpy/scipy and
fully testable without RDKit.
"""

from __future__ import annotations

import itertools
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial import distance_matrix


class DecomposeError(Exception):
    """ref utils/misc.py:88-105 error taxonomy."""


# ---------------------------------------------------------------------------
# exact cover
# ---------------------------------------------------------------------------

def find_exact_cover(match_groups: Sequence[Sequence[Sequence[int]]],
                     num_atoms: int) -> Optional[List[List[int]]]:
    """Pick, for each fragment type, a subset of its substructure matches such
    that all chosen matches are disjoint and together cover every atom.

    match_groups[i] is the list of atom-index tuples where fragment type i
    matches. Returns one flat atom-index list per fragment type (the union of
    its chosen matches), or None if no cover exists.
    (Parity role: ref find_complete_seg, utils/preprocess.py:65-104.)
    """

    def search(group_idx: int, used: frozenset, chosen: tuple):
        if group_idx == len(match_groups):
            return list(map(list, chosen)) if len(used) == num_atoms else None
        # candidate matches for this type that don't overlap used atoms
        matches = [m for m in match_groups[group_idx]
                   if not any(a in used for a in m)]
        # larger subsets first, and L >= 1: every fragment type must
        # contribute at least one match (ref :81 `reversed(range(1, ...))`
        # — allowing L=0 would let a greedy one-type cover 'succeed' on
        # molecules the reference rejects with DecomposeError)
        remaining = num_atoms - len(used)
        for L in range(min(len(matches), remaining), 0, -1):
            for subset in itertools.combinations(matches, L):
                flat = list(itertools.chain(*subset))
                if len(flat) != len(set(flat)):
                    continue
                result = search(group_idx + 1, used | frozenset(flat),
                                chosen + (flat,))
                if result is not None:
                    return result
        return None

    return search(0, frozenset(), ())


# ---------------------------------------------------------------------------
# fragment topology tests (bond-array based, no RDKit)
# ---------------------------------------------------------------------------

def crossing_bonds(bond_pairs: Sequence[Tuple[int, int]],
                   frag_atom_idx) -> List[int]:
    """Indices of bonds with exactly one endpoint in the fragment."""
    frag = set(int(a) for a in frag_atom_idx)
    return [i for i, (a, b) in enumerate(bond_pairs)
            if (a in frag) != (b in frag)]


def is_terminal_fragment(bond_pairs, frag_atom_idx) -> bool:
    """Fragment connects to the rest by at most one bond
    (ref utils/preprocess.py:115-122)."""
    return len(crossing_bonds(bond_pairs, frag_atom_idx)) <= 1


# ---------------------------------------------------------------------------
# assignment (pure numpy/scipy)
# ---------------------------------------------------------------------------

def assign_fragments(frag_centroids: np.ndarray,
                     frag_atom_sets: Sequence[Sequence[int]],
                     bond_pairs: Sequence[Tuple[int, int]],
                     pocket_alpha_centers: Sequence[np.ndarray],
                     verbose: bool = False):
    """Assign fragments to pockets (arms) or scaffold.

    Args:
        frag_centroids: [F, 3]
        frag_atom_sets: per-fragment atom indices
        bond_pairs: undirected ligand bonds as (a, b) pairs
        pocket_alpha_centers: per pocket, [Mi, 3] alpha-sphere centroids

    Returns (assignment [F] with pocket id or num_pockets for scaffold,
             cluster_pocket_idx) — parity with ref extract_submols :170-243.
    """
    F = len(frag_centroids)
    P = len(pocket_alpha_centers)
    frag_centroids = np.asarray(frag_centroids, np.float64)

    # mean distance of each fragment to each pocket's alpha centers (:168-175)
    dist_mat = np.zeros((F, P))
    for p, centers in enumerate(pocket_alpha_centers):
        centers = np.asarray(centers).reshape(-1, 3)
        d = np.linalg.norm(frag_centroids[:, None] - centers[None], axis=-1)
        dist_mat[:, p] = d.mean(1)

    terminal = np.array([is_terminal_fragment(bond_pairs, s)
                         for s in frag_atom_sets])
    t_idx = np.nonzero(terminal)[0]

    # optimal matching of terminal fragments to pockets (:188-190)
    pocket_idx, frag_sel = linear_sum_assignment(dist_mat[t_idx].T)
    arms_frag_idx = t_idx[frag_sel]
    clustering_centers = [frag_centroids[i] for i in arms_frag_idx]
    cluster_pocket_idx = list(pocket_idx)
    if len(clustering_centers) < P:  # fewer arms than pockets (:193-201)
        if verbose:
            print('warning: less arms than pockets')
        for p in sorted(set(range(P)) - set(pocket_idx)):
            centers = np.asarray(pocket_alpha_centers[p]).reshape(-1, 3)
            clustering_centers.append(centers.mean(0))
            cluster_pocket_idx.append(p)

    # scaffold center = non-arm fragment farthest from all centers (:205-213)
    non_arm = np.array([i for i in range(F) if i not in arms_frag_idx],
                       dtype=np.int64)
    if len(non_arm) > 0:
        far = np.argmax(distance_matrix(
            frag_centroids[non_arm], np.asarray(clustering_centers)).sum(-1))
        scaffold_frag_idx = int(non_arm[far])
        clustering_centers.append(frag_centroids[scaffold_frag_idx])
    else:
        scaffold_frag_idx = None

    n_clusters = len(clustering_centers)
    frag_cluster_dist = distance_matrix(frag_centroids,
                                        np.asarray(clustering_centers))
    assignment = -np.ones(F, np.int64)
    assignment[arms_frag_idx] = pocket_idx
    if scaffold_frag_idx is not None:
        assignment[scaffold_frag_idx] = P  # scaffold label

    # nearest-center assignment with terminal-validity fallback (:227-243)
    for i in range(F):
        c = int(frag_cluster_dist[i].argmin())
        if c == n_clusters - 1 and scaffold_frag_idx is not None:
            assignment[i] = P
        else:
            p = cluster_pocket_idx[c] if c < len(cluster_pocket_idx) else P
            current_atoms: List[int] = []
            for j in np.nonzero(assignment == p)[0]:
                if j != i:
                    current_atoms += list(frag_atom_sets[j])
            current_atoms += list(frag_atom_sets[i])
            if is_terminal_fragment(bond_pairs, current_atoms):
                assignment[i] = p
            else:
                assignment[i] = P
    return assignment, cluster_pocket_idx


def split_by_assignment(assignment, frag_atom_sets, bond_pairs,
                        num_pockets: int):
    """Arm/scaffold atom-index lists from a fragment assignment
    (ref :246-280). Returns (all_submol_atom_idx with scaffold last,
    valid_pocket_id). Enforces the <=1-crossing-bond arm invariant."""
    all_arm_atom_idx, valid_pocket_id = [], []
    for p in range(num_pockets):
        atoms: List[int] = []
        for i in np.nonzero(assignment == p)[0]:
            atoms += list(frag_atom_sets[i])
        cb = crossing_bonds(bond_pairs, atoms)
        assert len(cb) <= 1, f'arm {p} has {len(cb)} crossing bonds'
        if atoms:
            valid_pocket_id.append(p)
            all_arm_atom_idx.append(sorted(atoms))
    scaffold_atoms: List[int] = []
    for i in np.nonzero(assignment == num_pockets)[0]:
        scaffold_atoms += list(frag_atom_sets[i])
    flat = list(itertools.chain(*all_arm_atom_idx)) + scaffold_atoms
    assert len(flat) == len(set(flat))
    return all_arm_atom_idx + [sorted(scaffold_atoms)], valid_pocket_id


# ---------------------------------------------------------------------------
# first-party fragmentation front end (no RDKit)
# ---------------------------------------------------------------------------

def ring_bond_flags(num_atoms: int,
                    bond_pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    """flags[i] is True iff bond i lies on a cycle (its endpoints remain
    connected when it is removed)."""
    adj = {i: set() for i in range(num_atoms)}
    for a, b in bond_pairs:
        adj[a].add(b)
        adj[b].add(a)
    flags = np.zeros(len(bond_pairs), bool)
    for i, (a, b) in enumerate(bond_pairs):
        # BFS a -> b avoiding the direct edge
        seen = {a}
        queue = [a]
        while queue and b not in seen:
            nxt = []
            for cur in queue:
                for nb in adj[cur]:
                    if cur == a and nb == b:
                        continue
                    if nb not in seen:
                        seen.add(nb)
                        nxt.append(nb)
            queue = nxt
        flags[i] = b in seen
    return flags


def bond_cut_fragments(num_atoms: int,
                       bond_pairs: Sequence[Tuple[int, int]],
                       bond_types: Optional[Sequence[int]] = None
                       ) -> List[List[int]]:
    """Fragments = connected components after cutting every acyclic single
    bond whose endpoints both have degree >= 2 (rotatable-bond-style cuts,
    keeping terminal groups attached to their neighbor).

    Documented divergence: the reference fragments with RDKit BRICS
    (ref utils/preprocess.py:18-62), which is SMARTS-environment-driven and
    unavailable without RDKit. This cut rule yields ring systems, linkers
    and capped terminals — the structure the downstream arm/scaffold
    assignment actually consumes (fragment centroids + crossing-bond
    terminality, assign_fragments above), so the pipeline stays runnable
    in-image. When RDKit is installed, extract_submols (BRICS) is used
    instead.
    """
    bond_pairs = [(int(a), int(b)) for a, b in bond_pairs]
    degree = np.zeros(num_atoms, np.int64)
    for a, b in bond_pairs:
        degree[a] += 1
        degree[b] += 1
    in_ring = ring_bond_flags(num_atoms, bond_pairs)
    if bond_types is None:
        single = np.ones(len(bond_pairs), bool)
    else:
        single = np.asarray(bond_types) == 1
    cut = single & ~in_ring & np.array(
        [degree[a] >= 2 and degree[b] >= 2 for a, b in bond_pairs])

    from decompdiff_tpu_torch.reconstruct.builder import _connected_fragments
    kept = {pair: 1 for i, pair in enumerate(bond_pairs) if not cut[i]}
    return [sorted(c) for c in _connected_fragments(num_atoms, kept)]


def undirected_bond_pairs(bond_index: np.ndarray,
                          bond_type: Optional[np.ndarray] = None):
    """Unique undirected (a, b) pairs (+ aligned types) from a directed
    [2, E] bond index (data/mol.py MolRecord layout)."""
    pairs, types, seen = [], [], set()
    for e in range(bond_index.shape[1]):
        a, b = int(bond_index[0, e]), int(bond_index[1, e])
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        pairs.append(key)
        if bond_type is not None:
            types.append(int(bond_type[e]))
    return pairs, (types if bond_type is not None else None)


def extract_submols_record(mol, pocket_alpha_centers, verbose: bool = False):
    """extract_submols for a first-party MolRecord (data/mol.py): bond-cut
    fragmentation + the shared numpy assignment core. Same return contract
    as extract_submols (ref utils/preprocess.py:139-281)."""
    bond_pairs, bond_types = undirected_bond_pairs(mol.bond_index,
                                                   mol.bond_type)
    frag_atom_sets = bond_cut_fragments(mol.num_atoms, bond_pairs,
                                        bond_types)
    pos = np.asarray(mol.pos, np.float64)
    centroids = np.stack([pos[list(s)].mean(0) for s in frag_atom_sets])
    assignment, _ = assign_fragments(centroids, frag_atom_sets, bond_pairs,
                                     pocket_alpha_centers, verbose)
    all_submol_atom_idx, valid_pocket_id = split_by_assignment(
        assignment, frag_atom_sets, bond_pairs, len(pocket_alpha_centers))
    return centroids, assignment, all_submol_atom_idx, valid_pocket_id


# ---------------------------------------------------------------------------
# BRICS front end (RDKit-gated)
# ---------------------------------------------------------------------------

def brics_decompose(mol):
    """BRICS fragment types + their substructure matches
    (ref decompose_molecule, utils/preprocess.py:18-62). Requires RDKit."""
    from rdkit import Chem
    from rdkit.Chem import BRICS
    raw = BRICS.BRICSDecompose(mol)
    frags_smiles, frags_atom_idx = [], []
    for smiles in list(raw):
        rogue = re.sub(r'\[[0-9]+\*\]', '[H]', smiles)
        rogue = re.sub(r'\(\)', '', rogue)
        frag = Chem.MolFromSmiles(rogue)
        if frag is None or not mol.HasSubstructMatch(frag):
            raise DecomposeError(f'fragment {smiles} does not match parent')
        frags_smiles.append(rogue)
        frags_atom_idx.append(mol.GetSubstructMatches(frag))
    order = sorted(range(len(frags_smiles)),
                   key=lambda i: len(frags_atom_idx[i]))
    return ([frags_smiles[i] for i in order],
            [frags_atom_idx[i] for i in order])


def extract_submols(mol, pocket_alpha_centers, verbose=False):
    """Full decomposition of an RDKit mol against AlphaSpace pockets
    (ref extract_submols, utils/preprocess.py:139-281). Returns
    (frag_centroids, assignment, all_submol_atom_idx, valid_pocket_id)."""
    from rdkit import Chem
    try:
        frags_smiles, match_groups = brics_decompose(mol)
    except DecomposeError:
        raise
    except Exception as e:
        raise DecomposeError(str(e))
    cover = find_exact_cover(match_groups, mol.GetNumAtoms())
    if cover is None:
        raise DecomposeError('no exact fragment cover')

    # flatten type-level covers into individual fragment instances (:148-163)
    frag_atom_sets = []
    for smiles, group_atoms in zip(frags_smiles, cover):
        query = Chem.MolFromSmiles(smiles)
        n = query.GetNumAtoms()
        if len(group_atoms) == n:
            frag_atom_sets.append(list(group_atoms))
        else:
            assert len(group_atoms) % n == 0
            taken = 0
            group_set = set(group_atoms)
            for match in mol.GetSubstructMatches(query):
                if all(a in group_set for a in match):
                    frag_atom_sets.append(list(match))
                    taken += len(match)
            assert taken == len(group_atoms)

    pos = mol.GetConformer().GetPositions()
    centroids = np.stack([pos[list(s)].mean(0) for s in frag_atom_sets])
    bond_pairs = [(b.GetBeginAtomIdx(), b.GetEndAtomIdx())
                  for b in mol.GetBonds()]
    assignment, _ = assign_fragments(centroids, frag_atom_sets, bond_pairs,
                                     pocket_alpha_centers, verbose)
    all_submol_atom_idx, valid_pocket_id = split_by_assignment(
        assignment, frag_atom_sets, bond_pairs, len(pocket_alpha_centers))
    return centroids, assignment, all_submol_atom_idx, valid_pocket_id
