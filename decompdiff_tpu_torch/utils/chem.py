"""Chemistry helpers (host side; port of decompdiff_tpu/utils/chem.py, its
MolRecord path).

Role parity with ref utils/chem.py: rotatable-bond fragmentation, MMFF
optimization (the engine behind the mmff_min guidance drift, ref
utils/guidance_funcs.py:121-158), fused ring systems, RMSD. Every helper
runs on MolRecords without RDKit via the first-party fallbacks (structural
rotatable-bond rule, guidance/ffmin relaxation, cycle-basis rings, Kabsch
RMSD); RDKit inputs use the reference recipes verbatim when RDKit is
installed. The conformer generators (compute_3d_coors*) embed MolRecords
through utils/confgen.py.
"""

from __future__ import annotations

from copy import deepcopy
from typing import List, Sequence, Tuple

import numpy as np

from decompdiff_tpu_torch.data.mol import MolRecord
from decompdiff_tpu_torch.reconstruct.builder import (
    _connected_fragments, _undirected_bonds)

try:
    from rdkit import Chem
    from rdkit.Chem import AllChem, rdMolAlign
    from rdkit.Chem.Lipinski import RotatableBondSmarts
    HAS_RDKIT = True
except Exception:
    HAS_RDKIT = False


def _require_rdkit():
    if not HAS_RDKIT:
        raise ImportError('RDKit is required for this chemistry helper')


def ring_bond_flags(num_atoms: int,
                    bond_pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    """flags[i] is True iff bond i lies on a cycle (its endpoints remain
    connected when it is removed); decompdiff_tpu/preprocess/decompose.py's
    helper of the same name."""
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


def _record_rotatable_bonds(mol) -> Tuple[list, list]:
    """(undirected bond pairs, rotatable indices into them) for a MolRecord.

    Implements RDKit's RotatableBondSmarts `[!$(*#*)&!D1]-&!@[!$(*#*)&!D1]`
    (ref utils/chem.py:7) structurally: a single, non-ring bond whose two
    endpoints each have degree >= 2 and sit in no triple bond.
    """
    bonds = _undirected_bonds(mol.bond_index, mol.bond_type)
    pairs = list(bonds.keys())
    in_ring = ring_bond_flags(mol.num_atoms, pairs)
    degree = np.zeros(mol.num_atoms, np.int64)
    in_triple = np.zeros(mol.num_atoms, bool)
    for (a, b), order in bonds.items():
        degree[a] += 1
        degree[b] += 1
        if order == 3:
            in_triple[a] = in_triple[b] = True
    rotatable = [i for i, (a, b) in enumerate(pairs)
                 if bonds[(a, b)] == 1 and not in_ring[i]
                 and degree[a] >= 2 and degree[b] >= 2
                 and not in_triple[a] and not in_triple[b]]
    return pairs, rotatable


def _record_subset(mol, atoms: List[int]):
    """Sub-MolRecord over `atoms`, bonds remapped (no dummy cut atoms)."""
    idx = {a: i for i, a in enumerate(atoms)}
    keep = [k for k in range(mol.bond_index.shape[1])
            if int(mol.bond_index[0, k]) in idx
            and int(mol.bond_index[1, k]) in idx]
    bond_index = np.array(
        [[idx[int(mol.bond_index[0, k])] for k in keep],
         [idx[int(mol.bond_index[1, k])] for k in keep]],
        np.int64).reshape(2, -1)
    return MolRecord(
        element=mol.element[atoms], pos=mol.pos[atoms],
        bond_index=bond_index, bond_type=mol.bond_type[keep],
        aromatic=mol.aromatic[atoms], name=mol.name)


def break_rotatable_bond(mol, rotatable_bond=None):
    """Fragment on rotatable bonds (ref utils/chem.py:12-23).

    MolRecords (or no RDKit): first-party path — rotatable bonds by the
    structural SMARTS semantics, fragments as sub-MolRecords (connected
    components after the cuts; unlike RDKit's FragmentOnBonds no dummy
    atoms mark the cut points). `rotatable_bond` is then a list of
    undirected (a, b) pairs instead of RDKit bond indices.
    """
    if hasattr(mol, 'bond_index') or not HAS_RDKIT:
        pairs, rot = _record_rotatable_bonds(mol)
        if rotatable_bond is None:
            rotatable_bond = [pairs[i] for i in rot]
        if not rotatable_bond:
            return [mol], []
        cut = {(min(a, b), max(a, b)) for a, b in rotatable_bond}
        kept = {p: 1 for p in pairs if p not in cut}
        frags = [_record_subset(mol, sorted(comp))
                 for comp in _connected_fragments(mol.num_atoms, kept)]
        return frags, rotatable_bond
    if rotatable_bond is None:
        pairs = mol.GetSubstructMatches(RotatableBondSmarts)
        rotatable_bond = [mol.GetBondBetweenAtoms(a, b).GetIdx()
                          for a, b in pairs]
    if not rotatable_bond:
        return [mol], []
    f = Chem.FragmentOnBonds(mol, rotatable_bond)
    return list(Chem.GetMolFrags(f, asMols=True)), rotatable_bond


def get_num_rotatable_bonds(mol) -> int:
    """Rotatable-bond count (ref utils/chem.py:26-28); MolRecords use the
    structural SMARTS semantics of `_record_rotatable_bonds`."""
    if hasattr(mol, 'bond_index') or not HAS_RDKIT:
        return len(_record_rotatable_bonds(mol)[1])
    return len(mol.GetSubstructMatches(RotatableBondSmarts))


def compute_3d_coors(mol, random_seed: int = 0):
    """Embed one conformer (ref utils/chem.py:32-40). MolRecords (and any
    input when RDKit is absent) embed via the first-party distance-geometry
    path (utils/confgen.py)."""
    if hasattr(mol, 'bond_index') or not HAS_RDKIT:
        from decompdiff_tpu_torch.utils.confgen import (
            embed_conformer, record_bonds)
        bonds = record_bonds(mol)
        if not bonds:
            return 0, 0
        pos, _ = embed_conformer(mol.element, bonds,
                                 np.random.default_rng(random_seed))
        return pos, 1
    mol = Chem.AddHs(mol)
    if AllChem.EmbedMolecule(mol, randomSeed=random_seed) == -1:
        return 0, 0
    mol = Chem.RemoveHs(mol)
    return mol.GetConformer(0).GetPositions(), 1


def compute_3d_coors_multiple(mol, numConfs=20, maxIters=400, randomSeed=1):
    """Multi-conformer embedding + MMFF ranking (ref utils/chem.py:43-60).

    First-party path (MolRecords / no RDKit): returns
    (positions_list, [(0, energy, conf_idx), ...] sorted by energy, 1) —
    the positions list replaces the conformer-holding RDKit mol; the result
    tuples keep the reference's (converged, energy, confId) layout."""
    if hasattr(mol, 'bond_index') or not HAS_RDKIT:
        from decompdiff_tpu_torch.utils.confgen import (
            generate_conformers, record_bonds)
        bonds = record_bonds(mol)
        if not bonds:
            return None, [], 0
        confs = generate_conformers(mol.element, bonds, n_confs=numConfs,
                                    seed=randomSeed, max_iter=maxIters)
        return ([pos for pos, _ in confs],
                [(0, e, i) for i, (_, e) in enumerate(confs)], 1)
    mol = Chem.AddHs(mol, addCoords=True)
    AllChem.EmbedMultipleConfs(mol, numConfs=numConfs, numThreads=0,
                               randomSeed=randomSeed)
    if mol.GetConformers() == ():
        return None, [], 0
    try:
        result = AllChem.MMFFOptimizeMoleculeConfs(mol, maxIters=maxIters,
                                                   numThreads=0)
    except Exception:
        return None, [], 0
    mol = Chem.RemoveHs(mol)
    result = [(r[0], r[1], i) for i, r in enumerate(result) if r[0] == 0]
    if not result:
        return None, [], 0
    result.sort()
    return mol, result, 1


def get_rmsd(ref, pred, heavy_only=True) -> float:
    """Best-alignment RMSD (ref utils/chem.py:63-68); coordinate arrays and
    MolRecords use the Kabsch path (identity atom mapping)."""
    if not HAS_RDKIT or hasattr(ref, 'bond_index') or isinstance(
            ref, np.ndarray):
        a = ref.pos if hasattr(ref, 'pos') else ref
        b = pred.pos if hasattr(pred, 'pos') else pred
        return _kabsch_rmsd(a, b)
    if heavy_only:
        ref = Chem.RemoveHs(ref)
        pred = Chem.RemoveHs(pred)
    return rdMolAlign.GetBestRMS(pred, ref)


def _kabsch_rmsd(a: np.ndarray, b: np.ndarray) -> float:
    """Optimal-rotation RMSD between identically-indexed coordinate sets.
    First-party stand-in for rdMolAlign.GetBestRMS (which additionally
    searches symmetry-equivalent atom mappings — documented divergence)."""
    a = np.asarray(a, np.float64) - np.mean(a, 0)
    b = np.asarray(b, np.float64) - np.mean(b, 0)
    u, _, vt = np.linalg.svd(a.T @ b)
    d = np.sign(np.linalg.det(u @ vt))
    rot = u @ np.diag([1.0, 1.0, d]) @ vt
    return float(np.sqrt(np.mean(np.sum((a @ rot - b) ** 2, axis=-1))))


def _ff_optimize_record(record):
    """First-party force-field minimization of a MolRecord via the ffmin
    engine (role parity with ref utils/chem.py:71-107 when RDKit/MMFF are
    absent); returns (energy_change, rmsd, relaxed_record) or (None,)."""
    from decompdiff_tpu_torch.guidance.ffmin import (
        build_ff_terms, ff_energy_grad, relax_positions)
    bonds = _undirected_bonds(record.bond_index, record.bond_type)
    if not bonds:
        return (None,)
    pos = np.asarray(record.pos, np.float64).reshape(-1, 3)
    try:
        terms = build_ff_terms(pos, record.element, bonds)
        energy_before = ff_energy_grad(pos.reshape(-1), terms)[0]
        relaxed = relax_positions(pos, record.element, bonds)
        energy_after = ff_energy_grad(relaxed.reshape(-1), terms)[0]
    except Exception:
        return (None,)
    out = deepcopy(record)
    out.pos = relaxed.astype(np.float32)
    return (float(energy_before - energy_after),
            _kabsch_rmsd(pos, relaxed), out)


def ff_optimize(ori_mol, addHs=False, enable_torsion=False):
    """MMFF94s minimization; returns (energy_change, rmsd, mol) or (None,)
    (ref utils/chem.py:71-107). MolRecords (and any input when RDKit is
    absent) route through the first-party ffmin force field instead."""
    if hasattr(ori_mol, 'bond_index') or not HAS_RDKIT:
        return _ff_optimize_record(ori_mol)
    mol = deepcopy(ori_mol)
    Chem.GetSymmSSSR(mol)
    if addHs:
        mol = Chem.AddHs(mol, addCoords=True)
    mp = AllChem.MMFFGetMoleculeProperties(mol, mmffVariant='MMFF94s')
    if mp is None:
        return (None,)
    try:
        ff = AllChem.MMFFGetMoleculeForceField(mol, mp)
        energy_before = ff.CalcEnergy()
        ff.Minimize()
        energy_change = energy_before - ff.CalcEnergy()
        Chem.SanitizeMol(ori_mol)
        Chem.SanitizeMol(mol)
        rmsd = rdMolAlign.GetBestRMS(ori_mol, mol)
    except Exception:
        return (None,)
    mol = Chem.RemoveHs(mol)
    return energy_change, rmsd, mol


def get_ring_systems(mol, includeSpiro=False) -> Tuple[Tuple[int, ...], ...]:
    """Fused ring systems (ref utils/chem.py:110-127). Accepts RDKit mols or
    MolRecords (via the cycle-basis ring finder)."""
    if HAS_RDKIT and not hasattr(mol, 'bond_index'):
        ri = mol.GetRingInfo()
        rings = ri.AtomRings()
    else:
        rings = _record_rings(mol)
    systems: List[set] = []
    for ring in rings:
        ring_ats = set(ring)
        n_systems = []
        for system in systems:
            common = len(ring_ats & system)
            if common and (includeSpiro or common > 1):
                ring_ats |= system
            else:
                n_systems.append(system)
        n_systems.append(ring_ats)
        systems = n_systems
    return tuple(tuple(s) for s in systems)


def _record_rings(mol) -> List[Tuple[int, ...]]:
    """Fundamental cycles of a MolRecord's bond graph."""
    bonds = _undirected_bonds(mol.bond_index, mol.bond_type)
    adj = {}
    for (a, b) in bonds:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    parent, depth = {}, {}
    tree = set()
    for root in range(mol.num_atoms):
        if root in parent or root not in adj:
            continue
        parent[root], depth[root] = root, 0
        stack = [root]
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if v not in parent:
                    parent[v], depth[v] = u, depth[u] + 1
                    tree.add((min(u, v), max(u, v)))
                    stack.append(v)
    rings = []
    for (a, b) in bonds:
        if (a, b) in tree:
            continue
        path_a, path_b = [a], [b]
        ua, ub = a, b
        while ua != ub:
            if depth[ua] >= depth[ub]:
                ua = parent[ua]
                path_a.append(ua)
            else:
                ub = parent[ub]
                path_b.append(ub)
        rings.append(tuple(path_a + path_b[-2::-1]))
    return rings


def num_x_mem_ring(mol, ring_sizes) -> List[int]:
    """Counts of fused-ring systems by size (ref utils/chem.py:130-139)."""
    counts = [0] * len(ring_sizes)
    for ring_ats in get_ring_systems(mol):
        size = len(ring_ats)
        if size in ring_sizes:
            counts[list(ring_sizes).index(size)] += 1
    return counts
