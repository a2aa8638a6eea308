"""Point cloud -> molecule reconstruction (host, L8; port of
decompdiff_tpu/reconstruct/builder.py).

Two paths, mirroring the reference:
  * bond-aware (default when bond diffusion is on): build a molecule directly
    from predicted bond types, then run a repair cascade
    sanitize -> kekulize-check -> aromatic fix -> valence fix -> strict
    aromatic fix (ref utils/reconstruct.py:579-759).
  * geometry-only: perceive bonds from covalent radii with hypervalency
    pruning (OpenBabel-equivalent role; ref utils/reconstruct.py:461-524
    connect_the_dots + fixup).

When RDKit is installed the cascade operates on RDKit mols with exact
behavioral parity (charge fixes for N4, ring S+/N+ enumeration). Without
RDKit (this image) we run a self-contained valence-table repair on the
lightweight MolRecord: N with 4 bonds gets a +1 charge, aromatic-ring
nitrogens may take an explicit H, hypervalent atoms drop their most
stretched bonds. Outputs always include a MolRecord; an RDKit Mol is
attached when available.
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np

from decompdiff_tpu_torch.constants import COVALENT_RADII, MAX_VALENCE
from decompdiff_tpu_torch.data.mol import MolRecord

try:
    from rdkit import Chem
    from rdkit import Geometry
    HAS_RDKIT = True
except Exception:
    HAS_RDKIT = False


class MolReconsError(Exception):
    """ref utils/reconstruct.py:23."""


# --- lightweight valence machinery (RDKit-free path) -------------------------

_BOND_ORDER = {1: 1.0, 2: 2.0, 3: 3.0, 4: 1.5}


def _undirected_bonds(bond_index, bond_type):
    seen = {}
    for e in range(len(bond_type)):
        a, b = int(bond_index[0][e]), int(bond_index[1][e])
        t = int(bond_type[e])
        if t == 0 or a == b:
            continue
        key = (min(a, b), max(a, b))
        seen[key] = t
    return seen


def _valences(n_atoms: int, bonds: dict) -> np.ndarray:
    val = np.zeros(n_atoms)
    for (a, b), t in bonds.items():
        val[a] += _BOND_ORDER[t]
        val[b] += _BOND_ORDER[t]
    return val


def _connected_fragments(n_atoms: int, bonds: dict) -> List[List[int]]:
    parent = list(range(n_atoms))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (a, b) in bonds:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    groups = {}
    for i in range(n_atoms):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def _repair_record(element, pos, bonds: dict, check_validity: bool):
    """Self-contained repair: charge N4+, drop worst bonds on hypervalent
    atoms (sorted by stretch), validate against the valence table."""
    n = len(element)
    charges = np.zeros(n, np.int64)
    bonds = dict(bonds)

    for _ in range(50):
        val = _valences(n, bonds)
        bad = None
        for i in range(n):
            z = int(element[i])
            maxv = MAX_VALENCE.get(z, 4) + (1 if charges[i] > 0 else 0)
            if val[i] > maxv + 1e-6:
                # N with valence 4 -> N+ (parity with the reference's regex
                # charge fix, ref utils/reconstruct.py:666-686)
                if z == 7 and val[i] <= 4 + 1e-6 and charges[i] == 0:
                    charges[i] = 1
                    continue
                bad = i
                break
        if bad is None:
            break
        # drop the most stretched bond at the offending atom
        cand = [(k, t) for k, t in bonds.items() if bad in k]
        if not cand:
            break

        def stretch(kt):
            (a, b), _t = kt
            d = np.linalg.norm(pos[a] - pos[b])
            r = COVALENT_RADII.get(int(element[a]), 0.77) + \
                COVALENT_RADII.get(int(element[b]), 0.77)
            return d / r

        worst = max(cand, key=stretch)
        del bonds[worst[0]]
    else:
        if check_validity:
            raise MolReconsError('hypervalency repair did not converge')

    if check_validity:
        val = _valences(n, bonds)
        for i in range(n):
            z = int(element[i])
            maxv = MAX_VALENCE.get(z, 4) + (1 if charges[i] > 0 else 0)
            if val[i] > maxv + 1e-6:
                raise MolReconsError(
                    f'atom {i} (Z={z}) valence {val[i]} > {maxv}')
    return bonds, charges


def _record_from_bonds(element, pos, bonds: dict, charges) -> MolRecord:
    src, dst, types = [], [], []
    for (a, b), t in sorted(bonds.items()):
        src += [a, b]
        dst += [b, a]
        types += [t, t]
    bond_index = np.array([src, dst], np.int64).reshape(2, -1)
    bond_type = np.array(types, np.int64)
    aromatic = np.zeros(len(element), bool)
    if len(bond_type):
        aromatic[np.unique(bond_index[:, bond_type == 4])] = True
    return MolRecord(element=np.asarray(element, np.int64),
                     pos=np.asarray(pos, np.float32).reshape(-1, 3),
                     bond_index=bond_index, bond_type=bond_type,
                     aromatic=aromatic, charges=np.asarray(charges, np.int64))


# --- RDKit path ---------------------------------------------------------------

def _rdkit_build(xyz, atomic_nums, bonds: dict):
    mol = Chem.RWMol()
    conf = Chem.Conformer(len(atomic_nums))
    for i, z in enumerate(atomic_nums):
        mol.AddAtom(Chem.Atom(int(z)))
        conf.SetAtomPosition(i, Geometry.Point3D(*map(float, xyz[i])))
    mol.AddConformer(conf)
    bt = {1: Chem.BondType.SINGLE, 2: Chem.BondType.DOUBLE,
          3: Chem.BondType.TRIPLE, 4: Chem.BondType.AROMATIC}
    for (a, b), t in bonds.items():
        mol.AddBond(int(a), int(b), bt[t])
    return mol


def _rdkit_fix_valence(mol):
    """Charge N atoms reported hypervalent (ref :666-686)."""
    import re
    from copy import deepcopy
    mol = deepcopy(mol)
    pattern = re.compile(
        r'Explicit valence for atom # ([0-9]+) N, 4, is greater than permitted')
    for _ in range(100):
        try:
            Chem.SanitizeMol(mol)
            return mol, True
        except Chem.rdchem.AtomValenceException as e:
            idx = pattern.findall(e.args[0])
            if not idx:
                return mol, False
            mol.GetAtomWithIdx(int(idx[0])).SetFormalCharge(1)
        except Exception:
            return mol, False
    return mol, False


def _rdkit_ring_systems(mol):
    """Fused ring systems as atom-index lists (ref get_ring_sys :647-663)."""
    rings = [list(r) for r in Chem.GetSymmSSSR(mol)]
    systems: List[List[int]] = []
    for ring in rings:
        for prev in systems:
            if set(ring) & set(prev):
                prev.extend(ring)
                break
        else:
            systems.append(list(ring))
    return [sorted(set(s)) for s in systems]


def _rdkit_fix_aromatic(mol, strict=False):
    """Enumerate S+/N+/N-H assignments in aromatic rings until one
    sanitizes (ref fix_aromatic :696-759)."""
    from copy import deepcopy
    mol_orig = mol
    aromatic_atoms = {a.GetIdx() for a in mol.GetAromaticAtoms()}
    N_lists, S_lists = [], []
    for sys_atoms in _rdkit_ring_systems(mol):
        if not (set(sys_atoms) & aromatic_atoms):
            continue
        idx_N = [i for i in sys_atoms
                 if mol.GetAtomWithIdx(i).GetSymbol() == 'N']
        if idx_N:
            N_lists.append(idx_N + [-1])
        idx_S = [i for i in sys_atoms
                 if mol.GetAtomWithIdx(i).GetSymbol() == 'S']
        if idx_S:
            S_lists.append(idx_S + [-1])

    def subsets(xs):
        out = []
        for k in range(len(xs) + 1):
            out.extend(itertools.combinations(xs, k))
        return out

    perms = (subsets([s for ring in S_lists for s in ring if s != -1])
             if strict else list(itertools.product(*S_lists)))
    for perm in perms:
        cand = deepcopy(mol_orig)
        for idx in (x for x in perm if x != -1):
            cand.GetAtomWithIdx(idx).SetFormalCharge(1)
        try:
            if strict:
                cand, ok = _rdkit_fix_valence(cand)
            Chem.SanitizeMol(cand)
            return cand, True
        except Exception:
            continue

    perms = (subsets([s for ring in N_lists for s in ring if s != -1])
             if strict else list(itertools.product(*N_lists)))
    for perm in perms:
        perm = [x for x in perm if x != -1]
        for action in itertools.product([0, 1], repeat=len(perm)):
            cand = deepcopy(mol_orig)
            for idx, act in zip(perm, action):
                if act == 0:
                    cand.GetAtomWithIdx(idx).SetNumExplicitHs(1)
                else:
                    cand.GetAtomWithIdx(idx).SetFormalCharge(1)
            try:
                if strict:
                    cand, ok = _rdkit_fix_valence(cand)
                Chem.SanitizeMol(cand)
                return cand, True
            except Exception:
                continue
    return mol_orig, False


def _rdkit_repair_cascade(mol, check_validity):
    """ref reconstruct_from_generated_with_bond :611-644."""
    from copy import deepcopy
    if not check_validity:
        return mol
    fixed = False
    try:
        Chem.SanitizeMol(mol)
        fixed = True
    except Exception:
        pass
    if not fixed:
        try:
            Chem.Kekulize(deepcopy(mol))
        except Chem.rdchem.KekulizeException as e:
            if 'Unkekulized' in e.args[0]:
                mol, fixed = _rdkit_fix_aromatic(mol)
        except Exception:
            pass
    if not fixed:
        mol, fixed = _rdkit_fix_valence(mol)
    if not fixed:
        mol, fixed = _rdkit_fix_aromatic(mol, True)
    try:
        Chem.SanitizeMol(mol)
    except Exception:
        raise MolReconsError('sanitize failed after repair cascade')
    return mol


# --- public API ---------------------------------------------------------------

def reconstruct_from_generated_with_bond(xyz, atomic_nums, bond_index,
                                         bond_type, check_validity=True):
    """Bond-aware reconstruction (ref utils/reconstruct.py:579-644).

    Returns an RDKit Mol when RDKit is available, else a repaired MolRecord.
    Raises MolReconsError when the molecule cannot be repaired.
    """
    bonds = _undirected_bonds(bond_index, bond_type)
    if HAS_RDKIT:
        mol = _rdkit_build(xyz, atomic_nums, bonds)
        return _rdkit_repair_cascade(mol.GetMol(), check_validity)
    repaired, charges = _repair_record(atomic_nums, np.asarray(xyz), bonds,
                                       check_validity)
    return _record_from_bonds(atomic_nums, xyz, repaired, charges)


def perceive_bonds(xyz, atomic_nums, stretch_factor=1.3, min_d=0.4):
    """Covalent-radius bond perception with stretch pruning + hypervalency
    repair (OpenBabel connect_the_dots; ref utils/reconstruct.py:76-193)."""
    from decompdiff_tpu_torch.reconstruct import ligan
    bonds = ligan.connect_the_dots(xyz, atomic_nums,
                                   covalent_factor=stretch_factor)
    return bonds, np.zeros(len(atomic_nums), np.int64)


def _rdkit_from_perceived(xyz, atomic_nums, bonds, flags):
    """Perceived graph -> sanitized RDKit mol, mirroring
    convert_ob_mol_to_rd_mol (ref utils/reconstruct.py:196-307): aromatic
    flags restricted to <=6-rings, double/triple downgrades on hypervalent
    atoms (longest first), N4+ charge, sanitize w/o kekulize, aromatic
    consistency pass; then postprocess_rd_mol_1/2 (ref :382-458)."""
    from copy import deepcopy
    mol = _rdkit_build(xyz, atomic_nums, bonds)
    ri = Chem.GetSymmSSSR(mol)
    ring_ok = set()
    for ring in ri:
        if len(ring) <= 6:
            ring_ok.update(ring)
    for i, a in enumerate(mol.GetAtoms()):
        a.SetIsAromatic(bool(flags[i]) and i in ring_ok)
    for bond in mol.GetBonds():
        i, j = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        bond.SetIsAromatic(bool(flags[i]) and bool(flags[j])
                           and i in ring_ok and j in ring_ok)

    pt = Chem.GetPeriodicTable()
    positions = np.asarray(xyz, np.float64)

    def calc_valence(atom):
        return sum(b.GetBondTypeAsDouble() for b in atom.GetBonds())

    # downgrade double/triple on hypervalent atoms, longest first (ref :240-261)
    nonsingles = []
    for bond in mol.GetBonds():
        if bond.GetBondType() in (Chem.BondType.DOUBLE, Chem.BondType.TRIPLE):
            i, j = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
            nonsingles.append((float(np.linalg.norm(
                positions[i] - positions[j])), bond))
    nonsingles.sort(reverse=True, key=lambda t: t[0])
    for _d, bond in nonsingles:
        a1, a2 = bond.GetBeginAtom(), bond.GetEndAtom()
        if (calc_valence(a1) > pt.GetDefaultValence(a1.GetAtomicNum())
                or calc_valence(a2) > pt.GetDefaultValence(a2.GetAtomicNum())):
            bond.SetBondType(Chem.BondType.DOUBLE
                             if bond.GetBondType() == Chem.BondType.TRIPLE
                             else Chem.BondType.SINGLE)

    for atom in mol.GetAtoms():  # N with 4 neighbors -> N+ (ref :263-266)
        if atom.GetAtomicNum() == 7 and atom.GetDegree() == 4:
            atom.SetFormalCharge(1)

    try:
        Chem.SanitizeMol(mol, Chem.SANITIZE_ALL ^ Chem.SANITIZE_KEKULIZE)
    except Exception:
        raise MolReconsError('sanitize (no kekulize) failed')

    # aromatic consistency between atoms and bonds (ref :295-305)
    for bond in mol.GetBonds():
        a1, a2 = bond.GetBeginAtom(), bond.GetEndAtom()
        if bond.GetIsAromatic():
            if not a1.GetIsAromatic() or not a2.GetIsAromatic():
                bond.SetIsAromatic(False)
        elif a1.GetIsAromatic() and a2.GetIsAromatic():
            bond.SetIsAromatic(True)

    # postprocess_rd_mol_1: radical -> bond-order upgrade (ref :382-421)
    mol = Chem.RemoveHs(mol, sanitize=False)
    nbh = {}
    for bond in mol.GetBonds():
        b, e = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        nbh.setdefault(b, []).append(e)
        nbh.setdefault(e, []).append(b)
    upgrade = {Chem.BondType.SINGLE: Chem.BondType.DOUBLE,
               Chem.BondType.DOUBLE: Chem.BondType.TRIPLE}
    for atom in mol.GetAtoms():
        idx = atom.GetIdx()
        num_radical = atom.GetNumRadicalElectrons()
        if num_radical > 0:
            for j in nbh.get(idx, []):
                if j <= idx:
                    continue
                nb = mol.GetAtomWithIdx(j)
                if nb.GetNumRadicalElectrons() > 0:
                    bond = mol.GetBondBetweenAtoms(idx, j)
                    if bond.GetBondType() in upgrade:
                        bond.SetBondType(upgrade[bond.GetBondType()])
                        nb.SetNumRadicalElectrons(
                            nb.GetNumRadicalElectrons() - 1)
                        num_radical -= 1
            atom.SetNumRadicalElectrons(num_radical)
        num_radical = atom.GetNumRadicalElectrons()
        if num_radical > 0:
            atom.SetNumRadicalElectrons(0)
            atom.SetNumExplicitHs(atom.GetNumExplicitHs() + num_radical)

    # postprocess_rd_mol_2: 3-ring non-carbon / O-O fixes (ref :424-458)
    edit = Chem.RWMol(mol)
    rings = [set(r) for r in mol.GetRingInfo().AtomRings()]
    for ring in rings:
        if len(ring) != 3:
            continue
        non_c = [i for i in ring
                 if mol.GetAtomWithIdx(i).GetSymbol() != 'C']
        oxy = [i for i in ring if mol.GetAtomWithIdx(i).GetSymbol() == 'O']
        if len(non_c) == 2:
            edit.RemoveBond(*non_c)
        if len(oxy) == 2:
            if edit.GetBondBetweenAtoms(*oxy) is not None:
                edit.RemoveBond(*oxy)
            for o in oxy:
                a = edit.GetAtomWithIdx(o)
                a.SetNumExplicitHs(a.GetNumExplicitHs() + 1)
    mol = edit.GetMol()
    for atom in mol.GetAtoms():
        if atom.GetFormalCharge() > 0 and not (
                atom.GetAtomicNum() == 7 and atom.GetDegree() == 4):
            atom.SetFormalCharge(0)
    try:
        Chem.SanitizeMol(mol, Chem.SANITIZE_ALL ^ Chem.SANITIZE_KEKULIZE)
    except Exception:
        raise MolReconsError('post-process sanitize failed')
    return mol


def reconstruct_from_generated(xyz, atomic_nums, aromatic=None,
                               basic_mode=True):
    """Geometry-only reconstruction — the full liGAN cascade
    (ref utils/reconstruct.py:461-524): connect_the_dots with stretch
    pruning + hypervalency repair, fixup aromatic hints, ring aromatic
    majority vote, geometric bond-order perception, radical/3-ring
    postprocess. basic_mode=True ignores the aromatic indicators, matching
    every reference call site (ref sample_diffusion_decomp.py:431,
    guidance_funcs.py:137)."""
    from decompdiff_tpu_torch.reconstruct import ligan
    indicators = None if basic_mode else aromatic
    bonds, flags = ligan.perceive_molecule(xyz, atomic_nums, indicators)
    if not bonds and len(atomic_nums) > 1:
        raise MolReconsError('no bonds perceived')
    if HAS_RDKIT:
        return _rdkit_from_perceived(xyz, atomic_nums, bonds, flags)
    bonds, charges = ligan.postprocess_record(
        xyz, atomic_nums, bonds, np.zeros(len(atomic_nums), np.int64))
    # final valence validation/repair on the perceived orders
    bonds, charges = _repair_record(atomic_nums, np.asarray(xyz), bonds,
                                    check_validity=True)
    record = _record_from_bonds(atomic_nums, xyz, bonds, charges)
    return record


def mol_record_from_prediction(pred_pos, pred_v, pred_bond=None,
                               atom_mode='basic', check_validity=True):
    """Convenience: predicted class indices -> reconstructed molecule."""
    from decompdiff_tpu_torch.constants import (
        atomic_numbers_from_index, is_aromatic_from_index)
    atomic = atomic_numbers_from_index(pred_v, atom_mode)
    if pred_bond is not None:
        nl = len(atomic)
        bm = np.asarray(pred_bond).reshape(nl, nl)
        src, dst = np.nonzero(bm)
        return reconstruct_from_generated_with_bond(
            pred_pos, atomic, np.stack([dst, src]), bm[src, dst],
            check_validity=check_validity)
    aro = is_aromatic_from_index(pred_v, atom_mode)
    return reconstruct_from_generated(pred_pos, atomic, aro)


def is_connected(mol) -> bool:
    """Single-fragment check (reference uses '.' in SMILES)."""
    if HAS_RDKIT and not isinstance(mol, MolRecord):
        from rdkit import Chem as _C
        return '.' not in _C.MolToSmiles(mol)
    bonds = _undirected_bonds(mol.bond_index, mol.bond_type)
    return len(_connected_fragments(mol.num_atoms, bonds)) == 1
