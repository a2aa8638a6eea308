"""Full Wildman-Crippen logP over MolRecord graphs (RDKit-free).

The reference scores logP with RDKit's ``Crippen.MolLogP``
(ref utils/evaluation/scoring_func.py:81), an implementation of the 68-type
atom-contribution model of Wildman & Crippen, *Prediction of Physicochemical
Parameters by Atomic Contributions*, J. Chem. Inf. Comput. Sci. 1999, 39,
868-873 (the table RDKit ships as ``Data/Crippen.txt``). This module
re-implements the published atom typing directly over a MolRecord's
(element, bonds, aromatic, implicit-H, charge) graph instead of SMARTS
matching: each classifier below mirrors one published type's SMARTS pattern
set, evaluated in the published first-match-wins order.

Exactness: the type table and contributions are the published ones; typing
is verified against hand-assigned published types and against arithmetic
anchor sums for molecules whose RDKit ``MolLogP`` values are standard
(benzene 1.6866, ethanol -0.0014, octane 3.3668, acetic acid 0.0909,
naphthalene 2.8398, ... — tests/test_crippen.py). Exotic-element types
(Me1/Me2 metals) follow the published grouping; atoms outside the table
contribute 0.0, matching RDKit's unmatched-atom behavior.

Port of decompdiff_tpu/evaluation/crippen.py,
the same numpy in the same order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

Bond = Tuple[int, int]

# Wildman-Crippen 1999 Table 1 logP contributions (RDKit Data/Crippen.txt).
CRIPPEN_LOGP: Dict[str, float] = {
    'C1': 0.1441, 'C2': 0.0, 'C3': -0.2035, 'C4': -0.2051, 'C5': -0.2783,
    'C6': 0.1551, 'C7': 0.0017, 'C8': 0.08452, 'C9': -0.1444,
    'C10': -0.0516, 'C11': 0.1193, 'C12': -0.0967, 'C13': -0.5443,
    'C14': 0.0, 'C15': 0.245, 'C16': 0.198, 'C17': 0.0, 'C18': 0.1581,
    'C19': 0.2955, 'C20': 0.2713, 'C21': 0.136, 'C22': 0.4619,
    'C23': 0.5437, 'C24': 0.1893, 'C25': -0.8186, 'C26': 0.264,
    'C27': 0.2148, 'CS': 0.08129,
    'H1': 0.123, 'H2': -0.2677, 'H3': 0.2142, 'H4': 0.298, 'HS': 0.1125,
    'N1': -1.019, 'N2': -0.7096, 'N3': -1.027, 'N4': -0.5188,
    'N5': 0.08387, 'N6': 0.1836, 'N7': -0.3187, 'N8': -0.4458,
    'N9': 0.01508, 'N10': -1.95, 'N11': -0.3239, 'N12': -1.119,
    'N13': -0.3396, 'N14': 0.2887, 'NS': -0.4806,
    'O1': 0.1552, 'O2': -0.2893, 'O3': -0.0684, 'O4': -0.4195,
    'O5': 0.0335, 'O6': -0.3339, 'O7': -1.189, 'O8': 0.1788,
    'O9': -0.1526, 'O10': 0.1129, 'O11': 0.4833, 'O12': -1.326,
    'OS': -0.1188,
    'F': 0.4202, 'Cl': 0.6895, 'Br': 0.8456, 'I': 0.8857, 'Hal': -2.996,
    'P': 0.8612, 'S1': 0.6482, 'S2': -0.0024, 'S3': 0.6237,
    'Me1': -0.3808, 'Me2': -0.0025,
}

_HALOGENS = {9: 'F', 17: 'Cl', 35: 'Br', 53: 'I'}
# standard organic set used by the C13/C27/N-O neighbor predicates
_ORGANIC = {6, 7, 8, 16, 9, 17, 35, 53}
# Me1: groups IA/IIA + transition metals; Me2: group IIIA/IVA metalloids
_ME1 = {3, 4, 11, 12, 19, 20, 37, 38, 55, 56} | set(range(21, 31)) \
    | set(range(39, 49)) | set(range(72, 81))
_ME2 = {5, 13, 14, 31, 32, 49, 50, 81, 82}


class _Atom:
    """Per-atom view the classifiers read."""

    __slots__ = ('z', 'arom', 'h', 'q', 'nbrs', 'orders', 'deg', 'sp3')

    def __init__(self, z, arom, h, q, nbrs):
        self.z = z
        self.arom = arom
        self.h = h
        self.q = q
        self.nbrs = nbrs                       # [(j, order)]
        self.orders = [o for _, o in nbrs]
        self.deg = len(nbrs)
        # X4 carbon: four connections, all single, non-aromatic
        self.sp3 = (not arom and all(o == 1 for o in self.orders)
                    and self.deg + h == 4)


def _build(element, bonds: Dict[Bond, int], aromatic, h_counts,
           charges) -> List[_Atom]:
    element = np.asarray(element)
    aromatic = np.asarray(aromatic, bool)
    n = len(element)
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    arom = aromatic.copy()
    for (a, b), o in bonds.items():
        adj[a].append((b, int(o)))
        adj[b].append((a, int(o)))
        if o == 4:
            arom[a] = arom[b] = True
    return [_Atom(int(element[i]), bool(arom[i]), int(h_counts[i]),
                  int(charges[i]) if charges is not None else 0, adj[i])
            for i in range(n)]


def _type_carbon(a: _Atom, atoms: List[_Atom]) -> str:
    nb = [(atoms[j], o) for j, o in a.nbrs]
    if not a.arom:
        ali_c = [x for x, o in nb if x.z == 6 and not x.arom and o == 1]
        arom_nbr = [x for x, o in nb if x.arom]
        het_ali = [x for x, o in nb
                   if not x.arom and x.z in (7, 8, 15, 16, 9, 17, 35, 53)]
        if a.sp3:
            all_ali_c = len(ali_c) == a.deg
            # C1: [CH4] / [CH3]C / [CH2](C)C
            if a.h == 4 or (a.h == 3 and all_ali_c and a.deg == 1) or \
                    (a.h == 2 and all_ali_c and a.deg == 2):
                return 'C1'
            # C2: [CH](C)(C)C / [C](C)(C)(C)C
            if a.h <= 1 and all_ali_c and a.deg >= 3:
                return 'C2'
            # C3: [CH3][N,O,P,S,F,Cl,Br,I] / [CH2X4][het]
            if a.h >= 2 and het_ali:
                return 'C3'
            # C4: [CH1X4][het] / [CH0X4][het]
            if a.h <= 1 and het_ali:
                return 'C4'
            # C8-C12: sp3 carbon on an aromatic atom
            if arom_nbr:
                arom_c = any(x.z == 6 for x in arom_nbr)
                if a.h == 3:
                    return 'C8' if arom_c else 'C9'
                if a.h == 2:
                    return 'C10'
                if a.h == 1:
                    return 'C11'
                return 'C12'
            # C27: [CX4][!standard-organic]
            if any(x.z not in _ORGANIC and x.z != 1 for x, _ in nb):
                return 'C27'
            return 'CS'
        # unsaturated aliphatic carbon
        dbl = [(x, o) for x, o in nb if o == 2]
        if any(o == 3 for _, o in nb) and a.deg + a.h <= 2:
            return 'C7'                       # [CX2]#[A;!#1]
        # C5: [C]=[!C;A;!#1] — double bond to an aliphatic heteroatom
        if any(x.z != 6 and not x.arom for x, _ in dbl):
            return 'C5'
        # C26: =C with an aromatic substituent, or =c
        if any(x.arom for x, _ in dbl):
            return 'C26'
        if dbl and any(x.arom for x, o in nb if o == 1):
            return 'C26'
        # C6: =C with only aliphatic surroundings
        if any(x.z == 6 and not x.arom for x, _ in dbl):
            return 'C6'
        return 'CS'
    # aromatic carbon
    single = [(x, o) for x, o in nb if o == 1]
    # C13: [cH0] bonded to an exotic atom
    if a.h == 0 and any(x.z not in _ORGANIC and x.z != 1 and not x.arom
                        for x, _ in single):
        return 'C13'
    for z, t in ((9, 'C14'), (17, 'C15'), (35, 'C16'), (53, 'C17')):
        if any(x.z == z for x, _ in nb):
            return t
    if a.h >= 1:
        return 'C18'                          # [cH]
    # aromatic bonds are encoded as order 4 in MolRecords (Kekulé-encoded
    # aromatic rings are not expected here; data/mol.py emits order 4)
    n_arom_bonds = sum(1 for _, o in nb if o == 4)
    if n_arom_bonds >= 3:
        return 'C19'                          # [c](:a)(:a):a
    if any(x.arom for x, _ in single):
        return 'C20'                          # biaryl link
    for z, t in ((6, 'C21'), (7, 'C22'), (8, 'C23'), (16, 'C24')):
        if any(x.z == z and not x.arom for x, o in single):
            return t
    if any(o == 2 and x.z in (6, 7, 8) and not x.arom for x, o in nb):
        return 'C25'                          # exocyclic =[C,N,O] (aliphatic)
    return 'CS'


def _type_nitrogen(a: _Atom, atoms: List[_Atom]) -> str:
    nb = [(atoms[j], o) for j, o in a.nbrs]
    if a.q > 0:
        if a.arom:
            return 'N12'
        if a.h >= 1:
            return 'N10'                      # [NH3,NH2,NH;+,...]
        if any(o == 3 for _, o in nb):
            return 'N14'
        return 'N13'                          # quaternary / nitro N
    if a.q < 0:
        return 'N14'
    if a.arom:
        return 'N11'
    arom_nbr = any(x.arom for x, _ in nb)
    if a.h >= 2 and a.deg >= 1:
        return 'N3' if arom_nbr else 'N1'
    if a.h == 1 and a.deg == 2:
        return 'N4' if arom_nbr else 'N2'
    if any(o == 3 for _, o in nb):
        return 'N9'                           # [N+0]#[A;!#1]
    if any(o == 2 for _, o in nb):
        if a.h >= 1:
            return 'N5'                       # [NH+0]=A
        if a.deg >= 2:
            return 'N6'                       # [N+0](=A)A
        return 'NS'
    if a.h == 0 and a.deg == 3:
        return 'N8' if arom_nbr else 'N7'
    return 'NS'


def _type_oxygen(a: _Atom, atoms: List[_Atom]) -> str:
    nb = [(atoms[j], o) for j, o in a.nbrs]
    if a.arom:
        return 'O1'
    if a.q < 0:
        if any(x.z == 7 for x, _ in nb):
            return 'O5'                       # [OX1;-][#7] (nitro)
        if any(x.z == 16 for x, _ in nb):
            return 'O6'
        # O12: [O-]C(=O) carboxylate
        for x, _ in nb:
            if x.z == 6 and any(o == 2 and atoms[j].z == 8
                                for j, o in x.nbrs):
                return 'O12'
        return 'O7'
    if a.h >= 1:
        return 'O2'                           # [OH]
    dbl = [(x, o) for x, o in nb if o == 2]
    if dbl:
        x = dbl[0][0]
        if x.z in (7, 8):
            return 'O5'                       # [O]=[#7,#8]
        if x.z == 16:
            return 'O6'                       # [O]=[#16]
        if x.z == 6 and x.arom:
            return 'O8'                       # [O]=c
        if x.z == 6:
            # substituents of the carbonyl carbon other than this oxygen
            subs = [atoms[j] for j, _ in x.nbrs if atoms[j] is not a]
            if x.h >= 1 or not subs:
                # aldehyde/formaldehyde: O9 unless the substituent is
                # an aromatic carbon ([O]=[CH]c -> O10)
                if any(s.z == 6 and s.arom for s in subs):
                    return 'O10'
                return 'O9'
            if any(s.arom for s in subs) and any(s.z == 6 for s in subs):
                return 'O10'                  # aryl carbonyl
            if all(s.z != 6 for s in subs) and len(subs) >= 2:
                return 'O11'                  # [O]=C([!C])[!C]
            if any(s.z == 6 and not s.arom for s in subs):
                return 'O9'                   # [O]=C(C)[A]
        return 'OS'
    if a.deg == 2:
        if any(x.arom for x, _ in nb):
            return 'O4'                       # [O](a)[!#1]
        return 'O3'                           # aliphatic ether
    return 'OS'


def _type_h_on(a: _Atom, atoms: List[_Atom]) -> str:
    """Type of an implicit hydrogen attached to heavy atom ``a``."""
    if a.z == 6:
        return 'H1'
    if a.z == 7:
        return 'H3'
    if a.z == 8:
        heavies = [atoms[j] for j, _ in a.nbrs]
        for x in heavies:
            # H4: [#1]OC=[C,N,O,S] / [#1]O[O,S]
            if x.z in (8, 16):
                return 'H4'
            if x.z == 6 and any(o == 2 and atoms[j].z in (6, 7, 8, 16)
                                for j, o in x.nbrs):
                return 'H4'
        if any(x.z == 7 for x in heavies):
            return 'H3'                       # [#1]O[#7]
        for x in heavies:
            if x.z == 6 and (x.sp3 or x.arom):
                return 'H2'                   # [#1]O[CX4] / [#1]Oc
            if x.z not in (6, 7, 8, 16):
                return 'H2'                   # [#1]O[!C;!N;!O;!S]
        return 'HS'
    # [#1][!C;!N;!O] (e.g. S-H, P-H, B-H)
    return 'H2'


def crippen_atom_types(element, bonds: Dict[Bond, int], aromatic, h_counts,
                       charges: Optional[np.ndarray] = None) -> List[str]:
    """Published Wildman-Crippen type label per heavy atom."""
    atoms = _build(element, bonds, aromatic, h_counts, charges)
    out = []
    for a in atoms:
        if a.z == 6:
            out.append(_type_carbon(a, atoms))
        elif a.z == 7:
            out.append(_type_nitrogen(a, atoms))
        elif a.z == 8:
            out.append(_type_oxygen(a, atoms))
        elif a.z == 16:
            if a.arom:
                out.append('S3')
            elif a.q != 0 or any(o == 2 and atoms[j].z in (7, 8, 15, 16)
                                 for j, o in a.nbrs):
                out.append('S2')
            else:
                out.append('S1')
        elif a.z == 15:
            out.append('P')
        elif a.z in _HALOGENS:
            out.append('Hal' if a.q != 0 else _HALOGENS[a.z])
        elif a.z in _ME1:
            out.append('Me1')
        elif a.z in _ME2:
            out.append('Me2')
        else:
            out.append('')                    # unmatched: contributes 0.0
    return out


def crippen_logp_exact(element, bonds: Dict[Bond, int], aromatic, h_counts,
                       charges: Optional[np.ndarray] = None) -> float:
    """Crippen.MolLogP parity: heavy-atom contributions + one H contribution
    per implicit hydrogen, typed by its heavy neighbor."""
    atoms = _build(element, bonds, aromatic, h_counts, charges)
    types = crippen_atom_types(element, bonds, aromatic, h_counts, charges)
    total = 0.0
    for a, t in zip(atoms, types):
        total += CRIPPEN_LOGP.get(t, 0.0)
        if a.h > 0:
            total += a.h * CRIPPEN_LOGP[_type_h_on(a, atoms)]
    return float(total)
