"""Pure-python SDF (MOL V2000) parsing/writing + a light molecule record
(port of decompdiff_tpu/data/mol.py).

Role parity with ref utils/data.py:281-358 (`parse_sdf_file`,
`process_from_mol`), with no RDKit dependency: the V2000 block is parsed
directly and the aromatic flag derived from type-4 bonds — sufficient for
the released `basic` and `add_aromatic` featurization modes. The parser
does NOT compute hybridization (MolRecord.hybridization stays None); the
`full` atom mode needs it, and it arrives through the reference-data
importers instead (`data/dataset.import_reference_lmdb` carries the meta
pickle's hybridization labels through to the record).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from decompdiff_tpu_torch.constants import ATOMIC_NUM_TO_SYMBOL, ELEMENT_SYMBOLS


@dataclass
class MolRecord:
    """Element numbers, coordinates, bonds, aromatic flags."""
    element: np.ndarray          # [N] int
    pos: np.ndarray              # [N, 3] float32
    bond_index: np.ndarray       # [2, E] int (directed, both ways)
    bond_type: np.ndarray        # [E] int (1/2/3/4=aromatic)
    aromatic: np.ndarray         # [N] bool
    hybridization: Optional[List[str]] = None
    name: str = ''
    charges: Optional[np.ndarray] = None
    props: dict = field(default_factory=dict)

    @property
    def num_atoms(self) -> int:
        return len(self.element)

    def center(self) -> np.ndarray:
        return self.pos.mean(0)

    def to_dict(self) -> dict:
        return {
            'element': self.element,
            'pos': self.pos,
            'bond_index': self.bond_index,
            'bond_type': self.bond_type,
            'atom_is_aromatic': self.aromatic,
            'hybridization': self.hybridization,
        }


def parse_mol_block(block: str) -> MolRecord:
    """Parse one MOL V2000 block (fixed columns per the CTfile spec)."""
    lines = block.splitlines()
    if len(lines) < 4:
        raise ValueError('truncated mol block')
    name = lines[0].strip()
    counts = lines[3]
    n_atoms = int(counts[0:3])
    n_bonds = int(counts[3:6])

    element, pos, charges = [], [], []
    for i in range(n_atoms):
        ln = lines[4 + i]
        x, y, z = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
        symb = ln[31:34].strip().upper()
        element.append(ELEMENT_SYMBOLS.get(symb, 0))
        pos.append((x, y, z))
        charges.append(0)

    src, dst, btype = [], [], []
    for i in range(n_bonds):
        ln = lines[4 + n_atoms + i]
        a = int(ln[0:3]) - 1
        b = int(ln[3:6]) - 1
        t = int(ln[6:9])
        src += [a, b]
        dst += [b, a]
        btype += [t, t]

    element = np.array(element, np.int64)
    pos = np.array(pos, np.float32).reshape(-1, 3)
    bond_index = np.array([src, dst], np.int64).reshape(2, -1)
    bond_type = np.array(btype, np.int64)
    aromatic = np.zeros(n_atoms, bool)
    if len(bond_type):
        aromatic[np.unique(bond_index[:, bond_type == 4])] = True

    # M  CHG lines
    for ln in lines[4 + n_atoms + n_bonds:]:
        if ln.startswith('M  CHG'):
            fields = ln.split()
            n = int(fields[2])
            for k in range(n):
                idx = int(fields[3 + 2 * k]) - 1
                charges[idx] = int(fields[4 + 2 * k])
        if ln.startswith('M  END'):
            break

    return MolRecord(element=element, pos=pos, bond_index=bond_index,
                     bond_type=bond_type, aromatic=aromatic, name=name,
                     charges=np.array(charges, np.int64))


def parse_sdf_file(path: str, first_only: bool = True):
    """Parse an .sdf(.gz); returns a MolRecord (or list if first_only=False).
    Parity role: ref utils/data.py:344-358."""
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
        content = f.read()
    blocks = content.split('$$$$')
    records = []
    for b in blocks:
        b = b.strip('\n')
        if not b.strip():
            continue
        records.append(parse_mol_block(b + '\n'))
        if first_only:
            return records[0]
    if first_only:
        raise ValueError(f'no molecules in {path}')
    return records


def mol_to_sdf_block(mol: MolRecord, name: str = '') -> str:
    """Write a MolRecord back to a V2000 block (undirected bonds once)."""
    n = mol.num_atoms
    seen = set()
    bonds = []
    for e in range(mol.bond_index.shape[1]):
        a, b = int(mol.bond_index[0, e]), int(mol.bond_index[1, e])
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        bonds.append((a, b, int(mol.bond_type[e])))

    lines = [name or mol.name, '  decompdiff_tpu', '',
             f'{n:3d}{len(bonds):3d}  0  0  0  0  0  0  0  0999 V2000']
    for i in range(n):
        sym = ATOMIC_NUM_TO_SYMBOL.get(int(mol.element[i]), 'C')
        x, y, z = mol.pos[i]
        lines.append(f'{x:10.4f}{y:10.4f}{z:10.4f} {sym:<3s} 0  0  0  0  0  '
                     f'0  0  0  0  0  0  0')
    for a, b, t in bonds:
        lines.append(f'{a + 1:3d}{b + 1:3d}{t:3d}  0')
    if mol.charges is not None and (mol.charges != 0).any():
        idx = np.where(mol.charges != 0)[0]
        chg = 'M  CHG%3d' % len(idx)
        for i in idx:
            chg += '%4d%4d' % (i + 1, mol.charges[i])
        lines.append(chg)
    lines.append('M  END')
    lines.append('$$$$')
    return '\n'.join(lines) + '\n'
