"""Pure-python PDB parser — no RDKit/OpenBabel dependency (port of
decompdiff_tpu/data/protein.py's atom table: the full protein that clash
guidance sees).

Behavioral parity with the reference's hand-rolled fixed-column parser
(ref utils/data.py:46-196 PDBProtein): same column slicing, same backbone
flags, same AA index table (constants.AA_NAME_TO_INDEX matches ref
AA_NAME_NUMBER). The residue tables and pocket queries (residue
selection, PDB block writing) belong to preprocessing and wait for
ROADMAP item E1.
"""

from __future__ import annotations

import numpy as np

from decompdiff_tpu_torch import native
from decompdiff_tpu_torch.constants import (
    AA_NAME_TO_INDEX, BACKBONE_ATOM_NAMES, ELEMENT_SYMBOLS)


class PDBProtein:
    """Parse a PDB block/file into an atom table."""

    def __init__(self, data: str, mode: str = 'auto'):
        if (data[-4:].lower() == '.pdb' and mode == 'auto') or mode == 'path':
            with open(data) as f:
                self.block = f.read()
        else:
            self.block = data

        self.title = None
        self.atoms = []
        self.element = []
        self.pos = []
        self.atom_name = []
        self.is_backbone = []
        self.atom_to_aa_type = []
        self._parse()

    def _enum_atom_lines(self):
        # the fixed-column parser of native.py (the JAX package's C parser,
        # same slicing, same ENDMDL stop); HEADER appears before coordinates
        for line in self.block.splitlines():
            if line[0:6].strip() == 'HEADER':
                yield {'type': 'HEADER', 'value': line[10:].strip()}
                break
            if line[0:6].strip() in ('ATOM', 'ENDMDL'):
                break
        parsed = native.parse_pdb_atoms_native(self.block)
        pos = parsed['pos']
        off, ll = parsed['line_off'], parsed['line_len']
        for i in range(len(parsed['serial'])):
            yield {
                'line': self.block[int(off[i]):int(off[i]) + int(ll[i])],
                'type': 'ATOM',
                'atom_id': int(parsed['serial'][i]),
                'atom_name': parsed['atom_name'][i],
                'res_name': parsed['res_name'][i],
                'chain': parsed['chain'][i].strip(),
                'res_id': int(parsed['res_id'][i]),
                'res_insert_id': parsed['insert_id'][i].strip(),
                'x': float(pos[i, 0]),
                'y': float(pos[i, 1]),
                'z': float(pos[i, 2]),
                'segment': parsed['segment'][i],
                'element_symb': parsed['element'][i],
            }

    def _parse(self):
        for atom in self._enum_atom_lines():
            if atom['type'] == 'HEADER':
                self.title = atom['value'].lower()
                continue
            if atom['res_name'] not in AA_NAME_TO_INDEX:
                continue  # skip non-standard residues (reference would KeyError)
            self.atoms.append(atom)
            self.element.append(
                ELEMENT_SYMBOLS.get(atom['element_symb'].upper(), 0))
            self.pos.append(np.array([atom['x'], atom['y'], atom['z']],
                                     dtype=np.float32))
            self.atom_name.append(atom['atom_name'])
            self.is_backbone.append(atom['atom_name'] in BACKBONE_ATOM_NAMES)
            self.atom_to_aa_type.append(AA_NAME_TO_INDEX[atom['res_name']])

    # --- exports (ref utils/data.py:177-196) ---
    def to_dict_atom(self):
        return {
            'element': np.array(self.element, dtype=np.int64),
            'molecule_name': self.title,
            'pos': np.array(self.pos, dtype=np.float32).reshape(-1, 3),
            'is_backbone': np.array(self.is_backbone, dtype=bool),
            'atom_name': self.atom_name,
            'atom_to_aa_type': np.array(self.atom_to_aa_type, dtype=np.int64),
        }
