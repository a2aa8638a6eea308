"""Pure-python PDB pocket parser — no RDKit/OpenBabel dependency (port of
decompdiff_tpu/data/protein.py).

Behavioral parity with the reference's hand-rolled fixed-column parser
(ref utils/data.py:46-260 PDBProtein): same column slicing, same residue
bucketing by (chain, segment, res_id, insert_id), same backbone flags, same
AA index table (constants.AA_NAME_TO_INDEX matches ref AA_NAME_NUMBER), same
query/selection helpers. Differences: vectorized numpy queries instead of
O(m*n) python loops; atomic weights from a local table instead of RDKit's
periodic table.
"""

from __future__ import annotations

import numpy as np

from decompdiff_tpu_torch import native
from decompdiff_tpu_torch.constants import (
    AA_NAME_TO_INDEX, BACKBONE_ATOM_NAMES, ELEMENT_SYMBOLS)

# standard atomic weights for the residue center-of-mass computation
_ATOMIC_WEIGHT = {
    1: 1.008, 6: 12.011, 7: 14.007, 8: 15.999, 15: 30.974, 16: 32.06,
    34: 78.971,
}


class PDBProtein:
    """Parse a PDB block/file into atom + residue tables."""

    def __init__(self, data: str, mode: str = 'auto'):
        if (data[-4:].lower() == '.pdb' and mode == 'auto') or mode == 'path':
            with open(data) as f:
                self.block = f.read()
        else:
            self.block = data

        self.title = None
        self.atoms = []
        self.element = []
        self.atomic_weight = []
        self.pos = []
        self.atom_name = []
        self.is_backbone = []
        self.atom_to_aa_type = []
        self.residues = []
        self.amino_acid = []
        self.center_of_mass = []
        self.pos_CA, self.pos_C, self.pos_N, self.pos_O = [], [], [], []
        self._parse()

    def _enum_atom_lines(self):
        # the C fixed-column parser of native.py (csrc/ddnative.cpp: the
        # JAX package's parser, same slicing, same ENDMDL stop, buffers
        # sized from the block's lines); its offsets are bytes, so a
        # non-ASCII block takes the Python parser below, as in the JAX
        # package (counted in native.plain_calls)
        if not self.block.isascii():
            native.plain_calls['parse_pdb_atoms'] += 1
            yield from self._enum_atom_lines_plain()
            return
        for line in self.block.splitlines():
            if line[0:6].strip() == 'HEADER':
                yield {'type': 'HEADER', 'value': line[10:].strip()}
                break
            if line[0:6].strip() in ('ATOM', 'ENDMDL'):
                break  # HEADER only appears before coordinates
        parsed = native.parse_pdb_atoms_native(self.block)
        # Python ints and floats (of the float32 values) in one pass each
        serial, res_id, pos, off, ll = (
            parsed[k].tolist()
            for k in ('serial', 'res_id', 'pos', 'line_off', 'line_len'))
        for i in range(len(serial)):
            yield {
                'line': self.block[off[i]:off[i] + ll[i]],
                'type': 'ATOM',
                'atom_id': serial[i],
                'atom_name': parsed['atom_name'][i],
                'res_name': parsed['res_name'][i],
                'chain': parsed['chain'][i].strip(),
                'res_id': res_id[i],
                'res_insert_id': parsed['insert_id'][i].strip(),
                'x': pos[i][0],
                'y': pos[i][1],
                'z': pos[i][2],
                'segment': parsed['segment'][i],
                'element_symb': parsed['element'][i],
            }

    def _enum_atom_lines_plain(self):
        for line in self.block.splitlines():
            rec = line[0:6].strip()
            if rec == 'ATOM':
                element_symb = line[76:78].strip().capitalize()
                if not element_symb:
                    element_symb = line[13:14]
                yield {
                    'line': line,
                    'type': 'ATOM',
                    'atom_id': int(line[6:11]),
                    'atom_name': line[12:16].strip(),
                    'res_name': line[17:20].strip(),
                    'chain': line[21:22].strip(),
                    'res_id': int(line[22:26]),
                    'res_insert_id': line[26:27].strip(),
                    'x': float(line[30:38]),
                    'y': float(line[38:46]),
                    'z': float(line[46:54]),
                    'segment': line[72:76].strip(),
                    'element_symb': element_symb,
                }
            elif rec == 'HEADER':
                yield {'type': 'HEADER', 'value': line[10:].strip()}
            elif rec == 'ENDMDL':
                break  # some PDBs have more than one model

    def _parse(self):
        residues_tmp = {}
        for atom in self._enum_atom_lines():
            if atom['type'] == 'HEADER':
                self.title = atom['value'].lower()
                continue
            if atom['res_name'] not in AA_NAME_TO_INDEX:
                continue  # skip non-standard residues (reference would KeyError)
            self.atoms.append(atom)
            z = ELEMENT_SYMBOLS.get(atom['element_symb'].upper(), 0)
            next_ptr = len(self.element)
            self.element.append(z)
            self.atomic_weight.append(_ATOMIC_WEIGHT.get(z, float(2 * z)))
            self.pos.append(np.array([atom['x'], atom['y'], atom['z']],
                                     dtype=np.float32))
            self.atom_name.append(atom['atom_name'])
            self.is_backbone.append(atom['atom_name'] in BACKBONE_ATOM_NAMES)
            self.atom_to_aa_type.append(AA_NAME_TO_INDEX[atom['res_name']])
            key = '%s_%s_%d_%s' % (atom['chain'], atom['segment'],
                                   atom['res_id'], atom['res_insert_id'])
            if key not in residues_tmp:
                residues_tmp[key] = {
                    'name': atom['res_name'], 'atoms': [next_ptr],
                    'chain': atom['chain'], 'segment': atom['segment'],
                    'chain_res_id': key,
                }
            else:
                residues_tmp[key]['atoms'].append(next_ptr)

        self.residues = list(residues_tmp.values())
        for residue in self.residues:
            sum_pos = np.zeros(3, np.float64)
            sum_mass = 0.0
            for a in residue['atoms']:
                sum_pos += self.pos[a] * self.atomic_weight[a]
                sum_mass += self.atomic_weight[a]
                if self.atom_name[a] in BACKBONE_ATOM_NAMES:
                    residue['pos_%s' % self.atom_name[a]] = self.pos[a]
            residue['center_of_mass'] = (sum_pos / max(sum_mass, 1e-9)).astype(
                np.float32)

        for residue in self.residues:
            self.amino_acid.append(AA_NAME_TO_INDEX[residue['name']])
            self.center_of_mass.append(residue['center_of_mass'])
            for name in BACKBONE_ATOM_NAMES:
                getattr(self, 'pos_%s' % name).append(
                    residue.get('pos_%s' % name, residue['center_of_mass']))

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

    def to_dict_residue(self):
        return {
            'amino_acid': np.array(self.amino_acid, dtype=np.int64),
            'center_of_mass': np.array(self.center_of_mass, np.float32),
            'pos_CA': np.array(self.pos_CA, np.float32),
            'pos_C': np.array(self.pos_C, np.float32),
            'pos_N': np.array(self.pos_N, np.float32),
            'pos_O': np.array(self.pos_O, np.float32),
        }

    # --- pocket queries (ref utils/data.py:197-251), vectorized ---
    def _residue_centers(self, criterion='center_of_mass'):
        return np.stack([r[criterion] for r in self.residues]) \
            if self.residues else np.zeros((0, 3), np.float32)

    def query_residues_centers(self, centers, radius,
                               criterion='center_of_mass'):
        centers = np.asarray(centers, np.float32).reshape(-1, 3)
        rc = self._residue_centers(criterion)
        d = np.linalg.norm(rc[:, None] - centers[None], axis=-1)
        sel = np.where((d < radius).any(1))[0]
        selected_residues = [self.residues[i] for i in sel]
        serial = [self.atoms[a]['atom_id'] for r in selected_residues
                  for a in r['atoms']]
        return serial, selected_residues

    def query_residues_radius(self, center, radius,
                              criterion='center_of_mass'):
        _, res = self.query_residues_centers(
            np.asarray(center).reshape(1, 3), radius, criterion)
        return res

    def query_residues_ligand(self, ligand, radius,
                              criterion='center_of_mass'):
        centers = ligand['pos'] if isinstance(ligand, dict) else ligand
        _, res = self.query_residues_centers(centers, radius, criterion)
        return res

    def residues_to_pdb_block(self, residues, name='POCKET'):
        block = 'HEADER    %s\n' % name
        block += 'COMPND    %s\n' % name
        for residue in residues:
            for a in residue['atoms']:
                block += self.atoms[a]['line'] + '\n'
        block += 'END\n'
        return block
