"""Atom/bond type vocabularies and feature dimensions (a copy of the
entries of decompdiff_tpu/constants.py that the port's model and host
pipeline read).

Behavioral parity with the reference featurization:
  * ligand atom-type index maps: reference utils/transforms.py:15-66
  * protein featurization (element one-hot + aa one-hot + backbone):
    reference utils/transforms.py:114-131
  * dataset marginals used for terminal categorical priors:
    reference utils/transforms.py:142-143
"""

import numpy as np

# --- ligand atom types ------------------------------------------------------
# mode 'basic': 8 element classes (ref utils/transforms.py:41-50)
ATOM_TYPES_BASIC = (1, 6, 7, 8, 9, 15, 16, 17)  # H C N O F P S Cl
MAP_ATOM_BASIC = {z: i for i, z in enumerate(ATOM_TYPES_BASIC)}

# mode 'add_aromatic': 13 (element, is_aromatic) classes (ref utils/transforms.py:52-66)
ATOM_TYPES_AROMATIC = (
    (1, False),
    (6, False), (6, True),
    (7, False), (7, True),
    (8, False), (8, True),
    (9, False),
    (15, False), (15, True),
    (16, False), (16, True),
    (17, False),
)
MAP_ATOM_AROMATIC = {k: i for i, k in enumerate(ATOM_TYPES_AROMATIC)}

# mode 'full': 23 (element, hybridization, is_aromatic) classes
# (ref utils/transforms.py:15-39)
ATOM_TYPES_FULL = (
    (1, 'S', False),
    (6, 'SP', False), (6, 'SP2', False), (6, 'SP2', True), (6, 'SP3', False),
    (7, 'SP', False), (7, 'SP2', False), (7, 'SP2', True), (7, 'SP3', False),
    (8, 'SP2', False), (8, 'SP2', True), (8, 'SP3', False),
    (9, 'SP3', False),
    (15, 'SP2', False), (15, 'SP2', True), (15, 'SP3', False), (15, 'SP3D', False),
    (16, 'SP2', False), (16, 'SP2', True), (16, 'SP3', False), (16, 'SP3D', False),
    (16, 'SP3D2', False),
    (17, 'SP3', False),
)
MAP_ATOM_FULL = {k: i for i, k in enumerate(ATOM_TYPES_FULL)}

NUM_ATOM_CLASSES = {'basic': 8, 'add_aromatic': 13, 'full': 23}


def atom_class_count(mode: str) -> int:
    return NUM_ATOM_CLASSES[mode]


def atomic_numbers_from_index(index, mode: str):
    """Map predicted class indices back to atomic numbers (ref utils/transforms.py:73-82)."""
    index = np.asarray(index)
    if mode == 'basic':
        table = np.array(ATOM_TYPES_BASIC)
        return table[index]
    elif mode == 'add_aromatic':
        table = np.array([z for z, _ in ATOM_TYPES_AROMATIC])
        return table[index]
    elif mode == 'full':
        table = np.array([z for z, _, _ in ATOM_TYPES_FULL])
        return table[index]
    raise ValueError(mode)


def is_aromatic_from_index(index, mode: str):
    """Ref utils/transforms.py:85-94 (mode 'basic' has no aromatic channel)."""
    index = np.asarray(index)
    if mode == 'basic':
        return None
    elif mode == 'add_aromatic':
        table = np.array([a for _, a in ATOM_TYPES_AROMATIC])
        return table[index]
    elif mode == 'full':
        table = np.array([a for _, _, a in ATOM_TYPES_FULL])
        return table[index]
    raise ValueError(mode)


def hybridization_from_index(index, mode: str):
    """Hybridization strings for predicted class indices; only mode 'full'
    carries the channel (ref utils/transforms.py:97-102 — whose body
    indexes the aromatic table and returns its bool column, apparently
    dead/buggy and never called; this returns the full-mode table's actual
    hybridization column)."""
    if mode != 'full':
        raise ValueError(mode)
    index = np.asarray(index)
    table = np.array([h for _, h, _ in ATOM_TYPES_FULL])
    return table[index]


def atom_index(atomic_num: int, hybridization: str, is_aromatic: bool, mode: str) -> int:
    """Ref utils/transforms.py:105-111."""
    if mode == 'basic':
        return MAP_ATOM_BASIC[int(atomic_num)]
    elif mode == 'add_aromatic':
        return MAP_ATOM_AROMATIC[(int(atomic_num), bool(is_aromatic))]
    return MAP_ATOM_FULL[(int(atomic_num), str(hybridization), bool(is_aromatic))]


# --- protein featurization --------------------------------------------------
# elements one-hot over {H, C, N, O, S, Se} (ref utils/transforms.py:118)
PROTEIN_ATOM_ELEMENTS = (1, 6, 7, 8, 16, 34)
NUM_AA_TYPES = 20
PROTEIN_FEATURE_DIM = len(PROTEIN_ATOM_ELEMENTS) + NUM_AA_TYPES + 1  # 27

# 3-letter amino acid code -> index 0..19. Ordering matches the reference
# parser's AA_NAME_SYM insertion order exactly (ref utils/data.py:47-55) so
# one-hot aa features are bit-identical.
AA_NAME_TO_INDEX = {
    'ALA': 0, 'CYS': 1, 'ASP': 2, 'GLU': 3, 'PHE': 4, 'GLY': 5, 'HIS': 6,
    'ILE': 7, 'LYS': 8, 'LEU': 9, 'MET': 10, 'ASN': 11, 'PRO': 12, 'GLN': 13,
    'ARG': 14, 'SER': 15, 'THR': 16, 'VAL': 17, 'TRP': 18, 'TYR': 19,
}
BACKBONE_ATOM_NAMES = ("CA", "C", "N", "O")  # ref utils/data.py:57

# CrossDocked training-set marginals used as terminal distributions when
# `prior_types` featurization is enabled (ref utils/transforms.py:142-143).
ATOM_TYPES_PROB_BASIC = np.array(
    [0.0, 0.6716, 0.1174, 0.1689, 0.01315, 0.01117, 0.01128, 0.00647])
BOND_TYPES_PROB = np.array([0.9170, 0.0433, 0.00687, 0.000173, 0.03266])

# element symbol -> atomic number (used by the pure-python PDB/SDF parsers)
ELEMENT_SYMBOLS = {
    'H': 1, 'HE': 2, 'LI': 3, 'BE': 4, 'B': 5, 'C': 6, 'N': 7, 'O': 8,
    'F': 9, 'NE': 10, 'NA': 11, 'MG': 12, 'AL': 13, 'SI': 14, 'P': 15,
    'S': 16, 'CL': 17, 'AR': 18, 'K': 19, 'CA': 20, 'MN': 25, 'FE': 26,
    'CO': 27, 'NI': 28, 'CU': 29, 'ZN': 30, 'SE': 34, 'BR': 35, 'I': 53,
}
ATOMIC_NUM_TO_SYMBOL = {
    1: 'H', 5: 'B', 6: 'C', 7: 'N', 8: 'O', 9: 'F', 14: 'Si', 15: 'P',
    16: 'S', 17: 'Cl', 34: 'Se', 35: 'Br', 53: 'I',
}

# covalent radii (Å) for distance-based bond perception in the host
# reconstruction fallback (OpenBabel-equivalent role; values are the standard
# Cordero radii, role parity with ref utils/reconstruct.py:76-193).
COVALENT_RADII = {
    1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 14: 1.11,
    15: 1.07, 16: 1.05, 17: 1.02, 34: 1.20, 35: 1.20, 53: 1.39,
}

# maximum valences for reconstruction repair (role parity with
# ref utils/reconstruct.py fix_valence)
MAX_VALENCE = {1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 14: 4, 15: 5, 16: 6,
               17: 1, 34: 2, 35: 1, 53: 1}
