from decompdiff_tpu_torch.evaluation.eval_bond_length import (
    bond_distances_from_mol, pair_distances_from_pos,
    get_bond_length_profile, get_pair_length_profile,
    eval_bond_length_profile, eval_pair_length_profile)
from decompdiff_tpu_torch.evaluation.eval_atom_type import (
    eval_atom_type_distribution)
