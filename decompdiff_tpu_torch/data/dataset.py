"""Dataset layer (L1): serve the processed complex store (port of
decompdiff_tpu/data/dataset.py's `DecompDataset`, the LMDB-backed Dataset +
name-based split of ref datasets/pl_pair_dataset.py, get_decomp_dataset
:23-43).

Building a store from raw files or a reference LMDB needs RDKit, OpenBabel
or lmdb and waits for ROADMAP item E1.
"""

from __future__ import annotations

from typing import Dict, List

from decompdiff_tpu_torch.data.store import DDStore
from decompdiff_tpu_torch.data.transforms import featurize_sample


class DecompDataset:
    """Store + featurization + split (ref get_decomp_dataset :23-43)."""

    def __init__(self, store: DDStore, prior_mode: str = 'ref_prior',
                 ligand_atom_mode: str = 'basic', random_rot: bool = False,
                 ligand_bond_mode: str = 'fc', add_ord_feat: bool = False,
                 max_num_arms: int = 10):
        self.store = store
        self.prior_mode = prior_mode
        self.ligand_atom_mode = ligand_atom_mode
        self.random_rot = random_rot
        self.ligand_bond_mode = ligand_bond_mode
        self.add_ord_feat = add_ord_feat
        self.max_num_arms = max_num_arms

    def __len__(self):
        return len(self.store)

    def get_raw(self, idx: int) -> dict:
        return self.store[idx]

    def __getitem__(self, idx: int) -> dict:
        return featurize_sample(
            self.store[idx], prior_mode=self.prior_mode,
            ligand_atom_mode=self.ligand_atom_mode,
            ligand_bond_mode=self.ligand_bond_mode,
            add_ord_feat=self.add_ord_feat,
            max_num_arms=self.max_num_arms,
            random_rot=self.random_rot)

    def split_by_names(self, split: Dict[str, List[str]]) -> Dict[str, List[int]]:
        """name -> indices split (ref get_decomp_dataset :33-41 +
        _precompute_name2id :99-110): reference name2id keys are
        src_ligand_filename[:-4] and map to LISTS of ids (CrossDocked repeats
        ligand filenames across poses), and split entries are
        (protein_fn, ligand_fn) tuples matched on ligand_fn[:-4]. Store keys
        are matched both exactly and with a 4-char dot-extension stripped."""
        name2ids: Dict[str, List[int]] = {}
        for i, k in enumerate(self.store.keys):
            name2ids.setdefault(k, []).append(i)
            if len(k) > 4 and k[-4] == '.':
                name2ids.setdefault(k[:-4], []).append(i)
        out = {}
        for part, names in split.items():
            ids: List[int] = []
            for n in names:
                key = n[1][:-4] if isinstance(n, (tuple, list)) else n
                ids.extend(name2ids.get(key, []))
            out[part] = ids
        return out
