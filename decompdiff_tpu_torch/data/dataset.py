"""Dataset layer (L1): build/serve the processed complex store (port of
decompdiff_tpu/data/dataset.py).

Role parity with ref datasets/pl_pair_dataset.py:
  * `build_store_from_index`  <- DecompPLPairDataset._process (:112-222,
    mode 'full'): parse pocket PDB + ligand SDF per index entry, build
    pocket_atom_masks (bool per arm x protein atoms) and ligand_atom_mask
    (per-atom arm id, scaffold = -1), bake in the golden prior.
  * `import_reference_lmdb`   <- converts an already-processed reference LMDB
    into a DDStore (gated on the lmdb package).
  * `DecompDataset`           <- LMDB-backed Dataset + name-based split
    (ref get_decomp_dataset :23-43).

Records are plain numpy dicts (the contract documented in
decompdiff_tpu_torch/data/transforms.featurize_sample).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from decompdiff_tpu_torch.data.mol import parse_sdf_file
from decompdiff_tpu_torch.data.protein import PDBProtein
from decompdiff_tpu_torch.data.store import DDStore, DDStoreWriter
from decompdiff_tpu_torch.data.transforms import featurize_sample
from decompdiff_tpu_torch.priors.golden import compute_golden_prior


def make_raw_record(protein_file: str, ligand_file: str,
                    all_pocket_atom_serial: List[List[int]],
                    all_submol_atom_idx: List[List[int]],
                    num_arms: int, num_scaffold: int,
                    src_protein_filename: str = '',
                    src_ligand_filename: str = '') -> dict:
    """One processed complex record (ref _process mode 'full', :130-170)."""
    protein = PDBProtein(protein_file)
    pdict = protein.to_dict_atom()
    mol = parse_sdf_file(ligand_file)
    n_prot, n_lig = len(pdict['element']), mol.num_atoms
    assert n_lig == sum(len(x) for x in all_submol_atom_idx)

    serial_to_idx = {a['atom_id']: i for i, a in enumerate(protein.atoms)}
    pocket_atom_masks = np.zeros((num_arms, n_prot), bool)
    assert len(all_pocket_atom_serial) == num_arms
    for arm_i, serials in enumerate(all_pocket_atom_serial):
        for s in serials:
            pocket_atom_masks[arm_i, serial_to_idx[s]] = True

    ligand_atom_mask = np.zeros(n_lig, np.int64)
    for arm_idx, atom_idx in enumerate(all_submol_atom_idx):
        if arm_idx == len(all_submol_atom_idx) - 1:
            ligand_atom_mask[atom_idx] = -1  # scaffold is last
        else:
            ligand_atom_mask[atom_idx] = arm_idx
    assert len(np.unique(ligand_atom_mask)) == num_arms + num_scaffold

    record = {
        'protein_pos': pdict['pos'],
        'protein_element': pdict['element'],
        'protein_atom_to_aa_type': pdict['atom_to_aa_type'],
        'protein_is_backbone': pdict['is_backbone'],
        'ligand_pos': mol.pos,
        'ligand_element': mol.element,
        'ligand_bond_index': mol.bond_index,
        'ligand_bond_type': mol.bond_type,
        'ligand_atom_is_aromatic': mol.aromatic,
        'ligand_hybridization': mol.hybridization,
        'ligand_atom_mask': ligand_atom_mask,
        'pocket_atom_masks': pocket_atom_masks,
        'num_arms': num_arms,
        'num_scaffold': num_scaffold,
        'src_protein_filename': src_protein_filename,
        'src_ligand_filename': src_ligand_filename,
    }
    arms_prior, scaffold_prior, pocket_prior_masks = compute_golden_prior(
        mol.pos, ligand_atom_mask, pdict['pos'], num_arms)
    record['arms_prior'] = arms_prior
    record['scaffold_prior'] = scaffold_prior
    record['pocket_prior_masks'] = pocket_prior_masks
    return record


def build_store_from_index(raw_path: str, out_path: str,
                           limit: Optional[int] = None) -> DDStore:
    """Read index.pkl + per-pair *_meta.pkl (the L0 output contract) and write
    a DDStore (ref _process :112-222)."""
    with open(os.path.join(raw_path, 'index.pkl'), 'rb') as f:
        index = pickle.load(f)
    num_skipped = 0
    with DDStoreWriter(out_path, meta={'source': raw_path}) as w:
        for i, meta_info in enumerate(index):
            if limit is not None and len(w._keys) >= limit:
                break
            try:
                with open(meta_info['data']['meta_file'], 'rb') as f:
                    m = pickle.load(f)['data']
                record = make_raw_record(
                    m['protein_file'], m['ligand_file'],
                    m['all_pocket_atom_serial'], m['all_submol_atom_idx'],
                    m['num_arms'], m['num_scaffold'],
                    meta_info.get('src_protein_filename', ''),
                    meta_info.get('src_ligand_filename', ''))
                w.append(record['src_ligand_filename'] or f'{i:08d}', record)
            except Exception as e:  # error-bucket robustness (ref :218-222)
                num_skipped += 1
                print(f'Skipping ({num_skipped}) '
                      f'{meta_info.get("src_ligand_filename", i)}: {e}')
    return DDStore(out_path)


def import_reference_lmdb(lmdb_path: str, out_path: str,
                          limit: Optional[int] = None) -> DDStore:
    """Convert a reference-processed LMDB into a DDStore (requires lmdb)."""
    import lmdb  # gated: not available in all environments

    env = lmdb.open(lmdb_path, map_size=10 * 1024 ** 3, create=False,
                    subdir=False, readonly=True, lock=False)
    with DDStoreWriter(out_path, meta={'source': lmdb_path}) as w, \
            env.begin() as txn:
        for key, value in txn.cursor():
            if limit is not None and len(w._keys) >= limit:
                break
            d = pickle.loads(value)
            record = _record_from_reference_dict(d)
            w.append(record.get('src_ligand_filename', key.decode()), record)
    env.close()
    return DDStore(out_path)


def _to_np(v):
    if hasattr(v, 'numpy'):
        return v.numpy()
    return v


def _record_from_reference_dict(d: dict) -> dict:
    """Map a reference LMDB record (PyG-style dict with protein_*/ligand_*
    prefixed keys; ref utils/data.py:372-387) to the host record contract."""
    rec = {
        'protein_pos': np.asarray(_to_np(d['protein_pos']), np.float32),
        'protein_element': np.asarray(_to_np(d['protein_element']), np.int64),
        'protein_atom_to_aa_type': np.asarray(
            _to_np(d['protein_atom_to_aa_type']), np.int64),
        'protein_is_backbone': np.asarray(
            _to_np(d['protein_is_backbone']), bool),
        'ligand_pos': np.asarray(_to_np(d['ligand_pos']), np.float32),
        'ligand_element': np.asarray(_to_np(d['ligand_element']), np.int64),
        'ligand_bond_index': np.asarray(_to_np(d['ligand_bond_index']), np.int64),
        'ligand_bond_type': np.asarray(_to_np(d['ligand_bond_type']), np.int64),
        'ligand_atom_mask': np.asarray(_to_np(d['ligand_atom_mask']), np.int64),
        'pocket_atom_masks': np.asarray(_to_np(d['pocket_atom_masks']), bool),
        'num_arms': int(d['num_arms']),
        'num_scaffold': int(d['num_scaffold']),
        'src_protein_filename': d.get('src_protein_filename', ''),
        'src_ligand_filename': d.get('src_ligand_filename', ''),
    }
    if 'ligand_atom_feature' in d:
        # 8-family RDKit feature matrix; column 2 = Aromatic
        feat = np.asarray(_to_np(d['ligand_atom_feature']))
        rec['ligand_atom_is_aromatic'] = feat[:, 2].astype(bool)
    if 'ligand_hybridization' in d:
        rec['ligand_hybridization'] = d['ligand_hybridization']
    for k in ('arms_prior', 'scaffold_prior'):
        if k in d:
            rec[k] = [tuple(_to_np(x) if hasattr(x, 'numpy') else x
                            for x in entry) for entry in d[k]]
    if 'pocket_prior_masks' in d:
        rec['pocket_prior_masks'] = np.asarray(
            _to_np(d['pocket_prior_masks']), bool)
    if 'arms_prior' not in rec:
        arms, sca, masks = compute_golden_prior(
            rec['ligand_pos'], rec['ligand_atom_mask'], rec['protein_pos'],
            rec['num_arms'])
        rec['arms_prior'], rec['scaffold_prior'] = arms, sca
        rec['pocket_prior_masks'] = masks
    return rec


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
