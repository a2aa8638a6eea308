"""Subcomplex extraction driver (L0; port of
decompdiff_tpu/preprocess/subcomplex.py).

Behavioral parity with ref scripts/data_preparation/preprocess_subcomplex.py:
AlphaSpace2 snapshot over receptor+binder -> contact pockets sorted by
nonpolar space -> BRICS decomposition -> fragment->pocket assignment ->
arm/scaffold split -> pocket residue extraction -> per-pair meta dict.

AlphaSpace2/mdtraj/RDKit are gated imports (absent in this image); the
geometric stages accept precomputed pocket alpha centers so the pipeline is
testable without them.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from decompdiff_tpu_torch.data.protein import PDBProtein
from decompdiff_tpu_torch.preprocess.decompose import (
    DecomposeError, extract_submols)
from scipy.spatial import distance_matrix


def extract_subpockets(protein: PDBProtein, centers, radius: float = 10.0):
    """Pocket residues within `radius` of the given centers
    (ref utils/preprocess.py:284-323, method 'v2'/'submol_radius')."""
    return protein.query_residues_centers(centers, radius)


def union_pocket_residues(all_pocket_residues):
    """ref utils/preprocess.py:326-335."""
    selected, seen = [], set()
    for pocket_r in all_pocket_residues:
        for r in pocket_r:
            if r['chain_res_id'] not in seen:
                selected.append(r)
                seen.add(r['chain_res_id'])
    return selected


def mark_in_range(query_points, ref_points, cutoff: float = 1.6):
    """ref utils/preprocess.py:338-343."""
    query_points = np.asarray(query_points).reshape(-1, 3)
    ref_points = np.asarray(ref_points).reshape(-1, 3)
    idx = np.unique(np.where(
        distance_matrix(query_points, ref_points) <= cutoff)[0])
    out = np.zeros(len(query_points), bool)
    out[idx] = True
    return out


def ligand_to_pdb_block(mol) -> str:
    """Minimal HETATM PDB block for a parsed ligand (element + coords +
    CONECT), enough for mdtraj.load — the reference converts the SDF to PDB
    before mdtraj (ref preprocess_subcomplex.py:81, convert_sdf_to_pdb via
    openbabel), since mdtraj cannot parse SDF."""
    from decompdiff_tpu_torch.constants import ATOMIC_NUM_TO_SYMBOL
    lines = []
    for i in range(mol.num_atoms):
        sym = ATOMIC_NUM_TO_SYMBOL.get(int(mol.element[i]), 'C')
        x, y, z = (float(v) for v in mol.pos[i])
        name = f'{sym}{i + 1}'[:4]
        lines.append(
            f'HETATM{i + 1:5d} {name:<4s} LIG A   1    '
            f'{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {sym:>2s}')
    seen = set()
    for e in range(mol.bond_index.shape[1]):
        a, b = int(mol.bond_index[0, e]), int(mol.bond_index[1, e])
        if (min(a, b), max(a, b)) in seen:
            continue
        seen.add((min(a, b), max(a, b)))
        lines.append(f'CONECT{a + 1:5d}{b + 1:5d}')
    lines.append('END')
    return '\n'.join(lines) + '\n'


def run_alphaspace(protein_path: str, ligand_path: str, top_n: int = 10):
    """Contact pockets from an AlphaSpace2 snapshot, sorted by nonpolar space
    (ref preprocess_subcomplex.py:71-97). Requires alphaspace2 + mdtraj.
    The ligand SDF is converted to a temporary PDB first — mdtraj cannot
    parse SDF (ref :81 does the same via openbabel)."""
    import tempfile

    import alphaspace2 as al
    import mdtraj

    from decompdiff_tpu_torch.data.mol import parse_sdf_file

    receptor = mdtraj.load(protein_path)
    if ligand_path.endswith(('.sdf', '.sdf.gz')):
        mol = parse_sdf_file(ligand_path)
        with tempfile.NamedTemporaryFile('w', suffix='.pdb',
                                         delete=False) as f:
            f.write(ligand_to_pdb_block(mol))
            tmp_pdb = f.name
        try:
            binder = mdtraj.load(tmp_pdb)
        finally:
            os.unlink(tmp_pdb)
    else:
        binder = mdtraj.load(ligand_path)
    ss = al.Snapshot()
    ss.run(receptor=receptor, binder=binder)
    pockets = [p for p in ss.pockets if p.isContact]
    pockets.sort(key=lambda p: p.nonpolar_space, reverse=True)
    return pockets[:top_n], receptor


def run_alphaspace_first_party(protein_path: str, ligand_path: str,
                               top_n: int = 10):
    """Contact pockets via the first-party alpha-sphere finder
    (preprocess/alphaspace.py) — same contract as run_alphaspace but with
    no alphaspace2/mdtraj dependency. Returns (pockets, protein)."""
    from decompdiff_tpu_torch.data.mol import parse_sdf_file
    from decompdiff_tpu_torch.preprocess.alphaspace import find_pockets

    protein = PDBProtein(protein_path)
    mol = parse_sdf_file(ligand_path)
    pockets = find_pockets(
        np.asarray(protein.pos, np.float64).reshape(-1, 3),
        receptor_element=np.asarray(protein.element),
        binder_pos=np.asarray(mol.pos, np.float64))
    return pockets[:top_n], protein


def extract_subcomplex(protein_path: str, ligand_sdf_path: str,
                       mol=None, pocket_alpha_centers=None,
                       submol_radius: float = 10.0,
                       out_dir: Optional[str] = None,
                       name: str = 'subcomplex') -> dict:
    """One protein-ligand pair -> decomposition meta dict
    (ref preprocess_subcomplex.py:71-213).

    Either pass a `mol` (RDKit Mol or first-party MolRecord) +
    `pocket_alpha_centers` (testable path), or let the driver derive both:
    the ligand via RDKit when installed else data/mol.py, pockets via
    alphaspace2 when installed else the first-party alpha-sphere finder
    (preprocess/alphaspace.py). The RDKit-free path fragments with bond
    cuts instead of BRICS (see decompose.bond_cut_fragments divergence
    note).
    """
    if mol is None:
        try:
            from rdkit import Chem
        except ImportError:
            from decompdiff_tpu_torch.data.mol import parse_sdf_file
            try:
                mol = parse_sdf_file(ligand_sdf_path)
            except Exception as e:
                # keep the CLI's error taxonomy: a malformed SDF buckets
                # as decompose_error on both parse paths
                raise DecomposeError(
                    f'cannot parse {ligand_sdf_path}: {e}') from e
        else:
            mol = Chem.MolFromMolFile(ligand_sdf_path)
            if mol is None:
                raise DecomposeError(f'cannot parse {ligand_sdf_path}')
    protein = PDBProtein(protein_path)
    is_record = hasattr(mol, 'bond_index')  # first-party MolRecord
    pos = (np.asarray(mol.pos, np.float64) if is_record
           else mol.GetConformer().GetPositions())
    if pocket_alpha_centers is None:
        try:
            pockets, _ = run_alphaspace(protein_path, ligand_sdf_path)
        except ImportError:
            # first-party finder, reusing the already-parsed protein/mol
            # (run_alphaspace_first_party would re-parse both files)
            from decompdiff_tpu_torch.preprocess.alphaspace import find_pockets
            pockets = find_pockets(
                np.asarray(protein.pos, np.float64).reshape(-1, 3),
                receptor_element=np.asarray(protein.element),
                binder_pos=pos)[:10]
        if len(pockets) == 0:
            raise DecomposeError('no contact pockets found')
        pocket_alpha_centers = [
            np.stack([a.centroid for a in p.alphas]) for p in pockets]
    if is_record:
        from decompdiff_tpu_torch.preprocess.decompose import (
            extract_submols_record)
        centroids, assignment, all_submol_atom_idx, valid_pocket_id = \
            extract_submols_record(mol, pocket_alpha_centers)
    else:
        centroids, assignment, all_submol_atom_idx, valid_pocket_id = \
            extract_submols(mol, pocket_alpha_centers)

    num_arms = len(all_submol_atom_idx) - 1
    num_scaffold = 1 if len(all_submol_atom_idx[-1]) > 0 else 0
    if num_scaffold == 0:
        all_submol_atom_idx = all_submol_atom_idx[:-1] + [[]]
        num_scaffold = 1  # keep the scaffold slot (may be empty)

    # per-arm pocket residues within submol_radius of the arm atoms (:128-137)
    all_pocket_atom_serial, all_pocket_residues = [], []
    for arm_atoms in all_submol_atom_idx[:-1]:
        serial, residues = extract_subpockets(
            protein, pos[arm_atoms], radius=submol_radius)
        all_pocket_atom_serial.append(serial)
        all_pocket_residues.append(residues)

    union_residues = union_pocket_residues(all_pocket_residues)

    meta = {
        'protein_file': protein_path,
        'ligand_file': ligand_sdf_path,
        'num_arms': num_arms,
        'num_scaffold': num_scaffold,
        'all_submol_atom_idx': all_submol_atom_idx,
        'all_pocket_atom_serial': all_pocket_atom_serial,
        'frag_centroids': centroids,
        'assignment': assignment,
        'valid_pocket_id': valid_pocket_id,
    }

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        pocket_pdb = os.path.join(out_dir, f'{name}_pocket.pdb')
        with open(pocket_pdb, 'w') as f:
            f.write(protein.residues_to_pdb_block(union_residues))
        # downstream dataset contract (ref preprocess_subcomplex.py:202,
        # consumed at ref pl_pair_dataset.py:128-132 /
        # data/dataset.py build_store_from_index): `protein_file` is the
        # UNION POCKET pdb and `meta_file` points at this pickle; the full
        # receptor path moves to `src_protein_file`
        meta['src_protein_file'] = protein_path
        meta['protein_file'] = pocket_pdb
        meta['pocket_file'] = pocket_pdb
        meta['meta_file'] = os.path.join(out_dir, f'{name}_meta.pkl')
        for i, residues in enumerate(all_pocket_residues):
            p = os.path.join(out_dir, f'{name}_pocket_arm{i}.pdb')
            with open(p, 'w') as f:
                f.write(protein.residues_to_pdb_block(residues,
                                                      name=f'POCKET_{i}'))
        with open(meta['meta_file'], 'wb') as f:
            pickle.dump({'data': meta}, f)
    return meta


# ---------------------------------------------------------------------------
# raw-dataset index parsers (CLI input adapters)
# ---------------------------------------------------------------------------

KMAP = {'Ki': 1, 'Kd': 2, 'IC50': 3}  # ref preprocess_subcomplex.py:19


def parse_pdbbind_index_file(raw_path: str, subset: str = 'refined'):
    """PDBBind >= 2016 index -> list of pair dicts
    (ref scripts/data_preparation/preprocess_subcomplex.py:22-53). Entries
    carry the reference's keys (src_protein_filename/src_ligand_filename,
    resolution, pka, pkd_type); paths are relative to the subset dir."""
    import os
    version = int(raw_path.rstrip('/')[-4:])
    assert version >= 2016, 'PDBBind index layout known for >= 2016'
    if subset == 'refined':
        data_path = os.path.join(raw_path, 'refined-set')
        index_path = os.path.join(data_path, 'index',
                                  f'INDEX_refined_data.{version}')
    elif subset == 'general':
        data_path = os.path.join(raw_path, 'general-set-except-refined')
        index_path = os.path.join(
            data_path, 'index', f'INDEX_general_PL_data.{version}')
    else:
        raise ValueError(subset)
    all_files = set(os.listdir(data_path))
    all_index = []
    with open(index_path) as f:
        for line in f:
            if line.startswith('#'):
                continue
            idx, res, _year, pka, kv = line.split('//')[0].strip().split()
            kind = [v for k, v in KMAP.items() if k in kv]
            assert len(kind) == 1
            if idx in all_files:
                all_index.append({
                    'pdb_index': idx,
                    'src_protein_filename':
                        os.path.join(idx, f'{idx}_protein.pdb'),
                    'src_ligand_filename':
                        os.path.join(idx, f'{idx}_ligand.sdf'),
                    'resolution': res,
                    'pka': pka,
                    'pkd_type': kind[0],
                })
    return sorted(all_index, key=lambda x: x['pdb_index'])


def parse_crossdocked_index_file(split_fn: str):
    """CrossDocked split file -> list of pair dicts
    (ref preprocess_subcomplex.py:56-67). Accepts the reference's
    torch-saved split (split_by_name.pt; needs torch) or a pickled dict of
    the same {split: [(protein_fn, ligand_fn), ...]} structure. The
    protein filename is truncated to its 10-char pocket stem + '.pdb',
    exactly like the reference."""
    import os
    import pickle as _pickle
    try:
        import torch
        split_index = torch.load(split_fn, weights_only=False)
    except Exception:
        with open(split_fn, 'rb') as f:
            split_index = _pickle.load(f)
    all_index = []
    for v in split_index.values():
        for protein_fn, ligand_fn in v:
            protein_fn = os.path.join(
                os.path.dirname(protein_fn),
                os.path.basename(protein_fn)[:10] + '.pdb')
            all_index.append({'src_protein_filename': protein_fn,
                              'src_ligand_filename': ligand_fn})
    return all_index
