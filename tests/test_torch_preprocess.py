"""The port's data preparation (decompdiff_tpu_torch/preprocess/, the
residue queries of data/protein.py, the store builders of data/dataset.py,
evaluation/eval_arms.py and the five scripts/*_torch.py data scripts)
against the JAX package on the CPU.

Inputs: the two-cavity lattice receptor and two-armed ligand of
tests/test_alphaspace.py (the port's copy in utils/testing.py, held equal
to the test's here), each pair moved by its own seeded rigid motion; the
reference-shaped meta tree and LMDB records of
tests/test_real_data_import.py; the cases of tests/test_preprocess.py.

Tolerance: exact. Both packages run the same host numpy and scipy code on
the same inputs, so arrays are compared with np.array_equal (dtype
included), dicts and lists element by element, files byte by byte; a
difference is a fault.
"""

import os
import pickle
import runpy
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from decompdiff_tpu.data import dataset as j_dataset
from decompdiff_tpu.data import mol as j_mol
from decompdiff_tpu.data.protein import PDBProtein as JPDBProtein
from decompdiff_tpu.evaluation import eval_arms as j_arms
from decompdiff_tpu.preprocess import alphaspace as j_als
from decompdiff_tpu.preprocess import decompose as j_dec
from decompdiff_tpu.preprocess import subcomplex as j_sub
from decompdiff_tpu_torch.data import dataset as p_dataset
from decompdiff_tpu_torch.data import mol as p_mol
from decompdiff_tpu_torch.data.protein import PDBProtein as PPDBProtein
from decompdiff_tpu_torch.evaluation import eval_arms as p_arms
from decompdiff_tpu_torch.preprocess import alphaspace as p_als
from decompdiff_tpu_torch.preprocess import decompose as p_dec
from decompdiff_tpu_torch.preprocess import subcomplex as p_sub
from decompdiff_tpu_torch.utils import testing as p_testing
from test_alphaspace import (
    DUMBBELL_LIGAND_SDF, _dumbbell_lattice, _lattice, _lattice_pdb_block)
from test_data_layer import PDB_BLOCK
from test_real_data_import import (
    _FakeEnv, _reference_lmdb_record, _write_reference_tree)

REPO = Path(__file__).resolve().parents[1]
PAIRS = 3           # raw pairs of the script cases (plus a missing receptor)


def assert_same(a, b, where='value'):
    """Exact recursive equality: dict keys and order, list and tuple
    lengths and types, arrays' dtype, shape and values."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f'{where}[{k!r}]')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{where}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), where
    else:
        assert a == b, (where, a, b)


def assert_same_store(jpath, ppath):
    from decompdiff_tpu.data.store import DDStore as JStore
    from decompdiff_tpu_torch.data.store import DDStore as PStore
    js, ps = JStore(str(jpath)), PStore(str(ppath))
    assert list(js.keys) == list(ps.keys)
    for i in range(len(js)):
        assert_same(js[i], ps[i], f'record {i}')


def _mol_pair(block):
    return j_mol.parse_mol_block(block), p_mol.parse_mol_block(block)


# --- the raw inputs: the port's copy of the lattice writers ---------------

def test_lattice_writers_equal_the_jax_tests():
    for half in (4, 5):
        assert np.array_equal(p_testing.dumbbell_lattice(half=half),
                              _dumbbell_lattice(half=half))
    pos = _dumbbell_lattice()
    elements = np.where(np.arange(len(pos)) % 5 == 0, 'O', 'C')
    assert (p_testing.lattice_pdb_block(pos, elements)
            == _lattice_pdb_block(pos, elements))
    assert p_testing.DUMBBELL_LIGAND_SDF == DUMBBELL_LIGAND_SDF


def test_write_raw_pairs_moves_each_pair_rigidly(tmp_path):
    index = p_testing.write_raw_pairs(str(tmp_path), 2, half=4, seed=3)
    assert [e['protein'] for e in index] == ['pair0/pair0_rec.pdb',
                                             'pair1/pair1_rec.pdb']
    ref = p_mol.parse_mol_block(DUMBBELL_LIGAND_SDF).pos.astype(np.float64)
    moved = [p_mol.parse_sdf_file(str(tmp_path / e['ligand'])).pos
             for e in index]
    for pos in moved:
        # pairwise distances survive the motion (to the file's 4 decimals)
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        d0 = np.linalg.norm(ref[:, None] - ref[None], axis=-1)
        assert np.abs(d - d0).max() < 1e-3
    assert np.abs(moved[0] - moved[1]).max() > 1.0
    prot = PPDBProtein(str(tmp_path / index[0]['protein']))
    assert len(prot.element) == len(_dumbbell_lattice(half=4))


# --- PDBProtein's residue tables and queries ------------------------------

def _protein_blocks():
    pos = _dumbbell_lattice(half=4)
    elements = np.where(np.arange(len(pos)) % 3 == 0, 'O', 'C')
    return {'small': PDB_BLOCK,
            'lattice': _lattice_pdb_block(pos, elements)}


@pytest.mark.parametrize('name', ['small', 'lattice'])
def test_protein_residues_and_queries(name):
    block = _protein_blocks()[name]
    jp, pp = JPDBProtein(block), PPDBProtein(block)
    assert_same(jp.residues, pp.residues, 'residues')
    assert_same(jp.to_dict_residue(), pp.to_dict_residue(), 'residue dict')
    assert_same(jp.to_dict_atom(), pp.to_dict_atom(), 'atom dict')
    assert_same(jp.atomic_weight, pp.atomic_weight, 'atomic weights')
    rng = np.random.default_rng(0)
    center = np.asarray(pp.pos).mean(0)
    for criterion in ('center_of_mass', 'pos_CA', 'pos_O'):
        if not all(criterion in r for r in pp.residues):
            # a residue without that atom: both raise the same KeyError
            for prot in (jp, pp):
                with pytest.raises(KeyError, match=criterion):
                    prot.query_residues_centers(center, 5.0, criterion)
            continue
        for radius in (2.0, 5.0, 9.0):
            centers = center + rng.normal(size=(3, 3)) * 3
            j_serial, j_res = jp.query_residues_centers(centers, radius,
                                                        criterion)
            p_serial, p_res = pp.query_residues_centers(centers, radius,
                                                        criterion)
            assert_same(j_serial, p_serial, 'serials')
            assert_same(j_res, p_res, 'selected residues')
            assert_same(jp.query_residues_radius(center, radius, criterion),
                        pp.query_residues_radius(center, radius, criterion))
            ligand = {'pos': centers}
            assert_same(jp.query_residues_ligand(ligand, radius, criterion),
                        pp.query_residues_ligand(ligand, radius, criterion))
            assert_same(jp.query_residues_ligand(centers, radius, criterion),
                        pp.query_residues_ligand(centers, radius, criterion))
            if j_res:
                assert (jp.residues_to_pdb_block(j_res, name='P1')
                        == pp.residues_to_pdb_block(p_res, name='P1'))
    assert (jp.residues_to_pdb_block(jp.residues)
            == pp.residues_to_pdb_block(pp.residues))


# --- decomposition --------------------------------------------------------

EXACT_COVER_CASES = [
    ([[(0, 1, 2), (3, 4, 5)], [(1, 2, 3)]], 6),
    ([[(0, 1), (2, 3)], [(0, 1), (2, 3)]], 4),
    ([[(0, 1), (4, 5)], [(2, 3)]], 6),
    ([[(0, 1)], [(1, 2)]], 3),
    ([[(0,), (1,), (2,), (3,)], [(0, 1), (2, 3)], [(4, 5)]], 6),
    ([[(0, 1, 2)], [(3, 4), (5, 6)], [(3, 4, 5, 6)]], 7),
]


@pytest.mark.parametrize('case', range(len(EXACT_COVER_CASES)))
def test_find_exact_cover(case):
    groups, n = EXACT_COVER_CASES[case]
    assert_same(j_dec.find_exact_cover(groups, n),
                p_dec.find_exact_cover(groups, n))


def test_fragment_topology():
    j, p = _mol_pair(DUMBBELL_LIGAND_SDF)
    j_pairs = j_dec.undirected_bond_pairs(j.bond_index, j.bond_type)
    p_pairs = p_dec.undirected_bond_pairs(p.bond_index, p.bond_type)
    assert_same(j_pairs, p_pairs)
    pairs, types_ = p_pairs
    assert_same(j_dec.ring_bond_flags(9, pairs),
                p_dec.ring_bond_flags(9, pairs))
    for bt in (types_, None, [2] * len(types_)):
        assert_same(j_dec.bond_cut_fragments(9, pairs, bt),
                    p_dec.bond_cut_fragments(9, pairs, bt))
    chain = [(0, 1), (1, 2), (2, 3), (3, 4)]
    for frag in ([0, 1], [4], [2], [0, 1, 2, 3, 4]):
        assert (j_dec.crossing_bonds(chain, frag)
                == p_dec.crossing_bonds(chain, frag))
        assert (j_dec.is_terminal_fragment(chain, frag)
                == p_dec.is_terminal_fragment(chain, frag))


ASSIGN_CASES = [
    # tests/test_preprocess.py's three assignments
    ([[0, 1], [2, 3], [4, 5]], [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)],
     [[0, 0, 0], [5, 0, 0], [10, 0, 0]], [[[0, 1, 0]], [[10, 1, 0]]]),
    ([[0], [1], [2]], [(0, 1), (1, 2)], [[0, 0, 0], [1, 0, 0], [8, 0, 0]],
     [[[0.5, 0, 0]], [[8, 0.5, 0]]]),
    ([[0, 1, 2]], [(0, 1), (1, 2)], [[0, 0, 0]],
     [[[0, 1, 0]], [[20, 0, 0]]]),
    # a five-fragment star with three pockets
    ([[0, 1], [2], [3, 4], [5], [6, 7]],
     [(0, 1), (1, 2), (2, 3), (3, 4), (2, 5), (5, 6), (6, 7)],
     [[-6, 0, 0], [-2, 0, 0], [0, 0, 0], [2, 1, 0], [6, 2, 0]],
     [[[-6, 1, 0], [-5, 0, 1]], [[6, 3, 0]], [[0, 9, 0]]]),
]


@pytest.mark.parametrize('case', range(len(ASSIGN_CASES)))
def test_assign_fragments(case):
    frags, bonds, centroids, pockets = ASSIGN_CASES[case]
    centroids = np.asarray(centroids, float)
    pockets = [np.asarray(p, float) for p in pockets]
    j_out = j_dec.assign_fragments(centroids, frags, bonds, pockets)
    p_out = p_dec.assign_fragments(centroids, frags, bonds, pockets)
    assert_same(j_out, p_out)
    assert_same(
        j_dec.split_by_assignment(j_out[0], frags, bonds, len(pockets)),
        p_dec.split_by_assignment(p_out[0], frags, bonds, len(pockets)))


@pytest.mark.parametrize('shift', [0.0, 2.5])
def test_extract_submols_record(shift):
    j, p = _mol_pair(DUMBBELL_LIGAND_SDF)
    pockets = [np.array([[-6.0 + shift, 0.5, 0.0], [-6.5, 0.0, 0.3]]),
               np.array([[6.0, 0.5 + shift, 0.0]])]
    assert_same(j_dec.extract_submols_record(j, pockets),
                p_dec.extract_submols_record(p, pockets))


def test_ligand_to_pdb_block():
    j, p = _mol_pair(DUMBBELL_LIGAND_SDF)
    assert j_sub.ligand_to_pdb_block(j) == p_sub.ligand_to_pdb_block(p)
    pts = np.random.default_rng(1).normal(size=(7, 3))
    ref = pts[:3] + 0.5
    for cutoff in (0.5, 1.6, 3.0):
        assert_same(j_sub.mark_in_range(pts, ref, cutoff),
                    p_sub.mark_in_range(pts, ref, cutoff))


# --- alpha-sphere pockets and eval_arms -----------------------------------

def _pocket_fields(pockets):
    return [dict(centers=p.alpha_centers, radii=p.alpha_radii,
                 space=p.alpha_space, nonpolar=p.alpha_nonpolar_space,
                 lining=p.alpha_lining, contact=p.contact_mask,
                 centroid=p.centroid, lining_idx=p.lining_atom_idx,
                 total=(p.space, p.nonpolar_space, p.isContact,
                        p.occupancy_nonpolar),
                 alphas=[(a.centroid, a.radius, a.space, a.nonpolar_space,
                          a.lining_atom_idx) for a in p.alphas])
            for p in pockets]


@pytest.mark.parametrize('receptor', ['cavity', 'dumbbell', 'moved'])
def test_find_pockets(receptor):
    mol = p_mol.parse_mol_block(DUMBBELL_LIGAND_SDF)
    if receptor == 'cavity':
        pos, binder = _lattice(), np.array([[0.0, 0.0, 0.0], [0, 0, 1.4]])
    else:
        pos, binder = _dumbbell_lattice(), mol.pos.astype(np.float64)
    if receptor == 'moved':
        rot, shift = p_testing.rigid_motion(np.random.default_rng(4))
        pos, binder = pos @ rot.T + shift, binder @ rot.T + shift
    elem = np.where(np.arange(len(pos)) % 4 == 0, 8, 6)
    for kw in ({}, {'receptor_element': elem},
               {'receptor_element': elem, 'binder_pos': binder},
               {'binder_pos': binder, 'contact_only': False}):
        jp, pp = j_als.find_pockets(pos, **kw), p_als.find_pockets(pos, **kw)
        assert len(jp) >= 1
        assert_same(_pocket_fields(jp), _pocket_fields(pp), str(kw))
        if 'binder_pos' in kw:
            for a, b in zip(jp, pp):
                assert (j_arms.compute_occupancy(a, binder)
                        == p_arms.compute_occupancy(b, binder))
                assert (j_arms.compute_polar_ratio(elem, a, mol.element)
                        == p_arms.compute_polar_ratio(elem, b, mol.element))


def test_alpha_sphere_helpers():
    pts = _lattice(half=3)
    assert_same(j_als.find_alpha_spheres(pts), p_als.find_alpha_spheres(pts))
    simplices = np.array([[0, 1, 2, 3], [1, 2, 3, 4], [0, 0, 1, 2]])
    assert_same(j_als.circumspheres(pts, simplices),
                p_als.circumspheres(pts, simplices))
    assert_same(j_als.tetra_volumes(pts, simplices),
                p_als.tetra_volumes(pts, simplices))
    rng = np.random.default_rng(0)
    centers = np.concatenate([rng.normal(0, 1.0, (30, 3)),
                              rng.normal(0, 1.0, (30, 3)) + 20.0])
    assert_same(j_als._cluster_alpha_centers(centers, 4.7),
                p_als._cluster_alpha_centers(centers, 4.7))
    with pytest.raises(ValueError):
        p_als.find_alpha_spheres(np.zeros((3, 3)))


def test_eval_arms_plain_fronts():
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(12, 3)) * 3
    space = rng.random(12)
    ligand = rng.normal(size=(5, 3)) * 3
    for cutoff in (1.6, 3.0):
        assert (j_arms.compute_occupancy_from_alphas(
                    centers, space, space.sum(), ligand, cutoff)
                == p_arms.compute_occupancy_from_alphas(
                    centers, space, space.sum(), ligand, cutoff))
    pocket = rng.choice([6, 7, 8, 16], size=20)
    for lig in ([6, 7, 8, 0, 0], [6, 6], []):
        assert (j_arms.compute_polar_ratio_from_elements(pocket, lig)
                == p_arms.compute_polar_ratio_from_elements(pocket, lig))
    assert p_arms.POLAR_ELEMENTS == j_arms.POLAR_ELEMENTS


# --- extract_subcomplex: meta dicts and pocket PDBs -----------------------

def _raw_pair(root, half, seed):
    """The (receptor PDB, ligand SDF) paths of one pair written by
    write_raw_pairs under root."""
    entry, = p_testing.write_raw_pairs(str(root), 1, half=half, seed=seed)
    return str(root / entry['protein']), str(root / entry['ligand'])


def _tree(root):
    """{relative path: bytes} of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob('*')) if p.is_file()}


@pytest.mark.parametrize('seed', [0, 1])
def test_extract_subcomplex(tmp_path, seed):
    pdb, sdf = _raw_pair(tmp_path, half=5, seed=seed)
    metas = {}
    for tag, sub in (('jax', j_sub), ('port', p_sub)):
        out = tmp_path / 'out'
        metas[tag] = sub.extract_subcomplex(pdb, sdf, out_dir=str(out),
                                            name='pair', submol_radius=8.0)
        os.rename(out, tmp_path / tag)
    assert metas['jax']['num_arms'] == 2
    assert_same(metas['jax'], metas['port'], 'meta')
    j_files, p_files = _tree(tmp_path / 'jax'), _tree(tmp_path / 'port')
    assert sorted(j_files) == sorted(p_files) == [
        'pair_meta.pkl', 'pair_pocket.pdb', 'pair_pocket_arm0.pdb',
        'pair_pocket_arm1.pdb']
    for name in j_files:
        if name.endswith('.pdb'):
            assert j_files[name] == p_files[name], name
    with open(tmp_path / 'jax' / 'pair_meta.pkl', 'rb') as f:
        j_meta = pickle.load(f)
    with open(tmp_path / 'port' / 'pair_meta.pkl', 'rb') as f:
        p_meta = pickle.load(f)
    assert_same(j_meta, p_meta, 'meta pickle')
    # the testable path: a given mol and given pocket centers
    centers = [np.asarray(metas['port']['frag_centroids'])[:1],
               np.asarray(metas['port']['frag_centroids'])[-1:]]
    j_mol_rec = j_mol.parse_sdf_file(sdf)
    p_mol_rec = p_mol.parse_sdf_file(sdf)
    assert_same(j_sub.extract_subcomplex(pdb, sdf, mol=j_mol_rec,
                                         pocket_alpha_centers=centers),
                p_sub.extract_subcomplex(pdb, sdf, mol=p_mol_rec,
                                         pocket_alpha_centers=centers))


def test_extract_subcomplex_error_taxonomy(tmp_path):
    pdb, sdf = _raw_pair(tmp_path, half=4, seed=0)
    (tmp_path / 'bad.sdf').write_text('not a molfile\n')
    for sub in (j_sub, p_sub):
        with pytest.raises(sub.DecomposeError, match='cannot parse'):
            sub.extract_subcomplex(pdb, str(tmp_path / 'bad.sdf'))
        with pytest.raises(FileNotFoundError):
            sub.extract_subcomplex(str(tmp_path / 'missing.pdb'), sdf)
    far = tmp_path / 'far.sdf'
    mol = p_mol.parse_mol_block(DUMBBELL_LIGAND_SDF)
    mol.pos = mol.pos + np.float32(500.0)
    far.write_text(p_mol.mol_to_sdf_block(mol))
    msgs = []
    for sub in (j_sub, p_sub):
        with pytest.raises(sub.DecomposeError) as err:
            sub.extract_subcomplex(pdb, str(far))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == 'no contact pockets found'


def test_run_alphaspace_gated_and_first_party(tmp_path, monkeypatch):
    pdb, sdf = _raw_pair(tmp_path, half=4, seed=2)
    monkeypatch.setitem(sys.modules, 'alphaspace2', None)
    for sub in (j_sub, p_sub):
        with pytest.raises(ImportError):
            sub.run_alphaspace(pdb, sdf)
    jp, jprot = j_sub.run_alphaspace_first_party(pdb, sdf)
    pp, pprot = p_sub.run_alphaspace_first_party(pdb, sdf)
    assert_same(_pocket_fields(jp), _pocket_fields(pp))
    assert_same(jprot.residues, pprot.residues)


def test_index_parsers(tmp_path):
    root = tmp_path / 'pdbbind_2020'
    data = root / 'refined-set'
    (data / 'index').mkdir(parents=True)
    for pdb in ('1abc', '2xyz'):
        (data / pdb).mkdir()
    (data / 'index' / 'INDEX_refined_data.2020').write_text(
        '# header comment\n'
        '1abc  1.80  2012  5.32  Kd=4.8uM     // 1abc.pdf (ligand)\n'
        '2xyz  2.10  2015  7.10  Ki=80nM      // 2xyz.pdf (ligand)\n'
        '9zzz  1.50  2018  6.00  IC50=1uM     // not on disk\n')
    assert_same(j_sub.parse_pdbbind_index_file(str(root)),
                p_sub.parse_pdbbind_index_file(str(root)))
    split = {'train': [('POCKET/recA_rec_0_pocket10.pdb',
                        'POCKET/recA_lig.sdf')],
             'test': [('P2/recB_rec_1_pocket10.pdb', 'P2/recB_lig.sdf')]}
    torch.save(split, str(tmp_path / 'split.pt'))
    with open(tmp_path / 'split.pkl', 'wb') as f:
        pickle.dump(split, f)
    for fn in ('split.pt', 'split.pkl'):
        assert_same(j_sub.parse_crossdocked_index_file(str(tmp_path / fn)),
                    p_sub.parse_crossdocked_index_file(str(tmp_path / fn)))
    assert p_sub.KMAP == j_sub.KMAP


# --- the store builders ---------------------------------------------------

def test_build_store_from_index_reference_tree(tmp_path):
    root = str(tmp_path / 'raw')
    _write_reference_tree(root, n_good=3, n_fail=1)
    for limit in (None, 2):
        j_dataset.build_store_from_index(root, str(tmp_path / 'j.ddstore'),
                                         limit=limit)
        p_dataset.build_store_from_index(root, str(tmp_path / 'p.ddstore'),
                                         limit=limit)
        assert_same_store(tmp_path / 'j.ddstore', tmp_path / 'p.ddstore')


def test_make_raw_record(tmp_path):
    pdb, sdf = _raw_pair(tmp_path, half=4, seed=5)
    meta = p_sub.extract_subcomplex(pdb, sdf)
    args = (pdb, sdf, meta['all_pocket_atom_serial'],
            meta['all_submol_atom_idx'], meta['num_arms'],
            meta['num_scaffold'], 'p.pdb', 'l.sdf')
    assert_same(j_dataset.make_raw_record(*args),
                p_dataset.make_raw_record(*args))


def test_import_reference_lmdb_mocked(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    records = [_reference_lmdb_record(rng) for _ in range(3)]
    # one record without a baked-in prior or aromatic features: the
    # importer computes the golden prior itself
    for k in ('arms_prior', 'scaffold_prior', 'pocket_prior_masks',
              'ligand_atom_feature', 'ligand_hybridization'):
        del records[2][k]
    items = [(f'{i:08d}'.encode(), pickle.dumps(r))
             for i, r in enumerate(records)]
    fake = types.ModuleType('lmdb')
    fake.open = lambda *a, **k: _FakeEnv(items)
    monkeypatch.setitem(sys.modules, 'lmdb', fake)
    for limit in (None, 2):
        j_dataset.import_reference_lmdb('/nonexistent.lmdb',
                                        str(tmp_path / 'j.ddstore'), limit)
        p_dataset.import_reference_lmdb('/nonexistent.lmdb',
                                        str(tmp_path / 'p.ddstore'), limit)
        assert_same_store(tmp_path / 'j.ddstore', tmp_path / 'p.ddstore')
    for r in records:
        assert_same(j_dataset._record_from_reference_dict(r),
                    p_dataset._record_from_reference_dict(r))


# --- the scripts ----------------------------------------------------------

def run_script(path, *argv):
    """scripts/<path> in this process, as `python scripts/<path> argv`."""
    saved = sys.argv
    sys.argv = [str(REPO / 'scripts' / path), *map(str, argv)]
    try:
        runpy.run_path(str(REPO / 'scripts' / path), run_name='__main__')
    finally:
        sys.argv = saved


@pytest.fixture(scope='module')
def prepared(tmp_path_factory):
    """PAIRS raw pairs (half-5 lattices, 1,300 atoms) and a missing
    receptor, decomposed by scripts/preprocess_subcomplex.py and then by
    the port's script into the same --dest (the JAX one's output moved to
    dest_jax in between), in one subprocess: the scripts fork their
    worker pools, which this process, holding JAX's threads, should not."""
    root = tmp_path_factory.mktemp('prep')
    index = p_testing.write_raw_pairs(str(root / 'raw'), PAIRS, half=5,
                                      seed=7)
    index.append({'protein': 'missing/missing_rec.pdb',
                  'ligand': index[0]['ligand']})
    with open(root / 'index.pkl', 'wb') as f:
        pickle.dump(index, f)
    code = (
        'import os, runpy, sys\n'
        f'root = {str(root)!r}\n'
        'for script, out in (("preprocess_subcomplex.py", "dest_jax"),\n'
        '                    ("preprocess_subcomplex_torch.py", None)):\n'
        '    sys.argv = [script, root + "/index.pkl", "--raw_root",\n'
        '                root + "/raw", "--dest", root + "/dest",\n'
        '                "--num_workers", "2", "--timeout", "120"]\n'
        '    runpy.run_path("scripts/" + script, run_name="__main__")\n'
        '    if out:\n'
        '        os.rename(root + "/dest", root + "/" + out)\n')
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS='cpu')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return root, proc.stdout


def test_preprocess_subcomplex_script(prepared):
    root, stdout = prepared
    lines = stdout.splitlines()
    # both runs print the same fallbacks and buckets
    assert lines.count("done: {'ok': 3, 'missing_file': 1}") == 2
    j_files, p_files = _tree(root / 'dest_jax'), _tree(root / 'dest')
    assert sorted(j_files) == sorted(p_files)
    assert len([n for n in p_files if n.endswith('_meta.pkl')]) == PAIRS
    for name in j_files:
        if name.endswith('.pdb'):
            assert j_files[name] == p_files[name], name
        else:
            assert_same(pickle.loads(j_files[name]),
                        pickle.loads(p_files[name]), name)
    fails = pickle.loads(p_files['fail_index.pkl'])
    assert [f['status'] for f in fails] == ['missing_file']


def test_import_reference_data_script(prepared, tmp_path):
    root, _ = prepared
    split = {'train': [('pair0/pair0_rec.pdb', 'pair0/pair0_lig.sdf')],
             'test': [('pair1/pair1_rec.pdb', 'pair1/pair1_lig.sdf')]}
    torch.save(split, str(tmp_path / 'split.pt'))
    for script, tag in (('import_reference_data.py', 'j'),
                        ('import_reference_data_torch.py', 'p')):
        run_script(script, '--index', root / 'dest', '--out',
                   tmp_path / f'{tag}.ddstore', '--split_pt',
                   tmp_path / 'split.pt')
    assert_same_store(tmp_path / 'j.ddstore', tmp_path / 'p.ddstore')
    assert ((tmp_path / 'j_split.pkl').read_bytes()
            == (tmp_path / 'p_split.pkl').read_bytes())
    from decompdiff_tpu_torch.data.store import DDStore
    store = DDStore(str(tmp_path / 'p.ddstore'))
    assert len(store) == PAIRS
    for rec in store:
        raw = p_mol.parse_sdf_file(
            str(root / 'raw' / rec['src_ligand_filename']))
        assert np.array_equal(rec['ligand_pos'], raw.pos)
        assert rec['num_arms'] == 2


@pytest.mark.parametrize('argv', [
    [], ['--unique_pocket_test', '--test_frac', '0.5', '--seed', '3'],
    ['--mode', 'by_names']])
def test_split_dataset_script(tmp_path, argv):
    from decompdiff_tpu_torch.data.synthetic import write_synthetic_store
    store = tmp_path / 's.ddstore'
    write_synthetic_store(str(store), [{}] * 6, seed=1)
    if '--mode' in argv:
        with open(tmp_path / 'names.pkl', 'wb') as f:
            pickle.dump({'train': ['synth/00000'], 'test': ['synth/00001']},
                        f)
        argv = argv + ['--names', tmp_path / 'names.pkl']
    for script, tag in (('split_dataset.py', 'j'),
                        ('split_dataset_torch.py', 'p')):
        run_script(script, store, '--out', tmp_path / f'{tag}.pkl', *argv)
    assert ((tmp_path / 'j.pkl').read_bytes()
            == (tmp_path / 'p.pkl').read_bytes())


def test_clean_crossdocked_script(tmp_path):
    import gzip
    source = tmp_path / 'source'
    (source / 'POCK').mkdir(parents=True)
    rng = np.random.default_rng(0)
    poses = []
    for k in range(3):
        mol = p_mol.parse_mol_block(DUMBBELL_LIGAND_SDF)
        mol.pos = (mol.pos + rng.normal(size=(1, 3))).astype(np.float32)
        poses.append(p_mol.mol_to_sdf_block(mol, name=f'pose{k}'))
    with gzip.open(source / 'POCK' / 'lig_tt_docked.sdf.gz', 'wt') as f:
        f.write(''.join(poses))
    (tmp_path / 'types').write_text(
        '1 -7.1 0.5 POCK/rec_0.gninatypes POCK/lig_tt_docked_0.sdf.gz\n'
        '1 -6.0 2.5 POCK/rec_0.gninatypes POCK/lig_tt_docked_1.sdf.gz\n'
        '0 -5.0 0.9 POCK/rec_0.gninatypes POCK/lig_tt_docked_2.sdf.gz\n'
        '1 -5.0 0.1 POCK/rec_0.gninatypes POCK/missing_tt_docked_0.sdf.gz\n'
        'short line\n'
        '1 -5.0 nan? POCK/rec_0.gninatypes POCK/lig_tt_docked_0.sdf.gz\n')
    for script, tag in (('clean_crossdocked.py', 'j'),
                        ('clean_crossdocked_torch.py', 'p')):
        run_script(script, tmp_path / 'types', '--source', source,
                   '--dest', tmp_path / tag)
    j_files, p_files = _tree(tmp_path / 'j'), _tree(tmp_path / 'p')
    assert j_files == p_files
    assert sorted(p_files) == ['POCK/lig_tt_docked_0.sdf',
                               'POCK/lig_tt_docked_2.sdf', 'index.pkl']


@pytest.mark.parametrize('argv', [['--n', '3', '--seed', '2'],
                                  ['--n', '2', '--random-types']])
def test_make_synthetic_data_script(tmp_path, argv):
    for script, tag in (('make_synthetic_data.py', 'j'),
                        ('make_synthetic_data_torch.py', 'p')):
        run_script(script, '--out', tmp_path / f'{tag}.ddstore', *argv)
    assert_same_store(tmp_path / 'j.ddstore', tmp_path / 'p.ddstore')
    assert ((tmp_path / 'j.ddstore').read_bytes()
            == (tmp_path / 'p.ddstore').read_bytes())
