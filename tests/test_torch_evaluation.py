"""The port's evaluation modules (decompdiff_tpu_torch/evaluation/ and
utils/confgen.py) against the JAX package's on the CPU.

Molecules: the anchor molecules of tests/test_{crippen,descriptors,morgan,
qed,confgen,reconstruct_eval}.py, plus a few that reach the charged,
halogen, sulfur, bridged and macrocycle branches, parsed by the JAX
package's mol_from_smiles and embedded by its first-party conformer
generator (seed 0), then copied field by field into the port's MolRecord.
The port's sampled molecules are compared in
tests/test_torch_sample_driver.py with `assert_same_scores` below.

Tolerance: exact. Both packages run the same numpy and scipy calls in the
same order on the same inputs, so integers, bit vectors and floats are
compared with == / np.array_equal (NaN equal to NaN); a difference is a
fault.
"""

import copy
import dataclasses
import hashlib
import math
import os
import random
import sys
import tempfile
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from decompdiff_tpu.evaluation import crippen as j_crippen
from decompdiff_tpu.evaluation import descriptors as j_desc
from decompdiff_tpu.evaluation import docking as j_docking
from decompdiff_tpu.evaluation import eval_atom_type as j_atom_type
from decompdiff_tpu.evaluation import eval_bond_length as j_bond
from decompdiff_tpu.evaluation import morgan as j_morgan
from decompdiff_tpu.evaluation import protocol as j_protocol
from decompdiff_tpu.evaluation import scoring as j_scoring
from decompdiff_tpu.evaluation.smiles import mol_from_smiles
from decompdiff_tpu.utils import chem as j_chem
from decompdiff_tpu.utils import confgen as j_confgen
from decompdiff_tpu_torch.data.mol import MolRecord
from decompdiff_tpu_torch.evaluation import crippen as p_crippen
from decompdiff_tpu_torch.evaluation import descriptors as p_desc
from decompdiff_tpu_torch.evaluation import docking as p_docking
from decompdiff_tpu_torch.evaluation import eval_atom_type as p_atom_type
from decompdiff_tpu_torch.evaluation import eval_bond_length as p_bond
from decompdiff_tpu_torch.evaluation import morgan as p_morgan
from decompdiff_tpu_torch.evaluation import protocol as p_protocol
from decompdiff_tpu_torch.evaluation import scoring as p_scoring
from decompdiff_tpu_torch.evaluation import smiles as p_smiles
from decompdiff_tpu_torch.utils import chem as p_chem
from decompdiff_tpu_torch.utils import confgen as p_confgen

REPO = Path(__file__).resolve().parents[1]

ANCHORS = {
    # tests/test_descriptors.py, test_crippen.py, test_morgan.py,
    # test_qed.py
    'ethanol': 'CCO', 'benzene': 'c1ccccc1', 'pyridine': 'n1ccccc1',
    'octane': 'CCCCCCCC', 'heptane': 'CCCCCCC', 'ether': 'CCOCC',
    'naphthalene': 'c1ccc2ccccc2c1', 'aspirin': 'CC(=O)Oc1ccccc1C(=O)O',
    'spiro': 'C1CCC2(C1)CCCC2', 'acetic_acid': 'CC(=O)O',
    'phenol': 'Oc1ccccc1', 'toluene': 'Cc1ccccc1', 'aniline': 'Nc1ccccc1',
    'paracetamol': 'CC(=O)Nc1ccc(O)cc1', 'anisole': 'COc1ccccc1',
    # tests/test_reconstruct_eval.py's chain
    'pentane': 'CCCCC',
    # branches the anchors above miss
    'pyrrole': 'c1cc[nH]c1', 'tetramethylammonium': 'C[N+](C)(C)C',
    'acetate': 'CC(=O)[O-]', 'sulfonamide': 'CS(=O)(=O)N',
    'acetonitrile': 'CC#N', 'chlorothiophene': 'Clc1cccs1',
    'norbornane': 'C1CC2CCC1C2', 'cyclodecane': 'C1CCCCCCCCC1',
    'tbu_cf3_benzene': 'CC(C)(C)c1ccc(C(F)(F)F)cc1',
    'alanine': 'CC(N)C(=O)O', 'bromoiodo': 'Brc1ccc(I)cc1',
}
NAMES = sorted(ANCHORS)


def to_port(mol):
    """The JAX package's MolRecord as the port's, field by field."""
    return MolRecord(**{f.name: copy.deepcopy(getattr(mol, f.name))
                        for f in dataclasses.fields(mol)})


def anchor_pairs(names):
    """name -> (JAX MolRecord, port MolRecord) with the same fields."""
    out = {}
    for name in names:
        m = mol_from_smiles(ANCHORS[name], name=name)
        pos, ok = j_chem.compute_3d_coors(m, random_seed=0)
        assert ok, name
        m.pos = np.asarray(pos, np.float32)
        out[name] = (m, to_port(m))
    return out


@pytest.fixture(scope='module')
def mols():
    return anchor_pairs(NAMES)


def write_anchor_results(path, names, pockets=2):
    """A result pickle of complete anchor molecules (elements of the
    'basic' atom mode), written as the port's sampling driver writes its
    own (sampling/driver.py save_result), spread over `pockets`
    ligand_filenames."""
    from decompdiff_tpu_torch.constants import MAP_ATOM_BASIC
    from decompdiff_tpu_torch.sampling.driver import save_result
    results = []
    for i, (name, (_, m)) in enumerate(anchor_pairs(names).items()):
        results.append({
            'mol': m, 'complete': True, 'smiles': ANCHORS[name],
            'pred_pos': np.asarray(m.pos),
            'pred_v': np.asarray([MAP_ATOM_BASIC[int(z)] for z in m.element]),
            'ligand_filename': f'anchors/pocket{i % pockets}_lig.sdf'})
    save_result(str(path), {'results': results, 'atom_mode': 'basic',
                            'data_id': 999})


def same(a, b):
    """Exact structural equality; floats bit-equal, NaN equal to NaN."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind in 'fc'))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return type(a) is type(b) and a == b


def assert_same(a, b, what=''):
    assert same(a, b), (what, a, b)


def _graph(m, desc):
    bonds = desc._undirected(m)
    return bonds, desc.implicit_h_counts(m.element, bonds, m.charges)


def assert_same_scores(jm, pm, n_conf=4):
    """Every public per-molecule function of the ported modules gives the
    JAX package's answer on a (JAX MolRecord, port MolRecord) pair."""
    jb, jh = _graph(jm, j_desc)
    pb, ph = _graph(pm, p_desc)
    assert_same(jb, pb, 'bonds')
    assert_same(jh, ph, 'implicit_h_counts')
    args_j = (jm.element, jb, jm.aromatic, jh, jm.charges)
    args_p = (pm.element, pb, pm.aromatic, ph, pm.charges)
    # crippen: atom types and logP
    assert_same(j_crippen.crippen_atom_types(*args_j),
                p_crippen.crippen_atom_types(*args_p), 'crippen types')
    assert_same(j_crippen.crippen_logp_exact(*args_j),
                p_crippen.crippen_logp_exact(*args_p), 'crippen logp')
    # morgan: invariants, fingerprint, fragment score
    for fn in ('connectivity_invariants', 'morgan_fingerprint',
               'fragment_score'):
        assert_same(getattr(j_morgan, fn)(jm.element, jb, jh, jm.charges),
                    getattr(p_morgan, fn)(pm.element, pb, ph, pm.charges),
                    fn)
    # descriptors
    for fn, ja, pa in (
            ('tpsa', (jm.element, jb, jm.aromatic, jh, jm.charges),
             (pm.element, pb, pm.aromatic, ph, pm.charges)),
            ('crippen_logp', args_j, args_p),
            ('mol_weight', (jm.element, jh), (pm.element, ph)),
            ('mol_weight_avg', (jm.element, jh), (pm.element, ph)),
            ('num_h_donors', (jm.element, jh), (pm.element, ph)),
            ('num_h_acceptors', (jm.element,), (pm.element,)),
            ('qed_hba', (jm, jb, jh), (pm, pb, ph)),
            ('qed_hbd', (jm, jh), (pm, ph)),
            ('num_rotatable_bonds_strict', (jm, jh), (pm, ph)),
            ('_estimate_stereocenters', (jm, jh), (pm, ph))):
        assert_same(getattr(j_desc, fn)(*ja), getattr(p_desc, fn)(*pa), fn)
    for fn in ('lipinski_count', 'path_fingerprint', 'qed_properties',
               'qed_score', 'sa_score', 'num_rings', 'num_aromatic_rings',
               'get_chem_record'):
        assert_same(getattr(j_desc, fn)(jm), getattr(p_desc, fn)(pm), fn)
    # scoring
    for fn in ('can_score', 'get_basic', 'get_ring_sizes', 'get_chem',
               'obey_lipinski', 'get_conformer_energies'):
        assert_same(getattr(j_scoring, fn)(jm), getattr(p_scoring, fn)(pm),
                    fn)
    assert_same(j_scoring.get_rdkit_rmsd(jm, n_conf=n_conf, random_seed=7),
                p_scoring.get_rdkit_rmsd(pm, n_conf=n_conf, random_seed=7),
                'get_rdkit_rmsd')
    assert_same(j_scoring.tanimoto_sim(jm, jm), p_scoring.tanimoto_sim(pm, pm),
                'tanimoto_sim')
    # bond lengths
    assert_same(j_bond.bond_distances_from_mol(jm),
                p_bond.bond_distances_from_mol(pm), 'bond_distances')
    # the SMILES writer on the helpers it now takes from descriptors
    from decompdiff_tpu.evaluation.smiles import mol_to_smiles
    assert mol_to_smiles(jm) == p_smiles.mol_to_smiles(pm)


@pytest.mark.parametrize('name', NAMES)
def test_anchor_molecule_scores(mols, name):
    assert_same_scores(*mols[name])


def test_pairwise_similarity_and_ring_counts(mols):
    jms = [mols[n][0] for n in NAMES]
    pms = [mols[n][1] for n in NAMES]
    assert_same(j_scoring.batched_number_of_rings(jms),
                p_scoring.batched_number_of_rings(pms))
    assert_same(j_scoring.tanimoto_sim_N_to_1(jms, jms[0]),
                p_scoring.tanimoto_sim_N_to_1(pms, pms[0]))
    with pytest.raises(TypeError):
        p_scoring.tanimoto_sim(pms[0], object())


@pytest.mark.parametrize('name', ['aspirin', 'norbornane', 'spiro'])
def test_conformer_generation(mols, name):
    jm, pm = mols[name]
    jb, pb = j_confgen.record_bonds(jm), p_confgen.record_bonds(pm)
    assert_same(jb, pb)
    assert_same(j_confgen.distance_bounds(jm.element, jb),
                p_confgen.distance_bounds(pm.element, pb))
    assert_same(j_confgen.generate_conformers(jm.element, jb, n_confs=3,
                                              seed=5),
                p_confgen.generate_conformers(pm.element, pb, n_confs=3,
                                              seed=5))
    assert_same(
        j_confgen.embed_conformer(jm.element, jb, np.random.default_rng(3)),
        p_confgen.embed_conformer(pm.element, pb, np.random.default_rng(3)))
    assert_same(j_chem.compute_3d_coors(jm, random_seed=2),
                p_chem.compute_3d_coors(pm, random_seed=2))
    assert_same(j_chem.compute_3d_coors_multiple(jm, numConfs=2),
                p_chem.compute_3d_coors_multiple(pm, numConfs=2))


def test_force_field_front(mols):
    jm, pm = mols['paracetamol']
    jf = j_scoring.get_molecule_force_field(jm)
    pf = p_scoring.get_molecule_force_field(pm)
    assert_same(jf.CalcEnergy(), pf.CalcEnergy())
    assert jf.Minimize(maxIts=50) == pf.Minimize(maxIts=50) == 0
    assert_same(jf.positions, pf.positions)
    assert_same(jf.CalcEnergy(), pf.CalcEnergy())


def test_length_profiles_and_jsds(mols):
    """Bond-length, pair-distance and atom-type profiles and JSDs over all
    anchor molecules, on the same distances."""
    jb, pb, jp, pp = [], [], [], []
    jc, pc = Counter(), Counter()
    for name in NAMES:
        jm, pm = mols[name]
        jb += j_bond.bond_distances_from_mol(jm)
        pb += p_bond.bond_distances_from_mol(pm)
        jp += j_bond.pair_distances_from_pos(jm.pos, jm.element)
        pp += p_bond.pair_distances_from_pos(pm.pos, pm.element)
        jc.update(int(z) for z in jm.element)
        pc.update(int(z) for z in pm.element)
    assert_same(jb, pb)
    assert_same(jp, pp)
    jprof, pprof = (j_bond.get_bond_length_profile(jb),
                    p_bond.get_bond_length_profile(pb))
    assert_same(jprof, pprof)
    assert_same(j_bond.eval_bond_length_profile(jprof),
                p_bond.eval_bond_length_profile(pprof))
    jprof, pprof = (j_bond.get_pair_length_profile(jp),
                    p_bond.get_pair_length_profile(pp))
    assert_same(jprof, pprof)
    assert_same(j_bond.eval_pair_length_profile(jprof),
                p_bond.eval_pair_length_profile(pprof))
    assert_same(j_atom_type.eval_atom_type_distribution(jc),
                p_atom_type.eval_atom_type_distribution(pc))
    assert_same(j_bond.get_distribution([1.1, 1.5, 2.0, 9.0]),
                p_bond.get_distribution([1.1, 1.5, 2.0, 9.0]))
    # the reference tables loaded from the port's own asset
    assert_same(j_bond.DISTANCE_BINS, p_bond.DISTANCE_BINS)
    assert_same(j_bond.REF_BOND_DISTRIBUTIONS, p_bond.REF_BOND_DISTRIBUTIONS)
    assert_same(j_bond.REF_PAIR_DISTRIBUTIONS, p_bond.REF_PAIR_DISTRIBUTIONS)


def test_protocol_aggregates(mols):
    rng = np.random.default_rng(0)
    rows = {
        'vina_full': [{k: [{'affinity': float(rng.normal(-7, 2))}]
                       for k in ('score_only', 'minimize', 'dock')}
                      for _ in range(5)],
        'vina': [[{'affinity': float(rng.normal(-7, 2))}] for _ in range(5)],
    }
    rows['vina_score'] = [{k: r[k] for k in ('score_only', 'minimize')}
                          for r in rows['vina_full']]
    rows['qvina'] = rows['vina']
    for mode, rs in rows.items():
        assert_same(j_protocol.aggregate_vina(rs, mode),
                    p_protocol.aggregate_vina(rs, mode), mode)
        assert_same([j_protocol.dock_affinity(r, mode) for r in rs],
                    [p_protocol.dock_affinity(r, mode) for r in rs], mode)
    chem = [{'qed': float(q), 'sa': float(s)}
            for q, s in rng.random((6, 2))] + [None]
    dock = [float(d) for d in rng.normal(-8, 1.5, 6)] + [-9.0]
    assert_same(j_protocol.success_rate(chem, dock),
                p_protocol.success_rate(chem, dock))
    assert_same(j_protocol.high_affinity(dock, -8.0),
                p_protocol.high_affinity(dock, -8.0))
    assert p_protocol.high_affinity(dock, None) is None
    by_pocket_j = {'a': [mols[n][0] for n in NAMES[:9]],
                   'b': [mols[n][0] for n in NAMES[9:]],
                   'c': [mols['benzene'][0]]}
    by_pocket_p = {k: [to_port(m) for m in v] for k, v in by_pocket_j.items()}
    assert_same(j_protocol.diversity(by_pocket_j),
                p_protocol.diversity(by_pocket_p))
    assert_same(j_protocol.pocket_diversity(by_pocket_j['a']),
                p_protocol.pocket_diversity(by_pocket_p['a']))


# ---------------------------------------------------------------------------
# docking: box, QVina output parsing and commands, the Vina mode dispatch
# against a fake vina module (vina, meeko and the receptor tools stubbed)

class FakeVina:
    SCORES = {'score_only': -4.5, 'minimize': -6.0, 'dock': -8.5}

    def __init__(self, sf_name='vina', seed=0, verbosity=0):
        pass

    def set_receptor(self, p):
        self.receptor = p

    def set_ligand_from_file(self, p):
        self.ligand = p

    def compute_vina_maps(self, center, box_size):
        self.center, self.box_size = center, box_size

    def score(self):
        return [self.SCORES['score_only']]

    def optimize(self):
        return [self.SCORES['minimize']]

    def dock(self, exhaustiveness=8, n_poses=1):
        self.exhaustiveness = exhaustiveness

    def energies(self, n_poses=1):
        return [[self.SCORES['dock']]]

    def poses(self, n_poses=1):
        return f'POSE {self.center} {self.box_size}'

    def write_pose(self, path, overwrite=True):
        with open(path, 'w') as f:
            f.write(f'MINPOSE {self.center}')


def install_fake_vina(monkeypatch, *docking_modules):
    """A fake `vina` module; ligand and receptor preparation stubbed in
    each given docking module."""
    monkeypatch.setitem(sys.modules, 'vina',
                        types.SimpleNamespace(Vina=FakeVina))
    for mod in docking_modules:
        monkeypatch.setattr(
            mod, 'PrepLig', lambda sdf, fmt: types.SimpleNamespace(
                get_pdbqt=lambda out: open(out, 'w').write('LIG')))
        monkeypatch.setattr(mod.PrepProt, 'addH',
                            lambda self, pqr: open(pqr, 'w').write('PQR'))
        monkeypatch.setattr(mod.PrepProt, 'get_pdbqt',
                            lambda self, out: open(out, 'w').write('PROT'))


PROTEIN = 'ATOM      1  N   ALA A   1      0.000   0.000   0.000\n'


@pytest.fixture
def fake_vina(monkeypatch, tmp_path):
    install_fake_vina(monkeypatch, j_docking, p_docking)
    prot = tmp_path / 'prot.pdb'
    prot.write_text(PROTEIN)
    return str(prot)


def test_run_docking_mode_dispatch(mols, fake_vina, tmp_path):
    jm, pm = mols['aspirin']
    for mode in ('vina_score', 'vina_full', 'vina', 'none'):
        want = j_protocol.run_docking(jm, mode, protein_path=fake_vina,
                                      tmp_dir=str(tmp_path),
                                      exhaustiveness=4)
        got = p_protocol.run_docking(pm, mode, protein_path=fake_vina,
                                     tmp_dir=str(tmp_path), exhaustiveness=4)
        assert_same(want, got, mode)
        assert_same(j_protocol.dock_affinity(want, mode),
                    p_protocol.dock_affinity(got, mode), mode)
    # the protein located from ligand_filename + protein_root
    root = tmp_path / 'root'
    (root / 'POCKET').mkdir(parents=True)
    (root / 'POCKET' / '1abc_A_rec.pdb').write_text(PROTEIN)
    kw = dict(ligand_filename='POCKET/1abc_A_rec_lig.sdf',
              protein_root=str(root), tmp_dir=str(tmp_path))
    assert_same(j_protocol.run_docking(jm, 'vina', **kw),
                p_protocol.run_docking(pm, 'vina', **kw))
    with pytest.raises(ValueError, match='protein_path'):
        p_protocol.run_docking(pm, 'vina', tmp_dir=str(tmp_path))
    with pytest.raises(ValueError):
        p_protocol.run_docking(pm, 'glide', protein_path=fake_vina)


def test_docking_tmp_dir_defaults_to_the_platform_temp_dir(
        mols, fake_vina, tmp_path, monkeypatch):
    """A tmp_dir left out is tempfile.gettempdir() (TMPDIR), never a fixed
    /tmp that two checkouts would share."""
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    _, pm = mols['aspirin']
    assert p_docking.VinaDockingTask(pm, fake_vina).tmp_dir == str(tmp_path)
    assert (p_docking.QVinaDockingTask(pm, fake_vina).tmp_dir
            == os.path.realpath(tmp_path))
    dirs, make = [], tempfile.TemporaryDirectory
    monkeypatch.setattr(tempfile, 'TemporaryDirectory',
                        lambda dir=None: dirs.append(dir) or make(dir=dir))
    assert p_protocol.run_docking(pm, 'vina', protein_path=fake_vina)
    assert dirs and set(dirs) == {str(tmp_path)}


@pytest.mark.parametrize('kw', [{}, dict(center=[1, -2, 3]),
                                dict(size_factor=2.0, buffer=1.0),
                                dict(size_factor=None)])
def test_compute_box(mols, kw):
    pos = mols['naphthalene'][0].pos
    assert_same(j_docking.compute_box(pos, **kw),
                p_docking.compute_box(pos, **kw))


QVINA_SDF = """pose1
 OpenBabel

  1  0  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
M  END
> <REMARK>
VINA RESULT:    -7.3      0.000      0.000

$$$$
pose2
 OpenBabel

  1  0  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
M  END
> <REMARK>
VINA RESULT:    -6.1      1.200      2.300

$$$$
"""


def test_qvina_outputs_and_commands(mols, tmp_path, monkeypatch):
    out = tmp_path / 'out.sdf'
    out.write_text(QVINA_SDF)
    assert_same(j_docking.parse_qvina_outputs(str(out)),
                p_docking.parse_qvina_outputs(str(out)))
    jm, pm = mols['chlorothiophene']
    prot = tmp_path / 'p.pdb'
    prot.write_text(PROTEIN)
    tasks = []
    for mod, m in ((j_docking, jm), (p_docking, pm)):
        random.seed(11)    # the same task ids (get_random_id)
        tasks.append(mod.QVinaDockingTask(m, str(prot),
                                          tmp_dir=str(tmp_path)))
    assert tasks[0].task_id == tasks[1].task_id
    assert tasks[0].commands(16) == tasks[1].commands(16)
    # run_sync with the subprocess faked: the same poses
    results = []
    for mod, task in zip((j_docking, p_docking), tasks):
        monkeypatch.setattr(mod, '_have', lambda cmd: True)

        def fake_run(cmd, input=None, capture_output=True, task=task):
            with open(task.docked_sdf_path, 'w') as f:
                f.write(QVINA_SDF)
            return types.SimpleNamespace(stdout=b'ok', stderr=b'')

        monkeypatch.setattr(mod.subprocess, 'run', fake_run)
        results.append(task.run_sync())
    assert_same(*results)
    monkeypatch.setattr(p_docking, '_have', lambda cmd: False)
    with pytest.raises(FileNotFoundError, match='qvina pipeline tools'):
        tasks[1].run_sync()
    assert p_docking.docking_available()['qvina2'] is False


# ---------------------------------------------------------------------------
# assets, the deferred hooks, the helpers moved into descriptors


@pytest.mark.parametrize('name', ['crossdocked_distributions.json',
                                  'fpscores.pkl.gz'])
def test_assets_are_byte_copies(name):
    def sha(pkg):
        path = REPO / pkg / 'evaluation' / 'assets' / name
        return hashlib.sha256(path.read_bytes()).hexdigest()
    assert sha('decompdiff_tpu_torch') == sha('decompdiff_tpu')


def test_fpscores_read_from_the_port_asset():
    assert Path(p_morgan._FPSCORES).parent.parent == Path(
        p_desc.__file__).parent
    assert p_morgan.load_fpscores() == j_morgan.load_fpscores()


@pytest.mark.parametrize('name', ['aniline', 'paracetamol', 'pyrrole',
                                  'acetate', 'bromoiodo'])
def test_deferred_hooks_raise(mols, tmp_path, monkeypatch, name):
    """The two hooks into the SMARTS engine (evaluation/alerts.py), once
    deferred: is_pains on a MolRecord and the QED alert count over a
    DD_QED_ALERTS_SMARTS corpus equal the JAX package's, and so does
    get_chem with the corpus set."""
    jm, pm = mols[name]
    assert p_scoring.is_pains(pm) is j_scoring.is_pains(jm)
    corpus = tmp_path / 'alerts.smarts'
    corpus.write_text('[N;H2]c aniline\n[OX2H]c phenol\nc[Br,I] halide\n'
                      '[#6][CX3](=O)[O-] carboxylate\n')
    monkeypatch.setenv('DD_QED_ALERTS_SMARTS', str(corpus))
    count = p_desc._qed_alert_count(pm)
    assert count == j_desc._qed_alert_count(jm)
    assert count == {'aniline': 1, 'paracetamol': 1, 'pyrrole': 0,
                     'acetate': 1, 'bromoiodo': 1}[name]
    assert_same(p_scoring.get_chem(pm), j_scoring.get_chem(jm), name)
    # a path that names no file is ignored, as in the JAX package
    monkeypatch.setenv('DD_QED_ALERTS_SMARTS', str(tmp_path / 'missing'))
    assert p_desc._qed_alert_count(pm) == j_desc._qed_alert_count(jm) == 0


@pytest.mark.parametrize('name', ['aniline', 'paracetamol', 'pyrrole'])
def test_qed_alerts_zero_when_unset(mols, monkeypatch, name):
    monkeypatch.delenv('DD_QED_ALERTS_SMARTS', raising=False)
    jm, pm = mols[name]
    assert j_desc.qed_properties(jm)['ALERTS'] == 0
    assert p_desc.qed_properties(pm)['ALERTS'] == 0


def test_smiles_writer_uses_the_descriptor_helpers():
    assert p_smiles.implicit_h_counts is p_desc.implicit_h_counts
    assert p_smiles._undirected is p_desc._undirected
    assert p_smiles.DEFAULT_VALENCES is p_desc.DEFAULT_VALENCES
    assert p_desc.DEFAULT_VALENCES == j_desc.DEFAULT_VALENCES


def test_driver_refuses_a_qed_alert_corpus(tmp_path, monkeypatch):
    """The port's driver no longer refuses a corpus: with
    DD_QED_ALERTS_SMARTS naming a file it counts the alerts into QED as
    scripts/evaluate.py does (equal summaries, the aniline's QED lowered
    by its alert) and writes its summary."""
    import importlib.util

    from decompdiff_tpu_torch.evaluation import driver
    write_anchor_results(tmp_path / 'result_0.pkl', ['aniline', 'toluene'])
    plain = driver.main([str(tmp_path), '--result_path',
                         str(tmp_path / 'plain.pkl')])
    corpus = tmp_path / 'alerts.smarts'
    corpus.write_text('[N;H2]c\n')
    monkeypatch.setenv('DD_QED_ALERTS_SMARTS', str(corpus))
    spec = importlib.util.spec_from_file_location(
        'jax_evaluate_script', REPO / 'scripts' / 'evaluate.py')
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    want = jax_script.main([str(tmp_path), '--result_path',
                            str(tmp_path / 'jax.pkl')])
    got = driver.main([str(tmp_path)])
    assert_same(want, got)
    assert got['n_complete'] == 2
    assert (tmp_path / 'eval_summary.pkl').exists()
    qed = [c['qed'] for c in got['chem']]
    assert qed[0] < plain['chem'][0]['qed']
    assert qed[1] == plain['chem'][1]['qed']


def test_driver_refuses_an_outdir_without_results(tmp_path):
    from decompdiff_tpu_torch.evaluation import driver
    with pytest.raises(FileNotFoundError, match='result_'):
        driver.main([str(tmp_path)])
    assert not (tmp_path / 'eval_summary.pkl').exists()
