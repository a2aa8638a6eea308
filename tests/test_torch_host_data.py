"""The port's host pipeline against the JAX package's, module by module, on
the same seeded numpy inputs: every result bit-equal (same values, same
dtypes). The store, featurization, priors, generation records and initial
types, the padding collator, the native routines, the PDB parser and the
reconstruction (molecule, SDF block, SMILES) are numpy code copied with
their imports rewritten, so nothing less than equality is expected.
"""

import copy
import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest

from decompdiff_tpu import native as jax_native
from decompdiff_tpu.data import collate as jax_collate
from decompdiff_tpu.data import dataset as jax_dataset
from decompdiff_tpu.data import mol as jax_mol
from decompdiff_tpu.data import protein as jax_protein
from decompdiff_tpu.data import store as jax_store
from decompdiff_tpu.data import transforms as jax_transforms
from decompdiff_tpu.evaluation import smiles as jax_smiles
from decompdiff_tpu.priors import atom_num as jax_atom_num
from decompdiff_tpu.priors import beta as jax_beta
from decompdiff_tpu.priors import golden as jax_golden
from decompdiff_tpu.reconstruct import builder as jax_builder
from decompdiff_tpu.sampling import init as jax_init
from decompdiff_tpu_torch import native
from decompdiff_tpu_torch.data import collate, dataset, mol, protein, store
from decompdiff_tpu_torch.data import synthetic, transforms
from decompdiff_tpu_torch.data.batch import ComplexBatch
from decompdiff_tpu_torch.evaluation import smiles
from decompdiff_tpu_torch.priors import atom_num, beta, golden
from decompdiff_tpu_torch.reconstruct import builder
from decompdiff_tpu_torch.sampling import init
from decompdiff_tpu_torch.utils.testing import random_complex_batch
from tests.test_data_layer import PDB_BLOCK, _raw_sample

REPO = Path(__file__).resolve().parents[1]
BASIC_INDEX = {6: 1, 7: 2, 8: 3, 16: 6}     # element -> 'basic' class


def assert_same(got, want, path='value'):
    """Equal structure, values and dtypes (tuples and lists alike)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f'{path}[{k!r}]')
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), path
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{path}[{i}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _raw(seed=0, n_prot=40, n_lig=12, num_arms=2):
    return _raw_sample(np.random.default_rng(seed), n_prot=n_prot,
                       n_lig=n_lig, num_arms=num_arms)


# --------------------------------------------------------------------------
# store, synthetic data, dataset
# --------------------------------------------------------------------------

def _jax_synthetic_script():
    spec = importlib.util.spec_from_file_location(
        'make_synthetic_data', REPO / 'scripts' / 'make_synthetic_data.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('kwargs', [{}, {'random_types': True},
                                    {'n_protein': 320, 'n_ligand': 28,
                                     'num_arms': 3}],
                         ids=['default', 'random_types', 'card_size'])
def test_synthetic_complex_matches_jax_script(kwargs):
    script = _jax_synthetic_script()
    for seed in range(3):
        want = script.synthetic_complex(np.random.default_rng(seed), **kwargs)
        got = synthetic.synthetic_complex(np.random.default_rng(seed),
                                          **kwargs)
        assert_same(got, want)


def test_store_round_trip_matches_jax(tmp_path):
    """The port writes the JAX package's file byte for byte, and each reads
    the other's."""
    rng = np.random.default_rng(0)
    records = [synthetic.synthetic_complex(rng) for _ in range(4)]
    paths = {}
    for name, writer in (('port', store.DDStoreWriter),
                         ('jax', jax_store.DDStoreWriter)):
        paths[name] = tmp_path / f'{name}.ddstore'
        with writer(str(paths[name]), meta={'synthetic': True}) as w:
            for i, r in enumerate(records):
                w.append(f'synth/{i:05d}', r)
    assert paths['port'].read_bytes() == paths['jax'].read_bytes()
    for reader in (store.DDStore, jax_store.DDStore):
        s = reader(str(paths['port']))
        assert len(s) == 4 and s.meta == {'synthetic': True}
        assert_same(s.get_by_key('synth/00002'), records[2])
        for got, want in zip(s, records):
            assert_same(got, want)


def test_dataset_matches_jax(tmp_path):
    path = str(tmp_path / 's.ddstore')
    synthetic.write_synthetic_store(path, [{}] * 3, seed=5)
    got = dataset.DecompDataset(store.DDStore(path))
    want = jax_dataset.DecompDataset(jax_store.DDStore(path))
    assert len(got) == len(want) == 3
    for i in range(3):
        assert_same(got.get_raw(i), want.get_raw(i))
        assert_same(got[i], want[i])
    split = {'train': [('p', 'synth/00000.sdf'), 'synth/00002'],
             'test': ['synth/00001']}
    assert got.split_by_names(split) == want.split_by_names(split)


# --------------------------------------------------------------------------
# featurization and priors
# --------------------------------------------------------------------------

def _beta_prior_dict():
    return {
        'num_arms': 2, 'num_scaffold': 1,
        'arms_prior': [(5, np.zeros(3), np.eye(3) * 1.2, None, None),
                       (4, np.ones(3), 0.9, None, None)],
        'scaffold_prior': [(6, np.ones(3) * 2, np.eye(3) * 1.5, None, None)],
    }


def _beta_raw(module, tmp_path):
    path = tmp_path / 'beta.pkl'
    path.write_bytes(pickle.dumps(_beta_prior_dict()))
    return module.substitute_with_beta_prior(_raw(), str(path))


@pytest.mark.parametrize('prior_mode,bond_mode,add_ord_feat,random_rot', [
    ('ref_prior', 'fc', False, False),
    ('subpocket', 'decomp_fc', True, False),
    ('beta_prior', 'scaffold_fc', False, False),
    ('ref_prior', 'fc', False, True),
])
def test_featurize_sample_matches_jax(tmp_path, prior_mode, bond_mode,
                                      add_ord_feat, random_rot):
    for aromatic_mode in ('basic', 'add_aromatic'):
        raws = ((_beta_raw(beta, tmp_path), _beta_raw(jax_beta, tmp_path))
                if prior_mode == 'beta_prior' else (_raw(), _raw()))
        kw = dict(prior_mode=prior_mode, ligand_atom_mode=aromatic_mode,
                  ligand_bond_mode=bond_mode, add_ord_feat=add_ord_feat,
                  random_rot=random_rot)
        got = transforms.featurize_sample(
            raws[0], rng=np.random.default_rng(1), **kw)
        want = jax_transforms.featurize_sample(
            raws[1], rng=np.random.default_rng(1), **kw)
        assert_same(got, want)


def test_priors_match_jax(tmp_path):
    raw = _raw(3)
    args = (raw['ligand_pos'], raw['ligand_atom_mask'], raw['protein_pos'],
            raw['num_arms'])
    assert_same(golden.compute_golden_prior(*args),
                jax_golden.compute_golden_prior(*args))
    assert_same(_beta_raw(beta, tmp_path), _beta_raw(jax_beta, tmp_path))
    for name in ('atom_num_config', 'arm_num_config', 'scaffold_num_config'):
        assert (atom_num.load_num_config(name)
                == jax_atom_num.load_num_config(name))
    size = atom_num.get_space_size(raw['protein_pos'])
    assert size == jax_atom_num.get_space_size(raw['protein_pos'])
    cfg = atom_num.load_num_config('arm_num_config')
    got = [atom_num.sample_atom_num(s, cfg, np.random.default_rng(s))
           for s in range(0, 30, 3)]
    want = [jax_atom_num.sample_atom_num(s, cfg, np.random.default_rng(s))
            for s in range(0, 30, 3)]
    assert got == want


# --------------------------------------------------------------------------
# generation records, initial types, collate
# --------------------------------------------------------------------------

class _Linear:
    """A regressor for the 'stat' atom-count sampler: a fixed linear map."""

    def __init__(self, scale, bias):
        self.scale, self.bias = scale, bias

    def predict(self, x):
        x = np.asarray(x, np.float64)
        return self.bias + self.scale * x.mean(1)


STAT_MODELS = {'arm_model': _Linear(0.4, 3.0),
               'armstd_model': _Linear(0.05, 0.5),
               'sca_model': _Linear(0.3, 4.0),
               'scastd_model': _Linear(0.03, 0.4)}
MODES = [('subpocket', 'prior'), ('subpocket', 'ref'),
         ('subpocket', 'ref_large'), ('ref_prior', 'ref'),
         ('ref_prior', 'prior'), ('beta_prior', 'old'), ('beta_prior', 'v2'),
         ('beta_prior', 'stat')]


def _records(module, beta_module, atom_module, tmp_path, prior_mode,
             natoms_mode, n=5, seed=7):
    """Generation records and initial types, as a driver makes them: the
    records, uniform initial types for them, then marginal ones."""
    raw = (_beta_raw(beta_module, tmp_path) if prior_mode == 'beta_prior'
           else _raw())
    rng = np.random.default_rng(seed)
    kw = {}
    if natoms_mode == 'prior':
        kw = dict(arms_natoms_config=atom_module.load_num_config(
                      'arm_num_config'),
                  scaffold_natoms_config=atom_module.load_num_config(
                      'scaffold_num_config'))
    if natoms_mode == 'stat':
        kw = dict(natoms_sampler=atom_module.NumAtomsSampler(STAT_MODELS))
    records = module.build_generation_records(raw, n, prior_mode,
                                              natoms_mode, rng, **kw)
    uniform = module.init_types_host(rng, copy.deepcopy(records), 8, 5)
    marginal = module.init_types_host(
        rng, records, 8, 5,
        atom_prior_probs=np.exp(np.full(8, -np.log(8), np.float32)
                                .astype(np.float64)),
        bond_prior_probs=np.array([0.9170, 0.0433, 0.00687, 0.000173,
                                   0.03266]))
    return uniform, marginal


@pytest.mark.parametrize('prior_mode,natoms_mode', MODES)
def test_generation_records_match_jax(tmp_path, prior_mode, natoms_mode):
    got = _records(init, beta, atom_num, tmp_path, prior_mode, natoms_mode)
    want = _records(jax_init, jax_beta, jax_atom_num, tmp_path, prior_mode,
                    natoms_mode)
    assert_same(got, want)


def _collate_inputs(tmp_path):
    """Generation records of several pockets and atom-count modes, and
    featurized records with a restricted bond graph."""
    recs = []
    for prior_mode, natoms_mode in MODES[:4] + MODES[-2:]:
        recs += _records(init, beta, atom_num, tmp_path, prior_mode,
                         natoms_mode, n=2)[1]
    featurized = [transforms.featurize_sample(
        _raw(s, n_prot=50 + 40 * s, n_lig=10 + 7 * s, num_arms=1 + s),
        ligand_bond_mode='decomp_fc') for s in range(3)]
    return recs, featurized


def test_collate_matches_jax(tmp_path):
    recs, featurized = _collate_inputs(tmp_path)
    want_dtypes = {f: getattr(random_complex_batch(
        np.random.default_rng(0), device='cpu'), f).dtype for f in (
        'protein_pos', 'ligand_v', 'ligand_mask', 'ligand_decomp_idx',
        'bond_type', 'prior_num_atoms', 'num_arms')}
    for batch_recs, kw in ((recs, {}), (featurized, {}),
                           (featurized, {'nl_override': 40,
                                         'np_override': 200})):
        want = jax_collate.collate(batch_recs, to_device=False, **kw)
        got = collate.collate(batch_recs, device='cpu', **kw)
        assert isinstance(got, ComplexBatch) and got.device.type == 'cpu'
        for f in vars(want):
            w = getattr(want, f)
            if w is None:
                assert getattr(got, f) is None, f
                continue
            assert_same(getattr(got, f).numpy(), np.asarray(w), f)
        for f, dtype in want_dtypes.items():
            assert getattr(got, f).dtype == dtype, f
    assert (collate.bucket_key(featurized[2])
            == jax_collate.bucket_key(featurized[2]))
    for module in (collate, jax_collate):
        with pytest.raises(ValueError, match='nl_override=16'):
            (module.collate(featurized, nl_override=16, device='cpu')
             if module is collate
             else module.collate(featurized, nl_override=16))


# --------------------------------------------------------------------------
# native routines and the PDB parser
# --------------------------------------------------------------------------

@pytest.fixture(params=['c', 'fallback'])
def jax_native_lib(request, monkeypatch):
    """The JAX package's native routines with its C library, or with its
    Python fallbacks."""
    if request.param == 'c':
        if not jax_native.available():
            pytest.skip('the JAX package could not build its C library')
    else:
        monkeypatch.setattr(jax_native, 'get_lib', lambda: None)
    return request.param


def test_native_routines_match_jax(jax_native_lib):
    rng = np.random.default_rng(0)
    for F in (1, 3, 29):
        arrays = [rng.normal(size=(n, F)).astype(np.float32)
                  for n in (3, 7, 1)]
        assert_same(native.pad_stack_f32(arrays, 8),
                    jax_native.pad_stack_f32(arrays, 8))
        ints = [a.astype(np.int32) for a in arrays]
        assert_same(native.pad_stack_i32(ints, 9),
                    jax_native.pad_stack_i32(ints, 9))
    flat = [np.arange(n, dtype=np.int32) for n in (4, 2)]
    assert_same(native.pad_stack_i32(flat, 5),
                jax_native.pad_stack_i32(flat, 5))
    counts = [0, 3, 5]
    assert_same(native.length_masks(counts, 6),
                jax_native.length_masks(counts, 6))
    assert_same(native.fc_bond_masks(counts, 6),
                jax_native.fc_bond_masks(counts, 6))
    mats = [rng.integers(0, 5, size=(n, n)).astype(np.int32)
            for n in (4, 6, 1)]
    assert_same(native.pad_square_stack_i32(mats, 8),
                jax_native.pad_square_stack_i32(mats, 8))
    for fn in ('pad_stack_f32', 'length_masks'):
        arg = arrays if fn == 'pad_stack_f32' else counts
        for module in (native, jax_native):
            with pytest.raises(ValueError, match='exceeds n_pad'):
                getattr(module, fn)(arg, 2)


def test_native_parsers_match_jax_c_library():
    if not jax_native.available():
        pytest.skip('the JAX package could not build its C library')
    block = PDB_BLOCK + PDB_BLOCK.replace('ATOM  ', 'HETATM')
    crlf = PDB_BLOCK.replace('\n', '\r\n')
    for text in (PDB_BLOCK, block, crlf, PDB_BLOCK + 'ENDMDL\n' + PDB_BLOCK):
        assert_same(native.parse_pdb_atoms_native(text),
                    jax_native.parse_pdb_atoms_native(text))
    rng = np.random.default_rng(1)
    for n, min_d in ((12, 0.4), (30, 0.0), (1, 0.0)):
        pos = (rng.normal(size=(n, 3)) * 1.2).astype(np.float32)
        radii = rng.choice([0.31, 0.76, 0.71, 0.66], size=n).astype(
            np.float32)
        assert_same(native.perceive_bonds_native(pos, radii, 1.3, min_d),
                    jax_native.perceive_bonds_native(pos, radii, 1.3, min_d))


def _float32_xyz(atoms):
    return [dict(a, **{k: np.float32(a[k]) for k in 'xyz'}) for a in atoms]


def test_pdb_protein_matches_jax(jax_native_lib, tmp_path):
    path = tmp_path / 'p.pdb'
    path.write_text(PDB_BLOCK)
    for got, want in ((protein.PDBProtein(PDB_BLOCK),
                       jax_protein.PDBProtein(PDB_BLOCK)),
                      (protein.PDBProtein(str(path)),
                       jax_protein.PDBProtein(str(path)))):
        assert_same(got.to_dict_atom(), want.to_dict_atom())
        assert got.title == want.title
        # the coordinates of the atom records: float32 values, as Python
        # floats of the C parser's float32 or of the text (the JAX
        # package's two paths differ there)
        assert_same(_float32_xyz(got.atoms), _float32_xyz(want.atoms))
        if jax_native_lib == 'c':
            assert_same(got.atoms, want.atoms)


# --------------------------------------------------------------------------
# reconstruction, SDF and SMILES
# --------------------------------------------------------------------------

def _ring(n, radius, z):
    angle = 2 * np.pi * np.arange(n) / n
    pos = np.stack([radius * np.cos(angle), radius * np.sin(angle),
                    np.zeros(n)], 1).astype(np.float32)
    return pos, np.array([BASIC_INDEX[x] for x in z])


def _predictions():
    """(name, pred_pos, pred_v, pred_bond or None): chain ligands of the
    synthetic generator with their bonds, without them, with noise and
    with random bonds; aromatic and aliphatic rings."""
    cases = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        c = synthetic.synthetic_complex(rng)
        n = len(c['ligand_element'])
        v = np.array([BASIC_INDEX[z] for z in c['ligand_element']])
        bond = transforms.dense_bond_matrix(
            n, c['ligand_bond_index'], c['ligand_bond_type'])
        pos = c['ligand_pos']
        noisy = (pos + rng.normal(size=pos.shape) * 0.15).astype(np.float32)
        random_bond = np.triu(rng.integers(0, 5, size=(n, n)), 1)
        cases += [(f'chain{seed}', pos, v, bond),
                  (f'chain{seed}_geometry', pos, v, None),
                  (f'noisy{seed}_geometry', noisy, v, None),
                  (f'random_bonds{seed}', noisy, v,
                   random_bond + random_bond.T)]
    for name, n, radius, z in (('benzene', 6, 1.39, [6] * 6),
                               ('pyridine', 6, 1.38, [7] + [6] * 5),
                               ('cyclohexane', 6, 1.53, [6] * 6)):
        pos, v = _ring(n, radius, z)
        aromatic = np.zeros((n, n), np.int64)
        for i in range(n):
            aromatic[i, (i + 1) % n] = aromatic[(i + 1) % n, i] = 4
        cases += [(name, pos, v, None), (f'{name}_bonds', pos, v, aromatic)]
    return cases


def _reconstruct(module, mol_module, smiles_module, pos, v, bond):
    try:
        m = module.mol_record_from_prediction(pos, v, bond)
    except module.MolReconsError as e:
        return {'error': str(e)}
    return {'fields': {k: getattr(m, k) for k in (
                'element', 'pos', 'bond_index', 'bond_type', 'aromatic',
                'charges')},
            'connected': module.is_connected(m),
            'sdf': mol_module.mol_to_sdf_block(m),
            'smiles': smiles_module.mol_to_smiles(m),
            'smiles_in_order': smiles_module.mol_to_smiles(m, False)}


@pytest.mark.parametrize('case', _predictions(), ids=lambda c: c[0])
def test_reconstruction_matches_jax(case):
    _, pos, v, bond = case
    got = _reconstruct(builder, mol, smiles, pos, v, bond)
    want = _reconstruct(jax_builder, jax_mol, jax_smiles, pos, v, bond)
    assert_same(got, want)


def test_reconstruction_cases_cover_both_outcomes():
    outcomes = [_reconstruct(builder, mol, smiles, *c[1:])
                for c in _predictions()]
    assert any('error' in o for o in outcomes)
    assert any(o.get('connected') for o in outcomes)
    assert any('c1' in o.get('smiles', '') for o in outcomes)   # aromatic


def test_sdf_block_parses_back():
    pos, v = _ring(6, 1.39, [6] * 6)
    m = builder.mol_record_from_prediction(pos, v)
    block = mol.mol_to_sdf_block(m, name='ring')
    for module in (mol, jax_mol):
        back = module.parse_mol_block(block)
        np.testing.assert_array_equal(back.element, m.element)
        np.testing.assert_allclose(back.pos, m.pos, atol=1e-4)
        np.testing.assert_array_equal(back.bond_type, m.bond_type)

