"""The port's sampling entry point (decompdiff_tpu_torch/sampling/driver.py)
against the JAX script (scripts/sample.py), end to end on the CPU: a
synthetic pocket store, a JAX-layout checkpoint, a tiny config, a few
strided steps with guidance.

With the same injected noise in both samplers:
  * the batches (records, padding, initial types) are exactly equal;
  * atom and bond types are exactly equal;
  * positions agree at rtol 1e-4 / atol 1e-5 (tests/test_torch_sampler.py:
    each step adds the denoiser's float32 reduction-order differences);
  * the result pickles have the same keys and the same molecules.
"""

import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decompdiff_tpu.sampling.sampler as jax_sampler
from decompdiff_tpu.data.mol import MolRecord as JaxMolRecord
from decompdiff_tpu.evaluation.eval_bond_length import bond_distances_from_mol
from decompdiff_tpu.evaluation.scoring import get_chem
from decompdiff_tpu_torch.data.synthetic import write_synthetic_store
from decompdiff_tpu_torch.guidance import ffmin
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.sampling import driver
from decompdiff_tpu_torch.utils.params import state_dict_to_flax
from decompdiff_tpu_torch.utils.testing import tiny_model_config

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
POS_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS, NUM_SAMPLES, BATCH = 3, 3, 2
SAMPLE_YML = """
data:
  path: {store}
sample:
  seed: 2021
  prior_mode: ref_prior
  num_samples: {num_samples}
  num_steps: {steps}
  skip_mode: strided
  sample_num_atoms: ref
  energy_drift:
{drift}
"""
GUIDANCE = """    - type: armsca_prox
      min_d: 1.2
      max_d: 1.9
    - type: clash
      sigma: 2
      gamma: 4
"""


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """A store of 3 synthetic pockets, a JAX-layout checkpoint of a seeded
    tiny uni_o2_bond model and the sampling config."""
    d = tmp_path_factory.mktemp('driver')
    store = str(d / 'synth.ddstore')
    write_synthetic_store(store, [{}] * 3, seed=0)
    cfg = tiny_model_config(num_diffusion_timesteps=20)
    model = DecompDiffModel.create(cfg, 8, device='cpu', seed=0)
    ckpt = str(d / 'model.ckpt')
    with open(ckpt, 'wb') as f:
        pickle.dump({'config': {'data': {'transform': {
                         'ligand_atom_mode': 'basic'}}, 'model': cfg},
                     'params': state_dict_to_flax(model.denoiser.state_dict()),
                     'step': 0, 'iteration': 0}, f, protocol=4)
    from tests.test_data_layer import PDB_BLOCK
    (d / 'full.pdb').write_text(PDB_BLOCK)
    yml = str(d / 'sample.yml')
    Path(yml).write_text(SAMPLE_YML.format(
        store=store, num_samples=NUM_SAMPLES, steps=STEPS, drift=GUIDANCE))
    return d, yml, ckpt


def _noise(call, steps, B, Nl, K, Kb):
    rng = np.random.default_rng(1000 + call)
    return dict(
        pos_eps=rng.normal(size=(steps, B, Nl, 3)).astype(np.float32),
        v_uniform=rng.random((steps, B, Nl, K)).astype(np.float32),
        b_uniform=rng.random((steps, B, Nl, Nl, Kb)).astype(np.float32))


def _run_jax_script(argv, monkeypatch, seen):
    """scripts/sample.py main() in this process, its sampler given the
    injected noise; records each call's batch and initial state."""
    orig = jax_sampler.sample_diffusion

    def sample(model, cfg, params, rng, batch, init_pos, init_v, init_bond,
               full_protein=None):
        B, Nl = np.shape(init_v)
        noise = _noise(len(seen), cfg.num_steps, B, Nl,
                       model.atom_diff.num_classes,
                       model.bond_diff.num_classes)
        seen.append({k: np.asarray(v) for k, v in vars(batch).items()})
        return orig(model, cfg, params, rng, batch, init_pos, init_v,
                    init_bond, full_protein,
                    noise_override={k: jnp.asarray(v)
                                    for k, v in noise.items()})

    monkeypatch.setattr(jax_sampler, 'sample_diffusion', sample)
    spec = importlib.util.spec_from_file_location(
        'jax_sample_script', REPO / 'scripts' / 'sample.py')
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, 'argv', ['sample.py'] + argv)
    script.main()


def _run_port(argv, monkeypatch, seen):
    orig = driver.sample_diffusion

    def sample(model, cfg, batch, init_pos, init_v, init_bond,
               full_protein=None, generator=None):
        B, Nl = init_v.shape
        noise = _noise(len(seen), cfg.num_steps, B, Nl,
                       model.atom_diff.num_classes,
                       model.bond_diff.num_classes)
        seen.append({k: getattr(batch, k).numpy() for k in vars(batch)
                     if getattr(batch, k) is not None})
        return orig(model, cfg, batch, init_pos, init_v, init_bond,
                    full_protein,
                    noise_override={k: torch.as_tensor(v)
                                    for k, v in noise.items()})

    monkeypatch.setattr(driver, 'sample_diffusion', sample)
    return driver.main(argv)


def _load(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


@pytest.mark.parametrize('recon', ['auto', 'false'])
def test_driver_matches_jax_script(setup, monkeypatch, recon):
    """recon 'auto' reconstructs from the diffused bonds (a random model's
    fail the valence checks: the errors are compared), 'false' from the
    geometry (molecules come out: their SMILES are compared)."""
    d, yml, ckpt = setup
    # clash guidance against a full protein read from a PDB file
    common = [yml, '--ckpt', ckpt, '-i', '0', '2', '--batch_size',
              str(BATCH), '--save_traj', '--suffix', '_t',
              '--protein_path', str(d / 'full.pdb'),
              '--recon_with_bond', recon]
    jax_seen, port_seen = [], []
    jax_out, port_out = d / f'jax_{recon}', d / f'port_{recon}'
    _run_jax_script(common + ['--outdir', str(jax_out), '--no_pallas'],
                    monkeypatch, jax_seen)
    summaries = _run_port(common + ['--outdir', str(port_out),
                                    '--use_pallas', '--device', 'cpu'],
                          monkeypatch, port_seen)

    # two pockets of two batches each (the tail padded to the batch size)
    assert len(jax_seen) == len(port_seen) == 4
    for want, got in zip(jax_seen, port_seen):
        assert set(got) == {k for k, v in want.items() if v.shape}
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert [s['shapes'] for s in summaries] == [[(BATCH, 128, 16)] * 2] * 2

    molecules = errors = 0
    for data_id in (0, 2):
        name = f'result_{data_id}_t.pkl'
        want, got = _load(jax_out / name), _load(port_out / name)
        assert set(got) == set(want)
        assert got['data_id'] == data_id and got['atom_mode'] == 'basic'
        assert len(got['results']) == len(want['results']) == NUM_SAMPLES
        for w, g in zip(want['results'], got['results']):
            assert set(g) == set(w)
            for k in ('pred_v', 'pred_bond', 'decomp_mask', 'v_traj',
                      'bond_traj'):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            for k in ('pred_pos', 'pos_traj'):
                np.testing.assert_allclose(g[k], w[k], **POS_TOL, err_msg=k)
            for k in ('smiles', 'complete', 'recon_error',
                      'ligand_filename', 'protein_path'):
                assert g.get(k) == w.get(k), k
            assert (g['mol'] is None) == (w['mol'] is None)
            if w['mol'] is not None:
                assert g['sdf'] == w['sdf']
                molecules += 1
            errors += 'recon_error' in w
    # the geometry-only run compares molecules, the bond run its errors
    assert molecules > 0 if recon == 'false' else errors > 0


@pytest.fixture(scope='module')
def port_outdir(setup):
    """The port's own run (its generator's draws) of pockets 0 and 1, with
    geometry-only reconstruction so that molecules come out of a random
    model."""
    d, yml, ckpt = setup
    out = d / 'port_01'
    driver.main([yml, '--ckpt', ckpt, '-i', '0', '1', '--outdir', str(out),
                 '--batch_size', str(BATCH), '--device', 'cpu',
                 '--recon_with_bond', 'false'])
    return out


def test_per_pocket_reseed_is_bit_identical(setup, port_outdir):
    d, yml, ckpt = setup
    solo = d / 'port_1'
    driver.main([yml, '--ckpt', ckpt, '-i', '1', '--outdir', str(solo),
                 '--batch_size', str(BATCH), '--device', 'cpu',
                 '--recon_with_bond', 'false'])
    multi = _load(port_outdir / 'result_1.pkl')['results']
    alone = _load(solo / 'result_1.pkl')['results']
    assert len(multi) == len(alone) == NUM_SAMPLES
    for a, b in zip(multi, alone):
        for k in ('pred_pos', 'pred_v', 'pred_bond'):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a['smiles'] == b['smiles']
    # and pocket 0 differs from pocket 1 (the re-seed is per pocket, not a
    # repeat of one pocket's draws)
    first = _load(port_outdir / 'result_0.pkl')['results'][0]
    assert first['ligand_filename'] != multi[0]['ligand_filename']


def test_evaluate_scores_the_port_output(port_outdir):
    """The unedited scripts/evaluate.py reads the port's result pickles and
    counts every result; their molecules are the JAX package's MolRecords
    there, which its bond-length and chemistry scoring take."""
    counts = {'n_total': 0, 'n_recon': 0, 'n_complete': 0}
    for name in ('result_0.pkl', 'result_1.pkl'):
        for r in _load(port_outdir / name)['results']:
            counts['n_total'] += 1
            counts['n_recon'] += r['mol'] is not None
            counts['n_complete'] += bool(r['complete'])
            if r['mol'] is not None:
                assert isinstance(r['mol'], JaxMolRecord)
                assert bond_distances_from_mol(r['mol'])
                assert 0.0 < get_chem(r['mol'])['qed'] < 1.0
    assert counts['n_total'] == 2 * NUM_SAMPLES and counts['n_recon'] > 0

    env = dict(os.environ, JAX_PLATFORMS='cpu')
    proc = subprocess.run(
        [sys.executable, 'scripts/evaluate.py', str(port_outdir)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(port_outdir / 'eval_summary.pkl', 'rb') as f:
        summary = pickle.load(f)
    for k, v in counts.items():
        assert summary[k] == v, k


def test_port_reads_its_results_without_the_jax_package(port_outdir):
    """load_result reads the molecules as the port's MolRecord."""
    from decompdiff_tpu_torch.data.mol import MolRecord
    payload = driver.load_result(port_outdir / 'result_0.pkl')
    mols = [r['mol'] for r in payload['results'] if r['mol'] is not None]
    assert mols and all(type(m) is MolRecord for m in mols)


def test_port_molecules_score_as_in_the_jax_package(port_outdir):
    """The port's evaluation functions on the molecules the port sampled
    (read as the port's MolRecord) give the JAX package's answers on the
    same pickles read as its MolRecord: exactly (tests/
    test_torch_evaluation.py)."""
    from test_torch_evaluation import assert_same_scores  # pytest's path
    n = 0
    for name in ('result_0.pkl', 'result_1.pkl'):
        want = _load(port_outdir / name)['results']
        got = driver.load_result(port_outdir / name)['results']
        for w, g in zip(want, got):
            if w['mol'] is not None:
                assert_same_scores(w['mol'], g['mol'])
                n += 1
    assert n > 0


def _fake_chem(mol):
    return {'qed': 0.5, 'sa': 0.7, 'logp': 1.0, 'lipinski': 5}


@pytest.mark.parametrize('argv', [
    [],
    ['--docking_mode', 'vina_full'],
    ['--docking_mode', 'vina_full', '--num_workers', '1'],
    ['--docking_mode', 'vina_full', '-n', '10'],
], ids=['none', 'vina_full', 'vina_full_w1', 'vina_full_n10'])
def test_evaluate_torch_matches_the_jax_script(port_outdir, tmp_path,
                                               monkeypatch, argv):
    """scripts/evaluate_torch.py and the unedited scripts/evaluate.py, both
    in this process on the port's result pickles, write equal
    eval_summary.pkl. With docking: a fake Vina (tests/
    test_torch_evaluation.py), the receptors found under --protein_root
    from each result's ligand_filename, a reference-ligand pickle for High
    Affinity and a fixed chem function for the Success Rate."""
    from decompdiff_tpu.evaluation import docking as j_docking
    from decompdiff_tpu.evaluation import scoring as j_scoring
    from decompdiff_tpu_torch.evaluation import docking as p_docking
    from decompdiff_tpu_torch.evaluation import scoring as p_scoring
    from test_torch_evaluation import (  # tests/, on pytest's path
        PROTEIN, assert_same, install_fake_vina, write_anchor_results)
    # the port's results, whose molecules from a random model are mostly
    # disconnected, and a pickle of complete anchor molecules written by
    # the port's save_result, so that every phase scores molecules
    outdir = tmp_path / 'out'
    outdir.mkdir()
    for name in ('result_0.pkl', 'result_1.pkl'):
        shutil.copy(port_outdir / name, outdir / name)
    write_anchor_results(outdir / 'result_anchors.pkl', [
        'aniline', 'aspirin', 'chlorothiophene', 'paracetamol', 'pyridine',
        'sulfonamide', 'tbu_cf3_benzene', 'toluene'])
    argv = list(argv)
    if argv:
        install_fake_vina(monkeypatch, j_docking, p_docking)
        for mod in (j_scoring, p_scoring):
            monkeypatch.setattr(mod, 'can_score', lambda mol: True)
            monkeypatch.setattr(mod, 'get_chem', _fake_chem)
        root = tmp_path / 'proteins'
        ligands = {r['ligand_filename'] for f in outdir.glob('result_*.pkl')
                   for r in driver.load_result(f)['results']}
        for lig in ligands:
            pdb = (root / os.path.dirname(lig)
                   / (os.path.basename(lig)[:10] + '.pdb'))
            pdb.parent.mkdir(parents=True, exist_ok=True)
            pdb.write_text(PROTEIN)
        with open(tmp_path / 'ref_vina.pkl', 'wb') as f:
            pickle.dump({lig: -8.0 for lig in sorted(ligands)[:1]}, f)
        argv += ['--protein_root', str(root), '--tmp_dir', str(tmp_path),
                 '--ref_vina_pkl', str(tmp_path / 'ref_vina.pkl')]

    spec = importlib.util.spec_from_file_location(
        'jax_evaluate_script', REPO / 'scripts' / 'evaluate.py')
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    spec = importlib.util.spec_from_file_location(
        'port_evaluate_script', REPO / 'scripts' / 'evaluate_torch.py')
    port_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(port_script)

    out = str(outdir)
    want = jax_script.main([out, '--result_path',
                            str(tmp_path / 'jax.pkl')] + argv)
    got = port_script.main([out, '--result_path',
                            str(tmp_path / 'port.pkl')] + argv)
    assert_same(_load(tmp_path / 'jax.pkl'), _load(tmp_path / 'port.pkl'))
    assert_same(want, got)
    # -n 10 keeps the port's 6 results and the first 4 anchors
    assert got['n_total'] == (10 if '-n' in argv else 2 * NUM_SAMPLES + 8)
    assert got['n_complete'] >= (4 if '-n' in argv else 8)
    if argv:
        assert got['n_dock_success'] == got['n_complete']
        assert got['vina_metrics']['vina_dock_mean'] == -8.5
        assert got['success_rate'] == 1.0
        assert got['high_affinity'] == 1.0
    else:
        assert got['chem_backend'] == 'first_party'
        assert got['vina'] == [] and got['success_rate'] is None
        assert got['diversity'] is not None


def test_mmff_drift_runs_ffmin(setup, tmp_path, monkeypatch):
    """A config with the mmff_min drift is not refused: without RDKit the
    driver runs the first-party force-field drift (guidance/ffmin.py) in
    [end_time, start_time) and writes the result pickles. Strided over
    T = 20, the 3 steps start at t = 19, 10 and 0: two in [5, 20), for each
    of the two batches of a pocket."""
    d, yml, ckpt = setup
    mmff = tmp_path / 'mmff.yml'
    mmff.write_text(Path(yml).read_text().replace(
        '    - type: armsca_prox', '    - type: mmff_min\n'
        '      start_time: 20\n      end_time: 5\n'
        '    - type: armsca_prox'))
    made = []
    make = ffmin.make_ff_callback
    monkeypatch.setattr(ffmin, 'make_ff_callback',
                        lambda mode: made.append(mode) or make(mode))
    summaries = driver.main([str(mmff), '--ckpt', ckpt, '-i', '0', '1',
                             '--outdir', str(tmp_path), '--batch_size',
                             str(BATCH), '--device', 'cpu',
                             '--recon_with_bond', 'false'])
    assert made == ['basic']
    batches = -(-NUM_SAMPLES // BATCH)
    for s in summaries:
        assert s['drift_calls'] == 2 * batches
        assert 0 <= s['drift_relaxed'] <= s['drift_calls'] * BATCH
        assert 0.0 < s['drift_s'] < s['device_s']
        payload = driver.load_result(s['path'])
        assert len(payload['results']) == NUM_SAMPLES
        for r in payload['results']:
            assert np.isfinite(r['pred_pos']).all()


def test_default_device_needs_a_gpu(setup, tmp_path, monkeypatch):
    d, yml, ckpt = setup
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main([yml, '--ckpt', ckpt, '--outdir', str(tmp_path)])
