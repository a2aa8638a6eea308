"""Data parallelism in the port (decompdiff_tpu_torch/parallel/mesh.py) on
the CPU: W = 2 gloo ranks, each a spawned process with one torch thread,
rendezvous through a file:// store under the test's tmp path, against one
process and against the JAX package's 8-device mesh.

Tolerances, those of the JAX package's own data-parallel tests:
  * gradients of one step against JAX over shard_batch(batch,
    make_mesh(8)): rtol 2e-3 / atol 1e-4 * max(1, max |JAX gradient|)
    (tests/test_torch_train.py), losses rtol 1e-5;
  * 20-step trajectories, 2 ranks against 1 (tests/test_multichip_deep.py):
    loss and grad norm rtol 5e-3, lt_history rtol 5e-3 / atol 1e-7,
    parameters rtol 5e-3 / atol 2e-3, lt_count exactly equal;
  * sampling (tests/test_sampler.py): positions rtol 1e-4 / atol 1e-5,
    types and bonds exactly equal.

Each multi-rank run is one run_ranks call with its own timeout, after
which its ranks are killed.
"""

import copy
import glob
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from decompdiff_tpu_torch.config import Config
from decompdiff_tpu_torch.data.batch import FullProtein
from decompdiff_tpu_torch.data.synthetic import write_synthetic_store
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, all_reduce_mean, choose_backend, draw_rows,
    make_mesh, shard_batch, take_rows)
from decompdiff_tpu_torch.sampling import driver as sample_driver
from decompdiff_tpu_torch.sampling.sampler import (
    SampleConfig, sample_diffusion)
from decompdiff_tpu_torch.training import driver as train_driver
from decompdiff_tpu_torch.training.train_step import (
    create_train_state, make_train_fns, weighted_loss)
from decompdiff_tpu_torch.utils.params import state_dict_to_flax
from decompdiff_tpu_torch.utils.testing import (
    random_complex_batch, run_ranks, tiny_model_config)
from tests.test_integration import TINY_SAMPLE_YML, TINY_TRAIN_YML

torch.set_num_threads(2)
W = 2
TIMEOUT = 240.0
TRAIN_CFG = {
    'loss_weights': {'pos': 1.0, 'v': 100.0, 'bond': 100.0},
    'pos_noise_std': 0.1,
    'prior_noise_std': 0.5,
    'max_grad_norm': 8.0,
    'optimizer': {'lr': 5e-4, 'beta1': 0.95, 'beta2': 0.999},
    'sample_time_method': 'importance',
}
# one step against JAX (the batch of tests/test_torch_train.py at B = 8, so
# that it shards over JAX's 8 CPU devices)
GRAD_T = 20
GRAD_BATCH = dict(batch_size=8, num_protein=16, num_ligand=6, real_ligand=5)
GRAD_TIME_STEP = np.array([0, 7, 12, 19, 3, 11, 5, 16])
# the trajectories (tests/test_multichip_deep.py): T = 4, so that the
# importance gate opens mid-run
TRAJ_T, TRAJ_STEPS, ACC_STEPS = 4, 20, 10
TRAJ_BATCH = dict(batch_size=8, num_protein=16, num_ligand=6)
TRAJ_TOL = dict(rtol=5e-3)
PARAM_TOL = dict(rtol=5e-3, atol=2e-3)
POS_TOL = dict(rtol=1e-4, atol=1e-5)
ITERS = 4


def _grad_noise():
    rng = np.random.default_rng(3)
    B, Nl = GRAD_BATCH['batch_size'], GRAD_BATCH['num_ligand']
    b = np.triu(rng.integers(0, 5, size=(B, Nl, Nl)), 1)
    return {'pos_noise': rng.normal(size=(B, Nl, 3)).astype(np.float32),
            'v_perturbed': rng.integers(0, 8, size=(B, Nl)).astype(np.int32),
            'b_perturbed': (b + b.transpose(0, 2, 1)).astype(np.int32)}


def _state_dict(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.denoiser.state_dict().items()}


# ---------------------------------------------------------------------------
# what one rank (or, with mesh None, one process) computes
# ---------------------------------------------------------------------------

def _one_step_grads(mesh):
    """The all-reduced weighted-loss gradients and losses of one step with
    injected draws (global noise, this rank's t)."""
    model = DecompDiffModel.create(tiny_model_config(
        num_diffusion_timesteps=GRAD_T), 8, device='cpu', seed=0)
    batch = shard_batch(random_complex_batch(
        np.random.default_rng(0), device='cpu', **GRAD_BATCH), mesh)
    out = model.get_diffusion_loss(
        batch, time_step=take_rows(torch.as_tensor(GRAD_TIME_STEP), mesh),
        noise_override={k: torch.as_tensor(v)
                        for k, v in _grad_noise().items()}, mesh=mesh)
    loss = weighted_loss(out['losses'], TRAIN_CFG['loss_weights'])
    names = [n for n, _ in model.denoiser.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        loss, list(model.denoiser.parameters()))))
    grads = all_reduce_mean(grads, mesh)
    losses = all_reduce_mean(out['losses'], mesh)
    return ({k: v.numpy() for k, v in grads.items()},
            {k: v.item() for k, v in losses.items()})


def _trajectory(mesh, n_acc, steps):
    """`steps` optimizer steps in importance mode from the seeded model:
    fused train steps, or n_acc micro-batches of grad_step then
    apply_grads; per step the loss (the last micro-batch's), the grad norm
    and the Lt buffers; then the parameters."""
    cfg = dict(TRAIN_CFG, n_acc_batch=n_acc)
    model = DecompDiffModel.create(tiny_model_config(
        num_diffusion_timesteps=TRAJ_T), 8, device='cpu', seed=0)
    state = create_train_state(model, cfg)
    train_step, grad_step, apply_grads = make_train_fns(
        model, cfg, **({} if mesh is None else {'mesh': mesh}))
    micros = [shard_batch(random_complex_batch(
        np.random.default_rng(seed), device='cpu', **TRAJ_BATCH), mesh)
              for seed in range(n_acc)]
    g = torch.Generator().manual_seed(7)
    recs = []
    for _ in range(steps):
        if n_acc == 1:
            m = train_step(state, micros[0], g)
            loss, norm = float(m['loss']), float(m['grad_norm'])
        else:
            gsum, ts, ps = None, [], []
            for mb in micros:
                gr, m, t, p = grad_step(state, mb, g)
                gsum = gr if gsum is None else {k: gsum[k] + v
                                               for k, v in gr.items()}
                ts.append(t)
                ps.append(p)
            norm = float(apply_grads(state, gsum, torch.cat(ts),
                                     torch.cat(ps), m))
            loss = float(m['loss'])
        recs.append({'loss': loss, 'grad_norm': norm,
                     'lt_history': state.lt_history.numpy().copy(),
                     'lt_count': state.lt_count.numpy().copy()})
    return recs, _state_dict(model)


def _sampler_inputs():
    model = DecompDiffModel.create(tiny_model_config(
        num_diffusion_timesteps=20), 8, device='cpu', seed=0)
    rng = np.random.default_rng(13)
    batch = random_complex_batch(rng, batch_size=8, num_protein=20,
                                 num_ligand=6, device='cpu')
    fp = FullProtein(
        pos=torch.as_tensor(rng.normal(size=(8, 30, 3)) * 5,
                            dtype=torch.float32),
        mask=torch.ones((8, 30), dtype=torch.bool))
    cfg = SampleConfig(
        num_steps=10, save_traj=True,
        energy_drift=({'type': 'armsca_prox', 'min_d': 1.2, 'max_d': 1.9},
                      {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0},
                      {'type': 'center_prox'}))
    K, Kb = model.atom_diff.num_classes, model.bond_diff.num_classes
    noise = dict(pos_eps=rng.normal(size=(10, 8, 6, 3)),
                 v_uniform=rng.random((10, 8, 6, K)),
                 b_uniform=rng.random((10, 8, 6, 6, Kb)))
    noise = {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in noise.items()}
    return model, cfg, batch, fp, noise


def _sample(mesh):
    """sample_diffusion with clash guidance from the generator's draws and
    from injected (global) ones; the gathered pos / v / bond / trajectory."""
    model, cfg, batch, fp, noise = _sampler_inputs()
    kw = {} if mesh is None else {'mesh': mesh}
    batch, fp = shard_batch(batch, mesh), shard_batch(fp, mesh)
    outs = {}
    for name, extra in (('generator', {
            'generator': torch.Generator().manual_seed(2)}),
            ('override', {'noise_override': noise})):
        out = sample_diffusion(model, cfg, batch, batch.ligand_pos,
                               batch.ligand_v, batch.bond_type, fp,
                               **extra, **kw)
        got = {k: out[k] for k in ('pos', 'v', 'bond')}
        got['traj_pos'] = out['traj']['pos']
        got = {k: all_gather_rows(v, mesh, dim=1 if k == 'traj_pos' else 0)
               for k, v in got.items()}
        outs[name] = {k: v.numpy() for k, v in got.items()}
    return outs


def _steps_rank(mesh):
    return {'grads': _one_step_grads(mesh),
            'trajectory': _trajectory(mesh, 1, TRAJ_STEPS),
            'accumulation': _trajectory(mesh, 2, ACC_STEPS),
            'sample': _sample(mesh)}


def _drivers_rank(mesh, train_cfg, sample_cfg, ckpt, work):
    """Both entry points on the ranks: the trainer at batch 4 (2 rows a
    rank) and at batch 3 (unsharded), the sampler from `ckpt`."""
    out = {}
    for tag, bs in (('sharded', 4), ('unsharded', 3)):
        cfg = copy.deepcopy(train_cfg)
        cfg['train']['batch_size'] = bs
        args = train_driver.build_parser().parse_args([
            'train.yml', '--outdir', os.path.join(work, f'train_w2_{tag}'),
            '--device', 'cpu', '--max_iters', str(ITERS), '--val_freq',
            str(ITERS)])
        out[tag] = train_driver.run(args, Config(cfg), mesh)
    args = sample_driver.build_parser().parse_args([
        'sample.yml', '--ckpt', ckpt, '-i', '0', '1', '--outdir',
        os.path.join(work, 'sample_w2'), '--batch_size', '4', '--device',
        'cpu'])
    out['sample'] = sample_driver.run(args, Config(sample_cfg), mesh)
    return out


# ---------------------------------------------------------------------------
# fixtures: one two-rank run each
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def steps(tmp_path_factory):
    d = tmp_path_factory.mktemp('dp_steps')
    ranks = run_ranks(_steps_rank, W, str(d / 'rendezvous'),
                      timeout=TIMEOUT)
    return ranks, _steps_rank(None)


@pytest.fixture(scope='module')
def drivers(tmp_path_factory):
    """A store of 6 pockets, the tiny configs, a world-of-one run of each
    entry point, and the same on two ranks."""
    d = tmp_path_factory.mktemp('dp_drivers')
    store = str(d / 'synth.ddstore')
    write_synthetic_store(store, [{}] * 6, seed=0)
    train_cfg = yaml.safe_load(TINY_TRAIN_YML.format(store=store))
    sample_cfg = yaml.safe_load(TINY_SAMPLE_YML.format(store=store))
    one = {}
    for tag, bs in (('sharded', 4), ('unsharded', 3)):
        cfg = copy.deepcopy(train_cfg)
        cfg['train']['batch_size'] = bs
        args = train_driver.build_parser().parse_args([
            'train.yml', '--outdir', str(d / f'train_w1_{tag}'), '--device',
            'cpu', '--max_iters', str(ITERS), '--val_freq', str(ITERS)])
        one[tag] = train_driver.run(args, Config(cfg))
    ckpt = one['sharded']['checkpoints'][-1]
    args = sample_driver.build_parser().parse_args([
        'sample.yml', '--ckpt', ckpt, '-i', '0', '1', '--outdir',
        str(d / 'sample_w1'), '--batch_size', '4', '--device', 'cpu'])
    one['sample'] = sample_driver.run(args, Config(sample_cfg))
    ranks = run_ranks(_drivers_rank, W, str(d / 'rendezvous'),
                      (train_cfg, sample_cfg, ckpt, str(d)),
                      timeout=TIMEOUT)
    return one, ranks


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def test_two_rank_grads_match_jax_mesh(steps):
    """The W = 2 all-reduced gradients and losses of one step against the
    JAX package's gradients of the same loss over its batch sharded on 8
    devices."""
    import jax
    import jax.numpy as jnp

    from decompdiff_tpu.models.diffusion_model import DecompDiffModel as Jax
    from decompdiff_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from decompdiff_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from decompdiff_tpu.utils.testing import (
        random_complex_batch as jax_random_complex_batch)
    from decompdiff_tpu_torch.utils.params import flax_to_state_dict

    assert jax.device_count() >= 8
    model = Jax.create(tiny_model_config(num_diffusion_timesteps=GRAD_T), 8)
    params = state_dict_to_flax(DecompDiffModel.create(
        tiny_model_config(num_diffusion_timesteps=GRAD_T), 8, device='cpu',
        seed=0).denoiser.state_dict())
    params = jax.tree.map(jnp.asarray, params)
    batch = jax_shard_batch(jax_random_complex_batch(
        np.random.default_rng(0), **GRAD_BATCH), jax_make_mesh(8))
    w = TRAIN_CFG['loss_weights']

    def f(params):
        out = model.get_diffusion_loss(
            params, jax.random.PRNGKey(1), batch,
            time_step=jnp.asarray(GRAD_TIME_STEP),
            noise_override=_grad_noise())
        ls = out['losses']
        return sum(w[k] * ls[k] for k in ls), ls

    (_, want_losses), want = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    want = flax_to_state_dict(jax.tree.map(np.asarray, want))
    ranks, _ = steps
    for grads, losses in (r['grads'] for r in ranks):
        assert sorted(losses) == sorted(want_losses)
        for k, v in losses.items():
            np.testing.assert_allclose(v, float(want_losses[k]), rtol=1e-5,
                                       err_msg=k)
        got = flax_to_state_dict(state_dict_to_flax(
            {k: torch.as_tensor(v) for k, v in grads.items()}))
        assert sorted(got) == sorted(want)
        for name in want:
            wv = want[name].numpy()
            scale = max(1.0, float(np.abs(wv).max()))
            np.testing.assert_allclose(got[name].numpy(), wv, rtol=2e-3,
                                       atol=1e-4 * scale, err_msg=name)
    # the all-reduce leaves the ranks with the same bits
    for name in ranks[0]['grads'][0]:
        assert np.array_equal(ranks[0]['grads'][0][name],
                              ranks[1]['grads'][0][name]), name


def _assert_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize('case', ['trajectory', 'accumulation'])
def test_two_rank_trajectory_equals_one(steps, case):
    """20 importance-sampled steps (T = 4, B = 8), and 10 steps of two
    accumulated micro-batches, on 2 ranks against 1: per step the loss and
    grad norm, the Lt buffers (counts exactly), then the parameters; both
    ranks hold the same parameters."""
    ranks, one = steps
    want_recs, want_params = one[case]
    for got_recs, got_params in (r[case] for r in ranks):
        for i, (a, b) in enumerate(zip(want_recs, got_recs)):
            np.testing.assert_allclose(b['loss'], a['loss'], **TRAJ_TOL,
                                       err_msg=f'loss at step {i}')
            np.testing.assert_allclose(b['grad_norm'], a['grad_norm'],
                                       **TRAJ_TOL,
                                       err_msg=f'grad norm at step {i}')
            np.testing.assert_array_equal(b['lt_count'], a['lt_count'],
                                          err_msg=f'lt_count at step {i}')
            np.testing.assert_allclose(b['lt_history'], a['lt_history'],
                                       rtol=5e-3, atol=1e-7,
                                       err_msg=f'lt_history at step {i}')
        _assert_params(got_params, want_params)
    for k, v in ranks[0][case][1].items():
        assert np.array_equal(v, ranks[1][case][1][k]), k
    counts = [r['lt_count'] for r in want_recs]
    B = TRAJ_BATCH['batch_size']
    if case == 'trajectory':
        # the importance gate opened inside the run: both branches ran
        assert (counts[-1] > 10).all() and not (counts[4] > 10).all()
    else:
        assert counts[-1].sum() == ACC_STEPS * 2 * B


def test_two_rank_sampler_equals_one(steps):
    """sample_diffusion with armsca_prox, clash and center_prox guidance
    on 2 ranks (each its rows of the batch and of the full protein) against
    1, from the generator's draws and from injected global draws."""
    ranks, one = steps
    for name in ('generator', 'override'):
        want = one['sample'][name]
        for r in ranks:
            got = r['sample'][name]
            for k in ('pos', 'traj_pos'):
                np.testing.assert_allclose(got[k], want[k], **POS_TOL,
                                           err_msg=f'{name} {k}')
            np.testing.assert_array_equal(got['v'], want['v'])
            np.testing.assert_array_equal(got['bond'], want['bond'])


def _ckpt(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def _flat(params, prefix=''):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}/'))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_train_driver_two_ranks_equals_one(drivers):
    """The training entry point on 2 ranks at batch 4 (2 rows a rank): the
    losses and grad norms per iteration, the checkpoint's parameters and
    Lt buffers against one process; only rank 0 wrote the run directory,
    and the summary holds each rank's launches and step seconds."""
    one, ranks = drivers
    want, got = one['sharded'], ranks[0]['sharded']
    assert got['world_size'] == W and got['backend'] == 'gloo'
    assert got['sharded'] and [r['rank'] for r in got['ranks']] == [0, 1]
    assert all(len(r['step_seconds']) == ITERS for r in got['ranks'])
    assert got['iterations'] == want['iterations'] == list(
        range(1, ITERS + 1))
    np.testing.assert_allclose(got['train_loss'], want['train_loss'],
                               **TRAJ_TOL)
    np.testing.assert_allclose(got['grad_norm'], want['grad_norm'],
                               **TRAJ_TOL)
    assert ranks[1]['sharded']['train_loss'] == got['train_loss']
    assert [Path(p).name for p in got['checkpoints']] == [
        Path(p).name for p in want['checkpoints']] == [f'{ITERS}.ckpt']
    a, b = _ckpt(want['checkpoints'][-1]), _ckpt(got['checkpoints'][-1])
    assert a['iteration'] == b['iteration'] == ITERS
    fa, fb = _flat(a['params']), _flat(b['params'])
    _assert_params(fb, fa)
    np.testing.assert_array_equal(b['lt_count'], a['lt_count'])
    np.testing.assert_allclose(b['lt_history'], a['lt_history'], rtol=5e-3,
                               atol=1e-7)
    log_dir = got['log_dir']
    assert ranks[1]['sharded']['log_dir'] == log_dir
    assert len(glob.glob(os.path.join(os.path.dirname(log_dir),
                                      'train_*'))) == 1
    log = Path(log_dir, 'log.txt').read_text()
    assert 'data-parallel over 2 ranks (rank 0 of 2' in log
    assert 'backend gloo' in log


def test_train_driver_undivided_batch_runs_unsharded(drivers):
    """Batch 3 does not divide over 2 ranks: each rank runs the whole
    batch without collectives, as the JAX script does, and says so."""
    one, ranks = drivers
    want, got = one['unsharded'], ranks[0]['unsharded']
    assert not got['sharded'] and got['world_size'] == W
    assert all(shape[0] == 3 for shape in got['batch_shapes'])
    np.testing.assert_allclose(got['train_loss'], want['train_loss'],
                               **TRAJ_TOL)
    log = Path(got['log_dir'], 'log.txt').read_text()
    assert '2 ranks but batch_size 3 not divisible — running unsharded' in log
    assert not any(r['comm'].get('all_reduce') for r in got['ranks'])


def test_sample_driver_two_ranks_equals_one(drivers):
    """The sampling entry point on 2 ranks at batch 4 (2 rows a rank)
    against one process: the result pickles (positions at the sampling
    tolerance, types and bonds exactly), written by rank 0 alone."""
    one, ranks = drivers
    want, got = one['sample'], ranks[0]['sample']
    assert [s['rows'] for s in got] == [[2], [2]]
    assert [s['rows'] for s in ranks[1]['sample']] == [[2], [2]]
    assert [s['rows'] for s in want] == [[4], [4]]
    for w, g in zip(want, got):
        a = sample_driver.load_result(w['path'])['results']
        b = sample_driver.load_result(g['path'])['results']
        assert len(a) == len(b) == 4
        for ra, rb in zip(a, b):
            np.testing.assert_allclose(rb['pred_pos'], ra['pred_pos'],
                                       **POS_TOL)
            np.testing.assert_array_equal(rb['pred_v'], ra['pred_v'])
            np.testing.assert_array_equal(rb['pred_bond'], ra['pred_bond'])
            assert rb['smiles'] == ra['smiles']


def test_shard_batch_every_field():
    """Rank 1 of 2 holds rows 4..7 of every field of a ComplexBatch (the
    optional update mask too) and of a FullProtein; the padding stays the
    global batch's; a batch that does not divide is refused."""
    batch = random_complex_batch(np.random.default_rng(0), batch_size=8,
                                 device='cpu')
    batch = batch.replace(ligand_update_mask=batch.ligand_mask.clone())
    mesh = Mesh(1, 2, 1, torch.device('cpu'), None)
    part = shard_batch(batch, mesh)
    for name in vars(batch):
        assert torch.equal(getattr(part, name), getattr(batch, name)[4:8]), \
            name
    assert (part.num_protein_atoms, part.num_ligand_atoms,
            part.num_groups) == (batch.num_protein_atoms,
                                 batch.num_ligand_atoms, batch.num_groups)
    fp = FullProtein(pos=torch.randn(8, 5, 3),
                     mask=torch.ones(8, 5, dtype=torch.bool))
    fp_part = shard_batch(fp, mesh)
    assert torch.equal(fp_part.pos, fp.pos[4:]) and torch.equal(
        fp_part.mask, fp.mask[4:])
    with pytest.raises(ValueError, match='do not divide'):
        shard_batch(random_complex_batch(np.random.default_rng(0),
                                         batch_size=3, device='cpu'), mesh)
    # the draws: the global batch's, this rank's rows
    g0, g1 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    full = torch.rand((8, 3), generator=g0)
    mine = draw_rows(lambda s: torch.rand(s, generator=g1), (4, 3), mesh)
    assert torch.equal(mine, full[4:]) and torch.equal(
        g0.get_state(), g1.get_state())
    assert torch.equal(take_rows(full, mesh), full[4:])


def test_world_of_one_starts_no_process_group(monkeypatch):
    """Without torchrun's environment: a world of one on the named device,
    no process group, collectives that return their inputs; without a GPU
    and a device named, the mesh raises as the entry points do."""
    for key in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE'):
        monkeypatch.delenv(key, raising=False)
    mesh = make_mesh(device='cpu')
    assert (mesh.rank, mesh.world_size, mesh.backend, mesh.distributed) == (
        0, 1, None, False)
    assert not torch.distributed.is_initialized()
    x = {'a': torch.arange(3.0)}
    assert all_reduce_mean(x, mesh)['a'] is x['a']
    assert all_gather_rows(x['a'], mesh) is x['a']
    batch = random_complex_batch(np.random.default_rng(0), device='cpu')
    assert shard_batch(batch, mesh) is batch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()


@pytest.mark.parametrize('n', [1, 2, 3, 5, 320, 512])
def test_rowwise_sum(n):
    """The protein centroid's sum (models/diffusion_model.py rowwise_sum)
    is a sum over the axis, row by row, at any length; a batch's half
    centers as it does in the whole batch."""
    from decompdiff_tpu_torch.models.diffusion_model import (
        center_by_protein, rowwise_sum)
    x = torch.randn(4, n, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(n))
    torch.testing.assert_close(rowwise_sum(x, 1), x.sum(1))
    torch.testing.assert_close(rowwise_sum(x, -2), x.sum(1))
    batch = random_complex_batch(np.random.default_rng(n), batch_size=4,
                                 num_protein=n, real_protein=max(1, n - 1),
                                 device='cpu')
    whole = center_by_protein(batch, batch.ligand_pos)[2]
    half = center_by_protein(batch.replace(
        protein_pos=batch.protein_pos[2:],
        protein_mask=batch.protein_mask[2:]), batch.ligand_pos[2:])[2]
    assert torch.equal(half, whole[2:])
    mask = batch.protein_mask[..., None].float()
    torch.testing.assert_close(
        whole, (batch.protein_pos * mask).sum(1) / mask.sum(1))


def test_rank_launches_read_as_chip_smoke_counts():
    """A rank's launch counts (ops.launches_since, which the drivers'
    summaries carry) read as chip_smoke.py's kernel records: both take
    their names from the one list, ops.launch_counters."""
    import chip_smoke
    from decompdiff_tpu_torch.ops import (
        launch_counters, launch_counts, launches_since, zero_launch_counts)
    from decompdiff_tpu_torch.ops.triplet_attention import (
        triplet_attention_backward)
    start = launch_counts()
    counters = launch_counters()
    saved = {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}
    by_nl = dict(triplet_attention_backward.nl_launches)
    records = [*counters, chip_smoke.TOP_RECORD]
    try:
        zero_launch_counts()
        assert chip_smoke.get_launches() == dict.fromkeys(records, 0)
        before = launch_counts()
        for i, (fn, attr) in enumerate(counters.values()):
            setattr(fn, attr, getattr(fn, attr) + i + 1)
        triplet_attention_backward.nl_launches[
            chip_smoke.TRIPLET_HEAD_NL] = 7
        rank = launches_since(before)
        want = {n: i + 1 for i, n in enumerate(counters)}
        want[chip_smoke.TOP_RECORD] = 7
        assert chip_smoke.get_launches(rank) == chip_smoke.get_launches() \
            == want
        assert launches_since(launch_counts()) == {}
    finally:
        for n, (fn, attr) in counters.items():
            setattr(fn, attr, saved[n])
        triplet_attention_backward.nl_launches = by_nl
    assert launch_counts() == start


def test_dp_rows_match_the_whole_batch_on_cpu():
    """utils/testing.py dp_row_pairs (which the card test and chip_smoke.py
    hold at the entry point's shapes) at the tiny config: each stage of a
    guided sampling step on two ranks' rows against the whole batch, within
    rtol = atol = 1e-5."""
    from decompdiff_tpu_torch.utils.testing import dp_row_pairs
    model, _, batch, fp, _ = _sampler_inputs()
    t = torch.full((8,), 15, dtype=torch.long)
    pairs = dp_row_pairs(model, batch, fp, t)
    assert len(pairs) == 6
    for stage, (whole, halves) in pairs.items():
        torch.testing.assert_close(halves, whole, rtol=1e-5, atol=1e-5,
                                   msg=stage)


def test_backend_rule():
    """NCCL when every rank has its own GPU; gloo on the CPU and when ranks
    share a GPU."""
    cuda, cpu = torch.device('cuda', 0), torch.device('cpu')
    assert choose_backend(cuda, 1, 1)[0] == 'nccl'
    assert choose_backend(cuda, 4, 4)[0] == 'nccl'
    assert choose_backend(cuda, 2, 1)[0] == 'gloo'
    assert choose_backend(cpu, 2, 0)[0] == 'gloo'
