"""The port's training entry point (decompdiff_tpu_torch/training/driver.py)
against the JAX script (scripts/train.py), end to end on the CPU: a
synthetic pocket store and tests/test_integration.py's tiny config (hidden
32, 2 layers, 4 heads, knn 8, T = 20).

Both trainers resume from one JAX iteration-0 `.ckpt`, their loaders give
the same batches, and the step and validation draws (jitter, t, position
noise, perturbed types) are injected into both. Then, per iteration, the
train losses and learning rate agree at LOSS_TOL, the validation losses at
LOSS_TOL and the AUROCs at AUROC_ATOL, and the same iterations are saved.
Measured: largest relative difference 1.1e-6 (a position loss); the
AUROCs and learning rates equal.

The port alone: a straight run equals a run cut in two and resumed,
bitwise; an out-of-memory step is skipped and logged; with no device named
and no GPU the driver raises.
"""

import glob
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decompdiff_tpu.training.train_step as jts
from decompdiff_tpu.config import Config as JaxConfig
from decompdiff_tpu.utils.checkpoint import save_checkpoint
from decompdiff_tpu_torch.config import load_config
from decompdiff_tpu_torch.data.synthetic import write_synthetic_store
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.training import driver
from decompdiff_tpu_torch.utils.params import state_dict_to_flax
from tests.test_integration import TINY_TRAIN_YML

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
# the same float32 losses through another summation order, after a few Adam
# steps from the same gradients up to rounding
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
AUROC_ATOL = 1e-6
ITERS, VAL_FREQ = 4, 2
NOISE_KEYS = ('pos_noise', 'v_perturbed', 'b_perturbed')


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """The tiny config on a store of 6 pockets (one bucket: the last is the
    validation split) and a JAX iteration-0 checkpoint of it."""
    d = tmp_path_factory.mktemp('train_driver')
    store = str(d / 'synth.ddstore')
    write_synthetic_store(store, [{}] * 6, seed=0)
    yml = d / 'train.yml'
    yml.write_text(TINY_TRAIN_YML.format(store=store))
    config = JaxConfig(load_config(str(yml)).to_dict())
    # a JAX train state of freshly initialized weights (drawn by the port,
    # which is quicker than flax's init on the CPU)
    params = state_dict_to_flax(DecompDiffModel.create(
        config.model.to_dict(), 8, device='cpu', seed=7).denoiser.state_dict())
    tx = jts.make_optimizer(config.train.optimizer,
                            config.train.max_grad_norm)
    T = config.model.num_diffusion_timesteps
    state = jts.TrainState(step=jnp.asarray(0), params=params,
                           opt_state=tx.init(params),
                           lt_history=jnp.zeros((T,)),
                           lt_count=jnp.zeros((T,)))
    ckpt = str(d / '0.ckpt')
    save_checkpoint(ckpt, config.to_dict(), state,
                    jts.PlateauScheduler().state_dict(), 0)
    return d, str(yml), ckpt


def _draws(kind, index, shape, num_timesteps, with_jitter):
    """The injected draws of one call, from its kind and index."""
    B, Np, Nl, A = shape
    rng = np.random.default_rng([kind, index])
    b = np.triu(rng.integers(0, 5, size=(B, Nl, Nl)), 1)
    out = {'pos_noise': rng.normal(size=(B, Nl, 3)).astype(np.float32),
           'v_perturbed': rng.integers(0, 8, size=(B, Nl)).astype(np.int32),
           'b_perturbed': (b + b.transpose(0, 2, 1)).astype(np.int32)}
    if with_jitter:
        out.update(
            t=rng.integers(0, num_timesteps, size=B).astype(np.int32),
            protein=rng.normal(size=(B, Np, 3)).astype(np.float32),
            prior=rng.normal(size=(B, A, 3)).astype(np.float32))
    return out


class _Injected:
    """A model whose get_diffusion_loss takes the current draws: the
    positions jittered by them from the step's own batch, t and the noise.
    Everything else is the wrapped model's."""

    def __init__(self, model, current, std, as_array):
        self._model, self._current = model, current
        self._std, self._as_array = std, as_array

    def __getattr__(self, name):
        return getattr(self._model, name)

    def get_diffusion_loss(self, *args, time_step=None, noise_override=None):
        # JAX: (params, rng, batch); the port: (batch, generator)
        i = 2 if len(args) == 3 else 0
        batch, d, a = args[i], self._current['draws'], self._as_array
        if 't' in d:
            base = self._current['batch']
            batch = batch.replace(
                protein_pos=base.protein_pos + self._std[0] * a(d['protein']),
                prior_centers=base.prior_centers + self._std[1] * a(
                    d['prior']))
            time_step = a(d['t'])
        return self._model.get_diffusion_loss(
            *args[:i], batch, *args[i + 1:], time_step=time_step,
            noise_override={k: a(d[k]) for k in NOISE_KEYS})


def _shape(batch):
    return tuple(int(n) for n in (batch.protein_pos.shape[0],
                                  batch.protein_pos.shape[1],
                                  batch.ligand_pos.shape[1],
                                  batch.prior_centers.shape[1]))


def _jitter_std(train_cfg):
    return (float(train_cfg.get('pos_noise_std', 0.1)),
            float(train_cfg.get('prior_noise_std', 0.5)))


def _patch_jax(monkeypatch):
    """scripts/train.py's step and eval functions, jitted with the draws as
    arguments; each call takes the next draws."""
    orig_fns, orig_eval = jts.make_train_fns, jts.make_eval_step
    current, calls = {}, {'train': 0, 'eval': 0}

    def make_train_fns(model, tx, train_cfg):
        proxy = _Injected(model, current, _jitter_std(train_cfg),
                          jax.numpy.asarray)
        fn = orig_fns(proxy, tx, train_cfg)[0].__wrapped__

        @jax.jit
        def step(state, batch, draws):
            current.update(draws=draws, batch=batch)
            return fn(state, batch, jax.random.PRNGKey(0))

        def train_step(state, batch, rng):
            calls['train'] += 1
            return step(state, batch, _draws(
                0, calls['train'], _shape(batch), model.num_timesteps, True))
        return train_step, None, None

    def make_eval_step(model, train_cfg):
        proxy = _Injected(model, current, None, jax.numpy.asarray)
        fn = orig_eval(proxy, train_cfg).__wrapped__

        @jax.jit
        def ev(params, batch, t, draws):
            current.update(draws=draws, batch=batch)
            return fn(params, batch, t, jax.random.PRNGKey(0))

        def eval_step(params, batch, t, rng):
            calls['eval'] += 1
            return ev(params, batch, t, _draws(
                1, calls['eval'], _shape(batch), model.num_timesteps, False))
        return eval_step

    monkeypatch.setattr(jts, 'make_train_fns', make_train_fns)
    monkeypatch.setattr(jts, 'make_eval_step', make_eval_step)


def _patch_port(monkeypatch):
    """The port driver's step and eval functions, each call given the next
    draws."""
    orig_fns, orig_eval = driver.make_train_fns, driver.make_eval_step
    current, calls = {}, {'train': 0, 'eval': 0}

    def make_train_fns(model, train_cfg):
        proxy = _Injected(model, current, _jitter_std(train_cfg),
                          torch.as_tensor)
        step, grad_step, apply_grads = orig_fns(proxy, train_cfg)

        def train_step(state, batch, generator):
            calls['train'] += 1
            current.update(batch=batch, draws=_draws(
                0, calls['train'], _shape(batch), model.num_timesteps, True))
            return step(state, batch, generator)
        return train_step, grad_step, apply_grads

    def make_eval_step(model, train_cfg):
        ev = orig_eval(_Injected(model, current, None, torch.as_tensor),
                       train_cfg)

        def eval_step(batch, t, generator):
            calls['eval'] += 1
            current.update(batch=batch, draws=_draws(
                1, calls['eval'], _shape(batch), model.num_timesteps, False))
            return ev(batch, t, generator)
        return eval_step

    monkeypatch.setattr(driver, 'make_train_fns', make_train_fns)
    monkeypatch.setattr(driver, 'make_eval_step', make_eval_step)


def _records(log_dir):
    with open(os.path.join(log_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def _saved(log_dir):
    return sorted(int(Path(p).stem) for p in glob.glob(
        os.path.join(log_dir, 'checkpoints', '*.ckpt')))


def test_driver_matches_jax_script(setup, monkeypatch):
    d, yml, ckpt = setup
    common = [yml, '--resume', ckpt, '--max_iters', str(ITERS),
              '--val_freq', str(VAL_FREQ), '--report_freq', '1']
    _patch_jax(monkeypatch)
    spec = importlib.util.spec_from_file_location(
        'jax_train_script', REPO / 'scripts' / 'train.py')
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, 'argv', ['train.py', *common, '--outdir',
                                      str(d / 'jax')])
    script.main()
    jax_dir, = glob.glob(str(d / 'jax' / 'train_*'))

    _patch_port(monkeypatch)
    summary = driver.main([*common, '--outdir', str(d / 'port'),
                           '--device', 'cpu'])
    want, got = _records(jax_dir), _records(summary['log_dir'])
    assert [(r['step'], r['tag']) for r in got] == [
        (r['step'], r['tag']) for r in want] == [
        (1, 'train'), (2, 'train'), (2, 'val'), (3, 'train'), (4, 'train'),
        (4, 'val')]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in w:
            if k in ('step', 'tag', 'time'):
                continue
            if 'auroc' in k:
                assert abs(g[k] - w[k]) <= AUROC_ATOL, (w['step'], k)
            else:
                np.testing.assert_allclose(g[k], w[k], **LOSS_TOL,
                                           err_msg=f'{w["step"]} {k}')
    assert _saved(summary['log_dir']) == _saved(jax_dir)
    assert summary['iterations'] == list(range(1, ITERS + 1))
    np.testing.assert_allclose(
        summary['train_loss'], [r['loss'] for r in got if r['tag'] ==
                                'train'], rtol=1e-6)
    assert len(summary['eval_shapes']) == 2 * 10
    assert summary['batch_shapes'] == [(4, 128, 16, 4)] * ITERS


def _port_run(setup, monkeypatch, tmp_path, name, iters, resume=None):
    """A port run with the generator's own draws; returns the summary and
    the model, train state and generator of its last step."""
    d, yml, _ = setup
    seen = {}
    orig = driver.make_train_fns

    def make_train_fns(model, train_cfg):
        step, grad_step, apply_grads = orig(model, train_cfg)

        def train_step(state, batch, generator):
            seen.update(model=model, state=state, generator=generator)
            return step(state, batch, generator)
        return train_step, grad_step, apply_grads

    monkeypatch.setattr(driver, 'make_train_fns', make_train_fns)
    argv = [yml, '--outdir', str(tmp_path / name), '--device', 'cpu',
            '--max_iters', str(iters), '--val_freq', '3']
    if resume:
        argv += ['--resume', resume]
    return driver.main(argv), seen


@pytest.fixture(scope='module')
def one_record_store(setup):
    """A store of two pockets: the train split is one complex, so every
    batch is the same whatever the shuffle (a resumed run reseeds it by the
    resume iteration, as the JAX script does)."""
    d, yml, ckpt = setup
    store = str(d / 'two.ddstore')
    write_synthetic_store(store, [{}] * 2, seed=1)
    two = d / 'two.yml'
    two.write_text(Path(yml).read_text().replace(
        str(d / 'synth.ddstore'), store).replace('batch_size: 4',
                                                 'batch_size: 2'))
    return d, str(two), ckpt


def test_resume_is_bitwise(one_record_store, monkeypatch, tmp_path):
    """6 iterations straight equal 3, then 3 resumed from the checkpoint
    saved at 3: parameters, Adam state, lr, scheduler, Lt buffers and the
    generator, bitwise."""
    straight, a = _port_run(one_record_store, monkeypatch, tmp_path, 'a', 6)
    first, _ = _port_run(one_record_store, monkeypatch, tmp_path, 'b', 3)
    assert first['checkpoints'][-1].endswith('3.ckpt')
    second, b = _port_run(one_record_store, monkeypatch, tmp_path, 'c', 6,
                          resume=first['checkpoints'][-1])
    assert second['start_iter'] == 4 and second['iterations'] == [4, 5, 6]
    assert first['train_loss'] + second['train_loss'] == \
        straight['train_loss']
    assert second['scheduler'] == straight['scheduler']
    assert second['lr'] == straight['lr'][3:]
    sa, sb = a['state'], b['state']
    assert sa.step == sb.step == 6
    assert torch.equal(sa.lt_history, sb.lt_history)
    assert torch.equal(sa.lt_count, sb.lt_count)
    assert torch.equal(a['generator'].get_state(), b['generator'].get_state())
    for (name, p), q in zip(sa.optimizer.params.items(),
                            sb.optimizer.params.values()):
        assert torch.equal(p, q), name
        x, y = sa.optimizer.adam.state[p], sb.optimizer.adam.state[q]
        for k in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(x[k], y[k]), (name, k)


def test_out_of_memory_is_skipped(one_record_store, monkeypatch, tmp_path):
    d, yml, _ = one_record_store
    orig = driver.make_train_fns
    calls = []

    def make_train_fns(model, train_cfg):
        step, grad_step, apply_grads = orig(model, train_cfg)

        def train_step(state, batch, generator):
            calls.append(1)
            if len(calls) == 2:
                raise torch.cuda.OutOfMemoryError('CUDA out of memory.')
            return step(state, batch, generator)
        return train_step, grad_step, apply_grads

    monkeypatch.setattr(driver, 'make_train_fns', make_train_fns)
    summary = driver.main([yml, '--outdir', str(tmp_path), '--device', 'cpu',
                           '--max_iters', '3', '--val_freq', '3'])
    assert summary['oom_skips'] == 1 and summary['iterations'] == [1, 3]
    assert len(summary['batch_shapes']) == 2
    log = Path(summary['log_dir'], 'log.txt').read_text()
    assert 'ran out of memory, skipping batch' in log

    def failing(model, train_cfg):
        def train_step(state, batch, generator):
            raise RuntimeError('not an out-of-memory error')
        return train_step, None, None

    monkeypatch.setattr(driver, 'make_train_fns', failing)
    with pytest.raises(RuntimeError, match='not an out-of-memory'):
        driver.main([yml, '--outdir', str(tmp_path), '--device', 'cpu',
                     '--max_iters', '2'])


def test_profile_window_writes_a_trace(one_record_store, tmp_path):
    """--profile_steps traces from step 10 and writes a Chrome trace that
    names the steps' work."""
    d, yml, _ = one_record_store
    summary = driver.main([yml, '--outdir', str(tmp_path), '--device', 'cpu',
                           '--max_iters', '11', '--val_freq', '11',
                           '--profile_steps', '1'])
    path = Path(summary['log_dir'], 'profile', 'trace.json')
    events = json.loads(path.read_text())['traceEvents']
    assert any(e.get('name', '').startswith('aten::') for e in events)
    assert 'trace written to' in Path(summary['log_dir'],
                                      'log.txt').read_text()


def test_default_device_needs_a_gpu(setup, tmp_path, monkeypatch):
    d, yml, _ = setup
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main([yml, '--outdir', str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_chip_smoke_trains_the_released_config():
    """chip_smoke.py builds configs/training.yml in code (no PyYAML on the
    card's machine): the same settings, but the store path it sets and the
    split file it drops."""
    import chip_smoke
    released = load_config(str(REPO / 'configs' / 'training.yml')).to_dict()
    del released['data']['path'], released['data']['split']
    built = dict(chip_smoke.TRAIN_CONFIG, data={
        k: v for k, v in chip_smoke.TRAIN_CONFIG['data'].items()
        if k != 'path'})
    assert built == released


def test_chip_smoke_expected_train_launches():
    """The per-row triplet backward only in the steps above Nl = 48."""
    import chip_smoke
    per_call = {'edge_attention': 12, 'bond_attention': 12,
                'triplet_attention': 6}
    summary = {'batch_shapes': [(4, 320, 32, 4), (4, 320, 64, 4),
                                (4, 320, 48, 4)],
               'eval_shapes': [(4, 320, 32, 4)] * 10}
    names = ['edge_attention', 'edge_attention_backward', 'bond_attention',
             'bond_attention_backward', 'triplet_attention',
             'triplet_attention_backward', 'triplet_attention_backward_row',
             'edge_attention_backward_row', 'triplet_attention_row']
    assert chip_smoke.expected_train_launches(summary, per_call, names) == {
        'edge_attention': 156, 'edge_attention_backward': 36,
        'bond_attention': 156, 'bond_attention_backward': 36,
        'triplet_attention': 78, 'triplet_attention_backward': 18,
        'triplet_attention_backward_row': 6,
        'edge_attention_backward_row': 0, 'triplet_attention_row': 0}
