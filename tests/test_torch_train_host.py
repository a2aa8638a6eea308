"""The host pieces of the port's trainer against the JAX package on the CPU:
the validation AUROCs, the bucketed loader, checkpoint saving, reading and
resuming, and the asynchronous checkpoint snapshot.

Tolerances:
  * AUROCs abs 1e-12: the same rank statistic, summed in another order.
  * Loader batches, checkpoint parameters and the resumed Adam state:
    exact (the same numpy values).
  * The JAX model's forward on a port checkpoint's parameters against the
    port's: rtol 2e-4 / atol 2e-5, that of the tiny denoiser's dense-path
    parity (tests/test_torch_model.py).
  * One Adam update after resuming a JAX checkpoint against optax: rtol
    1e-6 / atol 1e-7, as tests/test_torch_train.py holds the update rule.
"""

import json
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from decompdiff_tpu.data.dataset import DecompDataset as JaxDataset
from decompdiff_tpu.data.store import DDStore as JaxStore
from decompdiff_tpu.models.diffusion_model import DecompDiffModel as JaxModel
from decompdiff_tpu.training import loader as jax_loader
from decompdiff_tpu.training import metrics as jax_metrics
from decompdiff_tpu.training import train_step as jts
from decompdiff_tpu.utils import checkpoint as jax_checkpoint
from decompdiff_tpu.utils.testing import (
    random_complex_batch as jax_random_complex_batch)
from decompdiff_tpu_torch.data.dataset import DecompDataset
from decompdiff_tpu_torch.data.store import DDStore
from decompdiff_tpu_torch.data.synthetic import write_synthetic_store
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.training import driver, metrics
from decompdiff_tpu_torch.training.loader import BucketedLoader
from decompdiff_tpu_torch.training.train_step import (
    PlateauScheduler, create_train_state, make_train_fns)
from decompdiff_tpu_torch.utils.checkpoint import (
    ADAM_LAYOUT, checkpoint_payload, read_checkpoint, restore_train_state,
    save_checkpoint)
from decompdiff_tpu_torch.utils.params import (
    flax_to_state_dict, state_dict_to_flax)
from decompdiff_tpu_torch.utils.profiling import (
    TRACE_FILE, Timer, annotate, trace)
from decompdiff_tpu_torch.utils.testing import (
    random_complex_batch, tiny_model_config)

torch.set_num_threads(2)
TINY_TOL = dict(rtol=2e-4, atol=2e-5)
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)
TRAIN_CFG = {'optimizer': {'type': 'adam', 'lr': 5e-4, 'weight_decay': 1e-4,
                           'beta1': 0.95, 'beta2': 0.999},
             'max_grad_norm': 8.0, 'pos_noise_std': 0.1,
             'prior_noise_std': 0.5}
T = [7, 13]


# --- AUROC -----------------------------------------------------------------

def _auroc_case(case):
    rng = np.random.default_rng({'ties': 0, 'missing_class': 1,
                                 'single_class': 2, 'nan': 3}[case])
    n, k = 200, 5
    y = rng.integers(0, k, n)
    # probabilities on a coarse grid: many tied scores within each class
    p = np.round(rng.random((n, k)), 1).astype(np.float32)
    if case == 'missing_class':
        y[y == 2] = 3                        # class 2 never occurs
    elif case == 'single_class':
        y[:] = 4
    elif case == 'nan':
        p[5, 1] = np.nan                     # class 1 is skipped
    return y, p


@pytest.mark.parametrize('case', ['ties', 'missing_class', 'single_class',
                                  'nan'])
def test_auroc_matches_sklearn(case):
    y, p = _auroc_case(case)
    for port, jax_fn in ((metrics.get_auroc, jax_metrics.get_auroc),
                         (metrics.get_bond_auroc,
                          jax_metrics.get_bond_auroc)):
        want = jax_fn(y, p)
        assert abs(port(y, p) - want) <= 1e-12
    if case == 'single_class':
        assert metrics.get_auroc(y, p) == 0.0


def test_roc_auc_ties_and_errors():
    from sklearn.metrics import roc_auc_score
    rng = np.random.default_rng(4)
    y = rng.integers(0, 2, 500)
    s = rng.integers(0, 7, 500).astype(np.float64)   # heavy ties
    assert abs(metrics.roc_auc(y, s) - roc_auc_score(y, s)) <= 1e-12
    with pytest.raises(ValueError):
        metrics.roc_auc(np.ones(4), np.arange(4.0))
    with pytest.raises(ValueError):
        metrics.roc_auc([0, 1], [0.5, np.nan])


# --- the loader ------------------------------------------------------------

# two protein buckets (128, 192) and two ligand buckets (16, 24)
POCKETS = [dict(n_protein=n_p, n_ligand=n_l)
           for n_p, n_l in ((100, 14), (150, 14), (110, 20), (120, 13),
                            (170, 15), (105, 22), (115, 12), (160, 21),
                            (100, 15), (125, 14), (140, 13))]


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('loader') / 'synth.ddstore')
    write_synthetic_store(path, POCKETS, seed=3)
    return path


def _batches(loader, n):
    out = []
    for batch in loader:
        out.append({k: np.asarray(getattr(batch, k)) for k in vars(batch)
                    if getattr(batch, k) is not None})
        if len(out) == n:
            break
    loader.close()
    return out


@pytest.mark.parametrize('infinite', [True, False],
                         ids=['infinite', 'finite'])
def test_loader_matches_jax(store, infinite):
    """Every batch bit-equal to the JAX loader's: over more than two epochs
    of the infinite stream, or the whole finite pass with its flushed
    partial batches."""
    ids = list(range(len(POCKETS)))
    kw = dict(batch_size=3, shuffle=True, seed=7, num_threads=3,
              infinite=infinite)
    n = 9 if infinite else 100
    want = _batches(jax_loader.BucketedLoader(
        JaxDataset(JaxStore(store)), ids, **kw), n)
    got = _batches(BucketedLoader(DecompDataset(DDStore(store)), ids,
                                  device='cpu', **kw), n)
    # finite: the full batches, then each bucket's partial one
    assert len(got) == len(want) == (n if infinite else 5)
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # both bucket keys occur
    assert len({b['protein_pos'].shape[1:2] + b['ligand_pos'].shape[1:2]
                for b in got}) >= 3


class _Failing:
    """A dataset whose record `bad` raises; `block` makes every read wait
    for the event."""

    def __init__(self, store, bad=(), block=None):
        self.inner = DecompDataset(DDStore(store))
        self.bad, self.block = set(bad), block

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        if self.block is not None:
            self.block.wait()
        if i in self.bad:
            raise KeyError(i)
        return self.inner[i]


def test_loader_skips_and_drops(store):
    ids = list(range(len(POCKETS)))
    loader = BucketedLoader(_Failing(store, bad={2, 6}), ids, 2,
                            shuffle=False, infinite=False, device='cpu',
                            ligand_buckets=(16,))
    n = sum(b.batch_size for b in loader)
    # records 2 and 6 fail; 5 and 7 (22 and 21 ligand atoms) exceed the
    # ligand ladder
    assert dict(loader.skip_counts) == {'KeyError': 2, 'oversize': 2}
    assert n == len(POCKETS) - 4


def test_loader_raises_when_nothing_survives(store):
    every = list(range(3))
    with pytest.raises(RuntimeError, match='every sample'):
        next(iter(BucketedLoader(_Failing(store, bad=every), every, 2,
                                 device='cpu')))
    with pytest.raises(RuntimeError, match='oversize'):
        next(iter(BucketedLoader(DecompDataset(DDStore(store)), every, 2,
                                 device='cpu', protein_buckets=(64,))))


def test_close_ends_a_blocked_consumer(store):
    gate = threading.Event()
    loader = BucketedLoader(_Failing(store, block=gate), [0, 1], 2,
                            device='cpu')
    got = []
    consumer = threading.Thread(target=lambda: got.extend(loader))
    consumer.start()
    time.sleep(0.3)
    assert consumer.is_alive()          # waiting for a batch
    loader.close()
    consumer.join(timeout=5)
    gate.set()
    assert not consumer.is_alive() and got == []


def test_default_loader_device_needs_a_gpu(store, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BucketedLoader(DecompDataset(DDStore(store)), [0], 1)


# --- checkpoints -----------------------------------------------------------

CONFIG = {'data': {'transform': {'ligand_atom_mode': 'basic'}},
          'model': tiny_model_config(num_diffusion_timesteps=20),
          'train': TRAIN_CFG}


class _NumpyOnly(pickle.Unpickler):
    """Resolves the classes of numpy, builtins and collections alone."""

    def find_class(self, module, name):
        if module.split('.')[0] not in ('numpy', 'builtins', 'collections'):
            raise pickle.UnpicklingError(f'{module}.{name}')
        return super().find_class(module, name)


def _port_trained(steps=1):
    """A tiny port model after `steps` training steps on a seeded batch."""
    model = DecompDiffModel.create(CONFIG['model'], 8, device='cpu', seed=1)
    state = create_train_state(model, TRAIN_CFG)
    step = make_train_fns(model, TRAIN_CFG)[0]
    batch = random_complex_batch(np.random.default_rng(0), device='cpu')
    g = torch.Generator().manual_seed(0)
    for _ in range(steps):
        step(state, batch, g)
    return model, state, step, batch, g


def test_port_checkpoint_read_by_jax(tmp_path):
    """A port .ckpt holds numpy and builtins only; the JAX package's
    load_checkpoint reads it, and its params run the JAX model."""
    model, state, *_ = _port_trained()
    path = str(tmp_path / '3.ckpt')
    save_checkpoint(path, CONFIG, model, state,
                    PlateauScheduler().state_dict(), 3,
                    extra={'best_loss': 1.5, 'best_iter': 3})
    with open(path, 'rb') as f:
        plain = _NumpyOnly(f).load()
    ckpt = jax_checkpoint.load_checkpoint(path)
    assert sorted(ckpt) == sorted(plain) == sorted(
        ['config', 'params', 'opt_state', 'step', 'lt_history', 'lt_count',
         'scheduler', 'iteration', 'extra'])
    assert ckpt['opt_state']['layout'] == ADAM_LAYOUT
    assert ckpt['step'] == 1 and ckpt['iteration'] == 3
    assert ckpt['config'] == CONFIG
    got = flax_to_state_dict(ckpt['params'])
    want = model.denoiser.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    jax_model = JaxModel.create(CONFIG['model'], 8)
    jb = jax_random_complex_batch(np.random.default_rng(0))
    preds = jax.jit(jax_model.apply)(ckpt['params'], jb, jb.ligand_pos,
                                     jb.ligand_v, jb.bond_type, jnp.array(T))
    batch = random_complex_batch(np.random.default_rng(0), device='cpu')
    with torch.no_grad():
        mine = model.apply(batch, batch.ligand_pos, batch.ligand_v,
                           batch.bond_type, torch.tensor(T))
    assert sorted(mine) == sorted(preds)
    for k in preds:
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(preds[k]),
                                   **TINY_TOL, err_msg=k)


@pytest.fixture(scope='module')
def jax_two_steps(tmp_path_factory):
    """A JAX train state after two train steps (the optax chain: clip,
    weight decay, inject_hyperparams(adam)), saved by the JAX package."""
    jax_model = JaxModel.create(CONFIG['model'], 8)
    batch = jax_random_complex_batch(np.random.default_rng(0), batch_size=2)
    # freshly initialized weights drawn by the port (quicker than flax's
    # init on the CPU)
    params = state_dict_to_flax(DecompDiffModel.create(
        CONFIG['model'], 8, device='cpu', seed=2).denoiser.state_dict())
    tx = jts.make_optimizer(TRAIN_CFG['optimizer'], TRAIN_CFG['max_grad_norm'])
    state = jts.TrainState(step=jnp.asarray(0), params=params,
                           opt_state=tx.init(params),
                           lt_history=jnp.zeros((20,)),
                           lt_count=jnp.zeros((20,)))
    step = jts.make_train_fns(jax_model, tx, TRAIN_CFG)[0]
    for i in range(2):
        state, _ = step(state, batch, jax.random.PRNGKey(10 + i))
    path = str(tmp_path_factory.mktemp('jaxckpt') / '2.ckpt')
    jax_checkpoint.save_checkpoint(path, CONFIG, state,
                                   {'best': 3.0, 'num_bad': 1}, 2,
                                   extra={'rng': np.asarray(
                                       jax.random.PRNGKey(5))})
    return path, state, tx


def test_jax_checkpoint_resumes_in_the_port(jax_two_steps):
    path, jstate, tx = jax_two_steps
    ckpt = read_checkpoint(path)
    model = DecompDiffModel.create(CONFIG['model'], 8, device='cpu', seed=9)
    state = restore_train_state(ckpt, model, create_train_state(model,
                                                                TRAIN_CFG))
    inner = jstate.opt_state[jts._adam_index(jstate.opt_state)]
    adam = inner.inner_state[0]
    want_mu, want_nu = (flax_to_state_dict(jax.tree.map(np.asarray, t))
                        for t in (adam.mu, adam.nu))
    opt = state.optimizer
    assert opt.lr == float(inner.hyperparams['learning_rate'])
    assert state.step == 2 and int(adam.count) == 2
    params = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    for name, p in opt.params.items():
        st = opt.adam.state[p]
        assert float(st['step']) == 2.0, name
        assert torch.equal(st['exp_avg'], want_mu[name]), name
        assert torch.equal(st['exp_avg_sq'], want_nu[name]), name
        assert torch.equal(p.detach(), params[name]), name
    np.testing.assert_array_equal(state.lt_history.numpy(),
                                  np.asarray(jstate.lt_history))
    assert ckpt['scheduler'] == {'best': 3.0, 'num_bad': 1}

    # one more update from the same gradients, above the clip norm
    rng = np.random.default_rng(6)
    grads = {k: (rng.normal(size=v.shape) * 5).astype(np.float32)
             for k, v in params.items()}
    jgrads = jax.tree.map(jnp.asarray, state_dict_to_flax(
        {k: torch.as_tensor(v) for k, v in grads.items()}))
    updates, _ = jax.jit(tx.update)(jgrads, jstate.opt_state, jstate.params)
    want = flax_to_state_dict(jax.tree.map(
        np.asarray, optax.apply_updates(jstate.params, updates)))
    opt.step({k: torch.as_tensor(v) for k, v in grads.items()})
    for name, p in opt.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   **ADAM_TOL, err_msg=name)


def test_port_checkpoint_round_trip(tmp_path):
    """read_checkpoint of a port file restores the same Adam state."""
    model, state, *_ = _port_trained(steps=2)
    state.optimizer.lr = 3e-4
    path = str(tmp_path / 'p.ckpt')
    save_checkpoint(path, CONFIG, model, state, {'best': 2.0, 'num_bad': 0},
                    2)
    fresh = DecompDiffModel.create(CONFIG['model'], 8, device='cpu', seed=5)
    got = restore_train_state(read_checkpoint(path), fresh,
                              create_train_state(fresh, TRAIN_CFG))
    assert got.optimizer.lr == 3e-4 and got.step == 2
    for (name, p), q in zip(state.optimizer.params.items(),
                            got.optimizer.params.values()):
        assert torch.equal(p, q), name
        a, b = state.optimizer.adam.state[p], got.optimizer.adam.state[q]
        for k in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(a[k], b[k]), (name, k)
    assert torch.equal(got.lt_history, state.lt_history)


def test_async_snapshot_holds_its_own_iteration(tmp_path):
    """The snapshot is taken before the saver thread starts; the next step
    updates the parameters and Adam moments in place while the file is
    written, and the file still holds the snapshot's iteration. A failed
    write is raised at the join."""
    model, state, step, batch, g = _port_trained()
    before = {k: v.clone() for k, v in model.denoiser.state_dict().items()}
    p0 = next(iter(state.optimizer.params.values()))
    mu_before = state.optimizer.adam.state[p0]['exp_avg'].clone()
    saver = driver._AsyncSaver()
    path = str(tmp_path / '1.ckpt')
    saver.save(path, checkpoint_payload(CONFIG, model, state, {}, 1))
    step(state, batch, g)
    saver.join()
    ckpt = read_checkpoint(path)
    got = flax_to_state_dict(ckpt['params'])
    changed = 0
    for k, v in before.items():
        assert torch.equal(got[k], v), k
        changed += not torch.equal(model.denoiser.state_dict()[k], v)
    assert changed > 0 and ckpt['step'] == 1
    name = next(iter(state.optimizer.params))
    mu = flax_to_state_dict(ckpt['opt_state']['mu'])[name]
    assert torch.equal(mu, mu_before)

    saver.save(str(tmp_path / 'missing' / '2.ckpt'),
               checkpoint_payload(CONFIG, model, state, {}, 2))
    with pytest.raises(RuntimeError, match='async checkpoint save failed'):
        saver.join()


def test_profiling_trace_annotate_and_timer(tmp_path):
    """trace(logdir) writes a Chrome trace holding an annotate() range and
    the work inside it; trace(None) runs its body; Timer counts and sums
    each named phase."""
    with trace(str(tmp_path / 'prof')):
        with annotate('ddtorch_phase'):
            torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.loads((tmp_path / 'prof' / TRACE_FILE).read_text())[
        'traceEvents']
    names = {e.get('name', '') for e in events}
    assert 'ddtorch_phase' in names and 'aten::mm' in names
    with trace(None):           # no logdir: runs the body untraced
        torch.ones(2) + 1

    timer = Timer()
    for _ in range(3):
        with timer.time('a'):
            time.sleep(0.001)
    with timer.time('b'):
        pass
    got = timer.summary()
    assert got['a']['count'] == 3 and got['b']['count'] == 1
    assert got['a']['total_s'] >= 0.003
