"""The port's span and counter recorder (utils/profiling.py) and the spans
the hot path records: nesting and parents, threads, step numbers, counters,
nothing while off, the shared clock with the CPU profiler, and the spans of
a sampling step, a training step and the loader."""

import threading
import time

import numpy as np
import pytest
import torch

from decompdiff_tpu_torch.data.batch import FullProtein
from decompdiff_tpu_torch.data.dataset import DecompDataset
from decompdiff_tpu_torch.data.store import DDStore
from decompdiff_tpu_torch.data.synthetic import write_synthetic_store
from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
from decompdiff_tpu_torch.sampling.sampler import (
    SampleConfig, sample_diffusion)
from decompdiff_tpu_torch.training.loader import BucketedLoader
from decompdiff_tpu_torch.training.train_step import (
    create_train_state, make_train_fns)
from decompdiff_tpu_torch.utils import profiling
from decompdiff_tpu_torch.utils.profiling import count, span
from decompdiff_tpu_torch.utils.testing import (
    random_complex_batch, tiny_model_config)

torch.set_num_threads(2)
GUIDANCE = ({'type': 'armsca_prox', 'min_d': 1.2, 'max_d': 1.9},
            {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0})


@pytest.fixture
def recording():
    """Record for the test's body; the recording is taken afterwards if
    the test left it on."""
    profiling.start_recording()
    yield
    if profiling._active is not None:
        profiling.take()


def _names(rec):
    return [s.name for s in rec.spans]


def test_nesting_parents_steps_and_counters(recording):
    with span('outer', step=4):
        with span('inner'):
            count('hits')
        with span('inner'):
            count('hits', 2)
    with span('after'):
        pass
    rec = profiling.take()
    assert _names(rec) == ['outer', 'inner', 'inner', 'after']
    assert [s.parent for s in rec.spans] == [-1, 0, 0, -1]
    assert [s.step for s in rec.spans] == [4, 4, 4, None]
    assert rec.counters == {'hits': 3}
    me = threading.get_native_id()
    assert rec.thread == me and rec.idents[me] == threading.get_ident()
    for s in rec.spans:
        assert s.thread == me and s.start_ns <= s.end_ns
    outer, first, second, _ = rec.spans
    assert outer.start_ns <= first.start_ns <= second.end_ns <= outer.end_ns


def test_threads_keep_their_own_parents(recording):
    done = threading.Event()

    def worker():
        with span('worker'):
            with span('worker.inner'):
                count('worker.calls')
        done.set()

    with span('main', step=0):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert done.is_set() and not t.is_alive()
    rec = profiling.take()
    by = {s.name: (i, s) for i, s in enumerate(rec.spans)}
    w_i, w = by['worker']
    assert w.thread == t.native_id != rec.thread
    assert w.parent == -1                  # no span of its own thread
    assert by['worker.inner'][1].parent == w_i
    assert w.step == 0                      # opened inside step 0
    assert rec.idents[t.native_id] == t.ident
    assert rec.counters == {'worker.calls': 1}


def test_off_records_nothing_and_shares_one_context():
    assert profiling._active is None
    assert span('a') is span('b', step=1)
    with span('a'):
        count('c')
    with pytest.raises(RuntimeError, match='not being recorded'):
        profiling.take()
    profiling.start_recording()
    try:
        with pytest.raises(RuntimeError, match='already'):
            profiling.start_recording()
    finally:
        rec = profiling.take()
    assert rec.spans == [] and rec.counters == {}


def test_a_span_open_at_take_ends_at_the_stop(recording):
    with span('open'):
        rec = profiling.take()
        with span('unrecorded'):
            pass
    assert _names(rec) == ['open']
    assert rec.spans[0].end_ns == rec.stop[1]


def test_spans_share_the_profiler_clock():
    """A span around torch.ones(4) + 1 holds kineto's aten::add once both
    are on the Unix-epoch clock."""
    x = torch.ones(4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiling.start_recording()
        with span('add'):
            x + 1
        rec = profiling.take()
    adds = [e for e in prof.profiler.kineto_results.events()
            if e.name() == 'aten::add']
    assert len(adds) == 1
    s = rec.spans[0]
    assert rec.unix_ns(s.start_ns) <= adds[0].start_ns()
    assert adds[0].end_ns() <= rec.unix_ns(s.end_ns)


def test_unix_ns_follows_the_anchors():
    rec = profiling.Recording([], {}, 1, {}, (1000, 10), (3000, 1010))
    assert rec.unix_ns(10) == 1000 and rec.unix_ns(1010) == 3000
    assert rec.unix_ns(510) == 2000


def _sample_case():
    # the kernels' wrappers, which run their plain versions on the CPU
    cfg = tiny_model_config(num_layers=1, use_pallas=True)
    model = DecompDiffModel.create(cfg, 8, device='cpu', seed=0)
    batch = random_complex_batch(np.random.default_rng(0), device='cpu',
                                 real_ligand=9, real_protein=22)
    rng = np.random.default_rng(1)
    B, Nl = batch.batch_size, batch.num_ligand_atoms
    init = (torch.as_tensor(batch.atom_prior_centers().numpy()),
            torch.as_tensor(rng.integers(0, 8, (B, Nl)).astype(np.int32)),
            torch.zeros((B, Nl, Nl), dtype=torch.int32))
    full = FullProtein(torch.as_tensor(
        (rng.normal(size=(B, 30, 3)) * 4).astype(np.float32)),
        torch.ones((B, 30), dtype=torch.bool))
    return model, batch, init, full


@pytest.mark.parametrize('drift', [False, True], ids=['plain', 'host_drift'])
def test_sampler_spans(recording, drift):
    model, batch, init, full = _sample_case()
    extra = {}
    if drift:
        extra = dict(mmff_callback=lambda pos, v, mask: np.zeros_like(pos),
                     mmff_start_time=50, mmff_end_time=0)
    cfg = SampleConfig(num_steps=2, energy_drift=GUIDANCE, save_traj=False,
                       **extra)
    sample_diffusion(model, cfg, batch, *init, full,
                     generator=torch.Generator().manual_seed(0))
    rec = profiling.take()
    steps = [i for i, s in enumerate(rec.spans) if s.name == 'sample.step']
    assert [rec.spans[i].step for i in steps] == [0, 1]
    layer = ['sample.denoiser', 'sample.guidance', 'sample.posterior']
    for i in steps:
        children = [s.name for s in rec.spans if s.parent == i]
        assert children == layer
    names = _names(rec)
    # each step's kNN graph and each attention of its refine layer
    for op in ('knn', 'edge_attention', 'bond_attention',
               'triplet_attention'):
        assert names.count(f'ops.{op}') >= 2, op
    posterior = [i for i, s in enumerate(rec.spans)
                 if s.name == 'sample.posterior']
    drifts = [s for s in rec.spans if s.name == 'sample.host_drift']
    assert len(drifts) == (2 if drift else 0)
    assert all(s.parent in posterior for s in drifts)
    # every kernel wrapper span lies inside the denoiser's
    den = {i for i, s in enumerate(rec.spans) if s.name == 'sample.denoiser'}
    assert all(s.parent in den for s in rec.spans
               if s.name.startswith('ops.'))


def test_train_step_spans(recording):
    cfg = tiny_model_config(num_layers=1)
    model = DecompDiffModel.create(cfg, 8, device='cpu', seed=0)
    tcfg = {'optimizer': {'type': 'adam', 'lr': 5e-4}}
    state = create_train_state(model, tcfg)
    train_step = make_train_fns(model, tcfg)[0]
    batch = random_complex_batch(np.random.default_rng(0), device='cpu')
    for _ in range(2):
        train_step(state, batch, torch.Generator().manual_seed(0))
    rec = profiling.take()
    steps = [i for i, s in enumerate(rec.spans) if s.name == 'train.step']
    assert [rec.spans[i].step for i in steps] == [0, 1]
    for i in steps:
        children = [s.name for s in rec.spans if s.parent == i]
        assert children == ['train.loss', 'train.backward',
                            'train.optimizer']
    assert 'train.reduce' not in _names(rec)      # no mesh


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('spans') / 'synth.ddstore')
    write_synthetic_store(path, [dict(n_protein=100, n_ligand=14)] * 4,
                          seed=3)
    return path


class _Slow(DecompDataset):
    """Featurizes each record after a pause, so the first get finds the
    queue empty."""

    def __getitem__(self, idx):
        time.sleep(0.2)
        return super().__getitem__(idx)


def _drain(loader):
    try:
        return list(loader)
    finally:
        loader.close()


def test_loader_spans_and_counters(store, recording):
    kw = dict(shuffle=False, infinite=False, device='cpu')
    loader = BucketedLoader(DecompDataset(DDStore(store)), [0, 1, 2, 3], 2,
                            **kw)
    deadline = time.monotonic() + 60
    while loader._queue.qsize() < 3 and time.monotonic() < deadline:
        time.sleep(0.05)        # both batches and the end are queued
    assert len(_drain(loader)) == 2
    rec = profiling.take()
    names = _names(rec)
    assert names.count('loader.collate') == 2
    assert names.count('loader.h2d') == 2
    assert names.count('loader.wait') == 3   # two batches, then the end
    collate = [s for s in rec.spans if s.name == 'loader.collate']
    assert all(s.thread != rec.thread for s in collate)
    assert rec.counters == {'loader.gets': 3}

    profiling.start_recording()
    assert len(_drain(BucketedLoader(_Slow(DDStore(store)), [0, 1], 2,
                                     **kw))) == 1
    counters = profiling.take().counters
    assert counters['loader.gets'] == 2
    assert counters['loader.empty_gets'] >= 1
