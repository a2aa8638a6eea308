"""The driver of traffic of kind `train`: the port's BucketedLoader over a
store written from the seed, feeding the port's train_step
(training/train_step.py make_train_fns), one training state built once.

Traffic keys: batch, complexes, sizes (the generator's ranges),
loader_threads, warmup_steps, trace_steps, check_fraction, reference_block.

Set-up writes the store, builds the loader, the model with the drawn
weights and the Adam state, and takes the first `warmup_steps` steps
through the same loader and train_step the window uses. The window then
runs steps until `seconds` have passed (a traced run: `trace_steps` steps),
the loader's waits inside it.

Checked: the set-up steps, from the seed's weights, and one window step
drawn from the seed among the first `check_fraction` of the steps the
window is expected to hold (from the warm-up steps' time). At that step the
driver keeps the batch, the parameters, Adam's moments and count and the
generator's state before it, the clipped gradients as Adam gets them, the
loss, and the parameters after it. The reference re-collates every checked
batch from the raw records in the loader's order, repeats the set-up steps
from the seed's weights, and repeats the window step from the program's
state before it.
"""

from __future__ import annotations

import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.core import inputs
from perfbench.core.trace import Tracer
from perfbench.counts.work import Shapes
from perfbench.data.generator import draw_complexes
from perfbench.reference import compare, diffusion, steps
from perfbench.reference.featurize import batch_arrays, bucket_key, featurize
from perfbench.reference.nets import check_config

BATCH_FIELDS = ('protein_pos', 'protein_feat', 'protein_mask', 'ligand_pos',
                'ligand_v', 'ligand_aux', 'ligand_mask', 'ligand_decomp_idx',
                'bond_type', 'bond_mask', 'prior_centers', 'prior_stds',
                'prior_num_atoms', 'prior_mask', 'num_arms')


def loader_batches(records, order_seed, batch_size, wanted):
    """The loader's batches numbered `wanted` (from 0), worked out again:
    each epoch's shuffle (np.random.default_rng(seed).shuffle), then
    records grouped by their padded shape, a batch whenever a group is
    full."""
    rng = np.random.default_rng(order_seed)
    feats, out, pending, n = {}, {}, {}, 0
    last = max(wanted)
    while n <= last:
        order = np.arange(len(records))
        rng.shuffle(order)
        for i in order:
            i = int(i)
            if i not in feats:
                feats[i] = featurize(records[i])
            key = bucket_key(feats[i])
            pending.setdefault(key, []).append(feats[i])
            if len(pending[key]) == batch_size:
                group = pending.pop(key)
                if n in wanted:
                    out[n] = batch_arrays(group, key)
                n += 1
                if n > last:
                    break
    return [out[i] for i in wanted]


class StepCapture:
    """What Adam gets at the next optimizer step: the clipped gradients,
    and its moments and step count before the update."""

    def __init__(self, adam, params: dict):
        self.adam, self.params = adam, params
        self.handle = adam.register_step_pre_hook(self._hook)

    def _hook(self, opt, args, kwargs):
        st = opt.state
        self.grads = {n: p.grad.detach().clone()
                      for n, p in self.params.items()}
        self.m = {n: (st[p]['exp_avg'].clone() if p in st
                      else torch.zeros_like(p)) for n, p in self.params.items()}
        self.v = {n: (st[p]['exp_avg_sq'].clone() if p in st
                      else torch.zeros_like(p)) for n, p in self.params.items()}
        p0 = next(iter(self.params.values()))
        self.t = int(st[p0]['step']) if p0 in st else 0
        self.handle.remove()


def _shape(batch, mcfg, K, Kb) -> Shapes:
    return Shapes(Np=batch.num_protein_atoms, Nl=batch.num_ligand_atoms,
                  protein=tuple(batch.protein_mask.sum(1).tolist()),
                  ligand=tuple(batch.ligand_mask.sum(1).tolist()),
                  H=mcfg['hidden_dim'], heads=mcfg['n_heads'], K=mcfg['knn'],
                  layers=mcfg['num_layers'], model_type=mcfg['model_type'],
                  classes=K, bond_classes=Kb)


def _fields(batch) -> dict:
    return {f: getattr(batch, f).clone() for f in BATCH_FIELDS}


def _clone(params) -> dict:
    return {n: p.detach().clone() for n, p in params.items()}


def run(cell, seed: int, seconds: float, trace: bool, device, result):
    """Measure one run of a training cell into `result` (core/runner.py
    RunResult); returns the evidence the reference judges."""
    from decompdiff_tpu_torch.data.dataset import DecompDataset
    from decompdiff_tpu_torch.data.store import DDStore, DDStoreWriter
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.training.loader import BucketedLoader
    from decompdiff_tpu_torch.training.train_step import (
        create_train_state, make_train_fns)

    tr, mcfg = cell.traffic, dict(cell.model)
    check_config(mcfg)
    if cell.workload['chips'] != 1:
        raise SystemExit('perfbench: the train driver runs on one card')
    tcfg = dict(cell.config['train'])
    K, Kb = cell.config['atom_classes'], mcfg.get('num_bond_classes', 5)
    B, W = tr['batch'], result.warmup
    records = draw_complexes(inputs.stream(seed, 'complex'), tr['complexes'],
                             tr['sizes'])
    tmp = tempfile.TemporaryDirectory(prefix='perfbench-')
    path = os.path.join(tmp.name, 'train.ddstore')
    with DDStoreWriter(path, meta={'perfbench_seed': seed}) as w:
        for i, rec in enumerate(records):
            w.append(f'complex/{i:05d}', {k: v for k, v in rec.items()
                                          if k != 'receptor_pos'})
    order_seed = inputs.stream(seed, 'order')
    loader = BucketedLoader(DecompDataset(DDStore(path)),
                            list(range(len(records))), B, shuffle=True,
                            seed=order_seed, num_threads=tr['loader_threads'],
                            device=device)
    it = iter(loader)
    model = DecompDiffModel.create(mcfg, K, device=device, seed=0)
    shapes = {n: tuple(p.shape) for n, p in model.denoiser.named_parameters()}
    inputs.load_weights(model.denoiser,
                        inputs.draw_weights(shapes, seed, device))
    tcfg['sample_time_method'] = mcfg.get('sample_time_method', 'symmetric')
    state = create_train_state(model, tcfg)
    train_step = make_train_fns(model, tcfg)[0]
    gen = inputs.generator(device, seed, 'train')
    params = dict(model.denoiser.named_parameters())
    adam = state.optimizer.adam
    u = np.random.default_rng(inputs.stream(seed, 'check')).random()

    if trace:
        Tracer.initialise()
    try:
        # set-up: the first steps, through the window's own loader and step
        warm, gen_states, losses = [], [], []
        for i in range(W):
            batch = next(it)
            if i == 1:
                result.sync()
                t_first = time.perf_counter()
            warm.append(_fields(batch))
            gen_states.append(gen.get_state())
            if i == 0:
                cap0 = StepCapture(adam, params)
            losses.append(train_step(state, batch, gen)['loss'])
        losses = [float(x) for x in losses]
        after = _clone(params)
        step_s = (time.perf_counter() - t_first) / max(1, W - 1)
        expected = result.trace_steps if trace else seconds / step_s
        k = int(u * tr['check_fraction'] * expected)

        result.read_card('open')
        tracer = Tracer() if trace else None
        result.sync()
        if tracer:           # the device is idle: nothing before the open
            tracer.start()
        t_open = time.perf_counter()
        result.mark_open()
        waits, traced = [], []
        n = 0
        while True:
            t0 = time.perf_counter()
            batch = next(it)
            waits.append(time.perf_counter() - t0)
            if trace:
                traced.append(batch)
            if n == k:
                win = SimpleNamespace(batch=_fields(batch), pre=_clone(params),
                                      gen_state=gen.get_state(),
                                      capture=StepCapture(adam, params))
                win.loss = train_step(state, batch, gen)['loss']
                win.post = _clone(params)
            else:
                train_step(state, batch, gen)
            n += 1
            if n > k and (n >= result.trace_steps if trace
                          else time.perf_counter() - t_open >= seconds):
                break
        result.sync()
        t_close = time.perf_counter()
        if tracer:
            tracer.stop((t_close - t_open) * 1e6, n)
    finally:
        loader.close()
        tmp.cleanup()
    result.window(t_open, t_close, n, B)
    result.e2e['train_graphs_per_s'] = B * n / (t_close - t_open)
    result.notes.update(loader_wait_s=sum(waits), checked_step=W + k)
    if tracer:
        result.read_layers(kind='train', trace=tracer.summary,
                           shapes=[_shape(b, mcfg, K, Kb) for b in traced],
                           loader_wait_s=waits)
    cap = win.capture
    program = {'batches': warm + [win.batch], 'losses': losses,
               'grad0': cap0.grads, 'after': after, 'wloss': float(win.loss),
               'wgrad': cap.grads, 'wpost': win.post}
    opt_state = (cap.m, cap.v, cap.t)
    del model, state, train_step, params, adam, loader, it, batch, traced
    result.release()
    return SimpleNamespace(
        cell=cell, seed=seed, device=device, shapes=shapes, tcfg=tcfg,
        records=records, order_seed=order_seed, gen_states=gen_states,
        window_index=W + k, window_pre=win.pre, window_opt=opt_state,
        window_gen=win.gen_state, program=program)


def reference(ev, tf32: bool = False, half: bool = False) -> dict:
    """The reference in the program's place: the checked batches collated
    again from the raw records, the set-up steps from the seed's weights,
    the window step from the program's state before it; in float32 with
    TF32 off, or (the control) with TF32 on. `half` plants a fault: only
    the first half of each batch, the mean taken over it."""
    tr, mcfg, dev = ev.cell.traffic, ev.cell.model, ev.device
    B, W = tr['batch'], len(ev.gen_states)
    keep = B // 2 if half else None
    batches = [inputs.to_device(a, dev) for a in loader_batches(
        ev.records, ev.order_seed, B, list(range(W)) + [ev.window_index])]
    S = diffusion.schedules(mcfg, dev)
    P0 = inputs.draw_weights(ev.shapes, ev.seed, dev)
    P = {k: v.clone() for k, v in P0.items()}
    Pw = {k: v.clone() for k, v in ev.window_pre.items()}
    with steps.precision(tf32):
        losses, grad0, _ = steps.train_steps(
            P, mcfg, S, batches[:W], ev.gen_states, ev.tcfg,
            tr['reference_block'], keep)
        wloss, wgrad, _ = steps.train_steps(
            Pw, mcfg, S, batches[W:], [ev.window_gen], ev.tcfg,
            tr['reference_block'], keep, ev.window_opt)
    return {'batches': batches, 'losses': losses, 'grad0': grad0,
            'after': P, 'wloss': wloss[0], 'wgrad': wgrad, 'wpost': Pw}


def numbers(ev, out: dict, ref: dict) -> dict:
    """compare.training_numbers of `out` (ev.program, or a reference in
    its place) against `ref`."""
    batch_err = sum(int((ref['batches'][i][f] != b[f]).sum())
                    for i, b in enumerate(out['batches'])
                    for f in BATCH_FIELDS)
    P0 = inputs.draw_weights(ev.shapes, ev.seed, ev.device)
    pre = ev.window_pre
    return compare.training_numbers(
        batch_err, out['losses'], ref['losses'], out['grad0'], ref['grad0'],
        {k: out['after'][k] - P0[k] for k in P0},
        {k: ref['after'][k] - P0[k] for k in P0},
        window=(out['wloss'], ref['wloss'], out['wgrad'], ref['wgrad'],
                {k: out['wpost'][k] - pre[k] for k in pre},
                {k: ref['wpost'][k] - pre[k] for k in pre}))
