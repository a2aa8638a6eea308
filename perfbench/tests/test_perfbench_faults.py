"""A run with its timed path broken underneath must come out not correct:
the whole harness runs (at the tiny CPU size, without the look for a
card), with one fault planted in the port each time: a step that returns
its state unchanged, half of the batch left out, a token altered where it
is produced. A one-card cell has no exchange between chips to leave out."""

import dataclasses
import time

import pytest
import torch

from perfbench.core import spec
from perfbench.rehearse import tiny
from perfbench.run import measure


def _run(cell):
    c = tiny(spec.load_cell(cell))
    result, numbers = measure(c, 11, 1.0, 0, torch.device('cpu'),
                              time.time())[:2]
    return result.line(numbers)


def _on_every_model(monkeypatch, add_hooks):
    from decompdiff_tpu_torch.models import diffusion_model as dm
    create = dm.DecompDiffModel.create.__func__

    def faulty(cls, *a, **kw):
        model = create(cls, *a, **kw)
        add_hooks(model.denoiser)
        return model
    monkeypatch.setattr(dm.DecompDiffModel, 'create', classmethod(faulty))


def _state_unchanged(monkeypatch):
    first = {}

    def pre(module, args):
        first.setdefault('state', tuple(a.clone() for a in args[1:4]))
        return (args[0],) + first['state'] + tuple(args[4:])
    _on_every_model(monkeypatch, lambda m: m.register_forward_pre_hook(pre))


def _half_batch(monkeypatch):
    def post(module, args, out):
        half = out['pred_ligand_pos'].shape[0] // 2
        return {k: torch.cat([v[:half], torch.zeros_like(v[half:])])
                for k, v in out.items()}
    _on_every_model(monkeypatch, lambda m: m.register_forward_hook(post))


def _token_altered(monkeypatch):
    from decompdiff_tpu_torch.sampling import sampler
    orig = sampler.gumbel_argmax

    def altered(uniform, logits):
        out = orig(uniform, logits).clone()
        out.view(-1)[1] = (out.view(-1)[1] + 1) % logits.shape[-1]
        return out
    monkeypatch.setattr(sampler, 'gumbel_argmax', altered)


@pytest.mark.parametrize('cell', ['bond.sample.b100', 'o2.sample.b100'])
@pytest.mark.parametrize('fault', [_state_unchanged, _half_batch,
                                   _token_altered])
def test_sampling_fault_is_caught(monkeypatch, cell, fault):
    fault(monkeypatch)
    line = _run(cell)
    assert not line['correct'], line['checks']


def _train_state_unchanged(monkeypatch):
    from decompdiff_tpu_torch.training import train_step
    step = train_step.Optimizer.step

    def unchanged(self, grads):
        before = {n: p.detach().clone() for n, p in self.params.items()}
        step(self, grads)
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(before[n])
    monkeypatch.setattr(train_step.Optimizer, 'step', unchanged)


def _train_half_batch(monkeypatch):
    from decompdiff_tpu_torch.models import diffusion_model as dm
    loss = dm.DecompDiffModel.get_diffusion_loss

    def half(self, batch, *a, **kw):
        n = batch.batch_size // 2
        batch = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name)[:n]
            for f in dataclasses.fields(batch)
            if getattr(batch, f.name) is not None})
        return loss(self, batch, *a, **kw)
    monkeypatch.setattr(dm.DecompDiffModel, 'get_diffusion_loss', half)


def _train_token_altered(monkeypatch):
    from decompdiff_tpu_torch.training import loader
    collate = loader.collate

    def altered(*a, **kw):
        batch = collate(*a, **kw)
        batch.ligand_v[0, 0] = (batch.ligand_v[0, 0] + 1) % 8
        return batch
    monkeypatch.setattr(loader, 'collate', altered)


@pytest.mark.parametrize('fault', [_train_state_unchanged, _train_half_batch,
                                   _train_token_altered])
def test_training_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    line = _run('bond.train.b64')
    assert not line['correct'], line['checks']
