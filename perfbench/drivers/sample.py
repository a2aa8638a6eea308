"""The driver of traffic of kind `sample`: one pocket's batch through the
port's sample_diffusion, step boundaries marked by forward hooks on the
model's denoiser (the program is not edited), and the checked steps judged
by the reference once the window has closed.

Traffic keys: batch, sizes (the generator's ranges), guidance (the energy
terms of every step), num_steps and skip_mode (the schedule; the reference
follows truncate mode: t = T-1 down to T-num_steps), num_atoms (`ref`: every
molecule has the reference ligand's arm and scaffold counts), warmup_steps,
trace_steps, check_fraction, reference_block. A mix that needs another
schedule or atom-count mode comes with a driver of its own
(drivers/<kind>.py), since the reference has to follow it.

The chain's first `warmup_steps` steps are set-up. The window opens at the
next step boundary and closes at the first boundary after `seconds` (in a
traced run: after `trace_steps` steps); a chain that ends inside the window
is followed by another with fresh draws, since a step's cost does not
depend on t. Each step boundary records a CUDA event on the stream, so a
step's time is its span on the device timeline, read after the window.

Two steps are checked: the chain's first, from the harness's x_T, and one
drawn from the seed among the first `check_fraction` of the steps the
window is expected to hold (from the warm-up steps' time), so that checks
cover the late, low-t steps where sampled types flip.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.core import inputs
from perfbench.core.trace import Tracer
from perfbench.counts.work import Shapes
from perfbench.data.generator import draw_complexes
from perfbench.reference import compare, diffusion, steps
from perfbench.reference.nets import check_config

MODES = {'skip_mode': ('truncate',), 'num_atoms': ('ref',)}


class _Closed(Exception):
    """Raised from the denoiser hook to end sample_diffusion at the
    window's close."""


class StepHooks:
    """Forward hooks on the denoiser: the step count, the events at each
    step boundary and around each denoiser call, the window's open and
    close, and the captures of the checked steps."""

    def __init__(self, run, module, first_check, pick_check):
        self.run, self.step = run, 0
        self.check = {first_check}
        self.pick_check = pick_check     # step time -> the window's check
        self.captures = {}
        self.open = self.closed = False
        self.t_first = self.t_open = self.t_close = None
        self.boundaries = []        # CUDA events at the window's steps' starts
        self.after = []             # and after each denoiser call
        self.chain_step = 0
        self.tracer = None
        self.handles = [module.register_forward_pre_hook(self._pre),
                        module.register_forward_hook(self._post)]

    def _event(self):
        if not self.run.cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _pre(self, module, args):
        r = self.run
        s = self.step
        if s - 1 in self.check:          # the checked step's next state
            x, v, b = args[1], args[2], args[3]
            self.captures[s - 1].update(x=x.clone(), v=v.clone(),
                                        b=b.clone())
        if s == 1:
            r.sync()
            self.t_first = time.perf_counter()
        if not self.open and s == r.warmup:
            r.sync()
            est = max(1e-6, (time.perf_counter() - self.t_first)
                      / max(1, s - 1))
            self.check.add(self.pick_check(est))
            r.read_card('open')
            if r.trace:          # the device is idle: nothing before the open
                self.tracer = Tracer()
                self.tracer.start()
            self.t_open = time.perf_counter()
            r.mark_open()
            self.open = True
        elif self.open:
            n = s - r.warmup
            done = (n >= r.trace_steps if r.trace
                    else time.perf_counter() - self.t_open >= r.seconds)
            if done and all(c < s for c in self.check):
                self.boundaries.append(self._event())
                r.sync()
                self.t_close = time.perf_counter()
                self.n_steps = n
                self.closed = True
                if self.tracer is not None:
                    self.tracer.stop((self.t_close - self.t_open) * 1e6, n)
                raise _Closed
        if s in self.check:
            # t and the draws' index follow from the step within the
            # chain, so the hook reads nothing back from the device
            self.captures[s] = {'state': tuple(a.clone() for a in args[1:4]),
                                't': r.T - 1 - self.chain_step,
                                'draw_step': self.chain_step,
                                'chain': r.chain}
        if self.open:
            self.boundaries.append(self._event())

    def _post(self, module, args, out):
        if self.step in self.check:
            self.captures[self.step]['preds'] = {
                k: v.clone() for k, v in out.items()}
        if self.open:
            self.after.append(self._event())
        self.step += 1
        self.chain_step += 1

    def remove(self):
        for h in self.handles:
            h.remove()


def run(cell, seed: int, seconds: float, trace: bool, device, result):
    """Measure one run of a sampling cell into `result` (core/runner.py
    RunResult); returns the evidence the reference judges."""
    from decompdiff_tpu_torch.models.diffusion_model import DecompDiffModel
    from decompdiff_tpu_torch.data.batch import ComplexBatch, FullProtein
    from decompdiff_tpu_torch.sampling.sampler import (
        SampleConfig, sample_diffusion)

    tr, mcfg = cell.traffic, dict(cell.model)
    check_config(mcfg)
    for key, known in MODES.items():
        if tr[key] not in known:
            raise SystemExit(f'perfbench: the sample driver follows {key} '
                             f'{known}, not {tr[key]!r}: such a mix needs '
                             'a driver of its own')
    if cell.workload['chips'] != 1:
        raise SystemExit('perfbench: the sample driver runs on one card')
    K, Kb = cell.config['atom_classes'], mcfg.get('num_bond_classes', 5)
    B = tr['batch']
    raw = draw_complexes(inputs.stream(seed, 'complex'), 1, tr['sizes'])[0]
    model = DecompDiffModel.create(mcfg, K, device=device, seed=0)
    shapes = {n: tuple(p.shape) for n, p in model.denoiser.named_parameters()}
    inputs.load_weights(model.denoiser,
                        inputs.draw_weights(shapes, seed, device))
    arrays, init, receptor, rmask = inputs.sampling_inputs(
        raw, B, K, Kb, seed, device)
    batch = ComplexBatch(**arrays)
    full = FullProtein(receptor, rmask)
    Nl = batch.num_ligand_atoms
    draw_shapes = {'pos_eps': (B, Nl, 3), 'v_uniform': (B, Nl, K)}
    if mcfg.get('bond_diffusion', False):
        draw_shapes['b_uniform'] = (B, Nl, Nl, Kb)
    scfg = SampleConfig(num_steps=tr['num_steps'], save_traj=False,
                        skip_mode=tr['skip_mode'],
                        center_pos_mode=mcfg.get('center_pos_mode',
                                                 'protein'),
                        energy_drift=tuple(tr['guidance']))

    u = np.random.default_rng(inputs.stream(seed, 'check')).random()

    def pick_check(step_s):
        expected = result.trace_steps if trace else seconds / step_s
        s = result.warmup + int(u * tr['check_fraction'] * expected)
        # a chain's last step hands its state to no later step
        return s + 1 if (s + 1) % tr['num_steps'] == 0 else s

    if trace:
        Tracer.initialise()
    hooks = StepHooks(result, model.denoiser, 0, pick_check)
    result.chain, result.T = 0, mcfg['num_diffusion_timesteps']
    try:
        while not hooks.closed:
            draws = inputs.StepDraws(seed, draw_shapes, device, result.chain)
            hooks.chain_step = 0
            try:
                sample_diffusion(model, scfg, batch, *init, full,
                                 noise_override=draws)
            except _Closed:
                break
            result.chain += 1
    finally:
        hooks.remove()
    result.window(hooks.t_open, hooks.t_close, hooks.n_steps, B)

    bounds = hooks.boundaries
    step_ms = ([a.elapsed_time(b) for a, b in zip(bounds[:-1], bounds[1:])]
               if result.cuda else [])
    den_ms = ([a.elapsed_time(b) for a, b in zip(bounds, hooks.after)]
              if result.cuda else [])
    result.e2e['sample_mol_steps_per_s'] = (B * hooks.n_steps
                                            / (hooks.t_close - hooks.t_open))
    if step_ms:
        result.e2e['sample_step_p95_ms'] = float(np.percentile(step_ms, 95))
    pmask = arrays['protein_mask'].sum(1).tolist()
    lmask = arrays['ligand_mask'].sum(1).tolist()
    shape = Shapes(Np=batch.num_protein_atoms, Nl=Nl, protein=tuple(pmask),
                   ligand=tuple(lmask), H=mcfg['hidden_dim'],
                   heads=mcfg['n_heads'], K=mcfg['knn'],
                   layers=mcfg['num_layers'], model_type=mcfg['model_type'],
                   classes=K, bond_classes=Kb)
    if hooks.tracer is not None:
        n = hooks.n_steps
        result.read_layers(kind='sample', trace=hooks.tracer.summary,
                           shapes=[shape] * n, denoiser_ms=den_ms[:n])
    caps = [hooks.captures[s] for s in sorted(hooks.captures)]
    result.notes['checked'] = [(c['chain'], c['t']) for c in caps]
    program = [dict(c['preds'], x=c['x'], v=c['v'], b=c['b']) for c in caps]
    del model, batch, full, hooks
    result.release()
    return SimpleNamespace(
        cell=cell, seed=seed, device=device, shapes=shapes,
        draw_shapes=draw_shapes, arrays=arrays, receptor=receptor,
        rmask=rmask, captures=caps, program=program)


def reference(ev, tf32: bool = False, half: bool = False) -> list:
    """The reference's outputs of each checked step, from the program's
    state at that step, in float32 with TF32 off, or (the control) with
    TF32 on; `half` plants a fault in its outputs, the second half of the
    batch left as it came in. Each step's dict holds the reference's
    predictions, Gumbel scores and x_{t-1}, and under x, v, b the next
    state it would hand on in the program's place."""
    tr, mcfg = ev.cell.traffic, ev.cell.model
    P = inputs.draw_weights(ev.shapes, ev.seed, ev.device)
    S = diffusion.schedules(mcfg, ev.device)
    out = []
    for cap in ev.captures:
        d = inputs.StepDraws(ev.seed, ev.draw_shapes, ev.device,
                             cap['chain']).step(cap['draw_step'])
        with steps.precision(tf32):
            ref = steps.sample_step(
                P, mcfg, S, ev.arrays, cap['state'], cap['t'], d,
                ev.receptor, ev.rmask, tr['guidance'], tr['reference_block'])
        if half:
            h = ref['x_next'].shape[0] // 2
            for k, v in ref.items():
                v[h:] = 0
            ref['x_next'][h:] = cap['state'][0][h:]
        # in the program's place: the sampled types are the argmax of the
        # Gumbel scores
        out.append(dict(ref, x=ref['x_next'], v=ref['v_scores'].argmax(-1),
                        b=(ref['b_scores'].argmax(-1) if 'b_scores' in ref
                           else None)))
    return out


def numbers(ev, outputs: list, refs: list) -> dict:
    """The worst over the checked steps of compare.sampling_numbers, for
    `outputs` (ev.program, or a reference in its place) against `refs`."""
    out = {}
    for got, ref in zip(outputs, refs):
        for k, v in compare.sampling_numbers(
                got, ref, ev.arrays['ligand_mask'],
                ev.arrays['bond_mask']).items():
            out[k] = max(out.get(k, v), v)
    return out
