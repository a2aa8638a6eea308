"""Reverse diffusion sampling (port of decompdiff_tpu/sampling/sampler.py;
ref models/decompdiff.py:552-703).

A Python loop over the steps: the denoiser runs under torch.no_grad(), the
categorical posteriors are sampled by Gumbel argmax, the guidance gradient is
torch.autograd.grad of the summed energies at x_t, and the ancestral update
adds prior-std-scaled noise. Randomness comes from an explicit
torch.Generator, or from `noise_override` (the same injected draws the JAX
sampler takes, for parity tests). Given a data-parallel mesh and this
rank's rows of the batch (parallel/mesh.py), each draw is made at the
global batch's shape and this rank's rows kept; `noise_override` stays
global.

Spans (utils/profiling.py, recorded only while recording is on): each
step is `sample.step`, holding `sample.denoiser`, `sample.guidance` (the
guidance gradient at x_t, taken before the posteriors, which do not feed
it) and `sample.posterior` (the type, bond and position posteriors, the
draws, the host drift's `sample.host_drift` and the ancestral update).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from decompdiff_tpu_torch.data.batch import ComplexBatch, FullProtein
from decompdiff_tpu_torch.diffusion.categorical import (
    gumbel_argmax, index_to_log_onehot)
from decompdiff_tpu_torch.guidance.funcs import (
    armsca_prox_energy, center_prox_energy, clash_energy)
from decompdiff_tpu_torch.models.diffusion_model import (
    DecompDiffModel, center_by_protein)
from decompdiff_tpu_torch.parallel.mesh import Mesh, draw_rows, take_rows
from decompdiff_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    num_steps: int = 1000
    save_traj: bool = True
    center_pos_mode: str = 'protein'
    # num_steps < T: 'truncate' runs the LAST num_steps of the chain
    # (t = T-1 .. T-num_steps); 'strided' spreads num_steps timesteps evenly
    # over [0, T-1], each jump using the exact skip posteriors
    skip_mode: str = 'truncate'
    # e.g. ({'type': 'armsca_prox', 'min_d': 1.2, 'max_d': 1.9},
    #       {'type': 'clash', 'sigma': 2.0, 'gamma': 4.0})
    energy_drift: Tuple[Any, ...] = ()
    # host drift f(pos_mean [B, Nl, 3] float32 (centered), v_next [B, Nl],
    # ligand_mask [B, Nl]) -> [B, Nl, 3], numpy in and out (guidance/
    # {mmff,ffmin,ring}.py), subtracted from the posterior mean at the steps
    # with mmff_end_time <= t < mmff_start_time (ref models/decompdiff.py:
    # 669-672)
    mmff_callback: Optional[Callable] = None
    mmff_start_time: int = 0
    mmff_end_time: int = 0


def _guidance_grad(model: DecompDiffModel, cfg: SampleConfig,
                   batch: ComplexBatch, xt, t, offset,
                   full_protein: Optional[FullProtein],
                   mesh: Optional[Mesh] = None):
    """Total energy gradient at x_t (centered coordinates); the gradient of
    `scale: true` terms is multiplied by pos_score_coef[t]
    (ref models/decompdiff.py:638-677). armsca_prox divides by the global
    batch size under a mesh, as it does in a world of one."""
    drifts = [dict(d) for d in cfg.energy_drift]
    if not drifts:
        return torch.zeros_like(xt)
    x = xt.detach().requires_grad_(True)
    plain, scaled = [], []
    with torch.enable_grad():
        for d in drifts:
            if d['type'] == 'center_prox':
                plain.append(center_prox_energy(
                    x, batch.atom_prior_centers(), batch.ligand_mask))
                continue
            if d['type'] == 'armsca_prox':
                term = armsca_prox_energy(
                    x, batch.ligand_decomp_idx, batch.num_arms,
                    batch.ligand_mask, batch.num_groups,
                    min_d=d.get('min_d', 1.2), max_d=d.get('max_d', 1.9),
                    batch_size=batch.batch_size * (
                        1 if mesh is None else mesh.world_size))
            elif d['type'] == 'clash':
                term = clash_energy(
                    full_protein.pos, full_protein.mask,
                    x + offset[:, None, :],  # un-centered (ref :662)
                    batch.ligand_mask,
                    sigma=d.get('sigma', 25.0),
                    surface_ct=d.get('gamma', 10.0))
            elif d['type'] == 'mmff_min':
                continue  # a host callback, not an energy
            else:
                raise ValueError(d['type'])
            (scaled if d.get('scale', False) else plain).append(term)
        grad = torch.zeros_like(xt)
        if plain:
            grad = grad + torch.autograd.grad(sum(plain), x,
                                              retain_graph=bool(scaled))[0]
        if scaled:
            coef = model.pos_diff.extract(model.pos_diff.pos_score_coef, t,
                                          xt.ndim)
            grad = grad + torch.autograd.grad(sum(scaled), x)[0] * coef
    return grad


def _host_drift(callback, pos_mean, v_next, ligand_mask):
    """callback on host numpy copies (the copies wait for the device), its
    float32 drift back on pos_mean's device."""
    drift = callback(pos_mean.cpu().numpy(), v_next.cpu().numpy(),
                     ligand_mask.cpu().numpy())
    drift = np.asarray(drift, np.float32)
    if drift.shape != tuple(pos_mean.shape):
        raise ValueError(f'mmff_callback returned shape {drift.shape}, '
                         f'expected {tuple(pos_mean.shape)}')
    return torch.as_tensor(drift, device=pos_mean.device)


def _time_sequence(cfg: SampleConfig, T: int):
    """(t per step, s per step): s is the step each jump lands on."""
    if cfg.skip_mode == 'strided':
        if cfg.num_steps > T:
            raise ValueError(f'strided sampling needs num_steps <= '
                             f'num_timesteps ({cfg.num_steps} > {T})')
        ts = np.linspace(T - 1, 0, cfg.num_steps).round().astype(np.int64)
        return ts, np.append(ts[1:], -1)
    if cfg.skip_mode != 'truncate':
        raise ValueError(cfg.skip_mode)
    ts = np.arange(T - 1, T - cfg.num_steps - 1, -1)
    return ts, ts - 1


@torch.no_grad()
def sample_diffusion(model: DecompDiffModel, cfg: SampleConfig,
                     batch: ComplexBatch, init_pos, init_v, init_bond,
                     full_protein: Optional[FullProtein] = None,
                     noise_override: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None,
                     mesh: Optional[Mesh] = None):
    """Run the reverse diffusion on the model's device.

    Args:
        batch: padded complex batch (batch.ligand_pos is ignored)
        init_pos [B, Nl, 3], init_v [B, Nl], init_bond [B, Nl, Nl]:
            the initial state
        full_protein: un-cropped protein for clash guidance
        noise_override: per-step draws replacing the generator — 'pos_eps'
            [S, B, Nl, 3], 'v_uniform' [S, B, Nl, K] and, with bond
            diffusion, 'b_uniform' [S, B, Nl, Nl, Kb]
        generator: torch.Generator on the model's device for the draws
        mesh: data-parallel world; batch, the initial state and
            full_protein are this rank's rows, noise_override the global
            batch's

    Returns a dict: final 'pos'/'v'/'bond' [+ 'traj', stacked over steps,
    newest last].
    """
    if full_protein is None and any(d.get('type') == 'clash'
                                    for d in cfg.energy_drift):
        raise ValueError('clash guidance needs full_protein (the un-cropped '
                         'protein; ref scripts/sample_diffusion_decomp.py:'
                         '564-565)')
    device = model.device
    strided = cfg.skip_mode == 'strided'
    protein_pos_c, xt, offset = center_by_protein(batch, init_pos,
                                                  cfg.center_pos_mode)
    batch = batch.replace(protein_pos=protein_pos_c,
                          prior_centers=batch.prior_centers - offset[:, None, :])
    vt, bt = init_v, init_bond
    B = batch.batch_size
    upd = batch.update_mask()
    stds = batch.atom_prior_stds()
    ts, ss = _time_sequence(cfg, model.num_timesteps)
    traj = []

    def draw(key, step, shape, normal=False):
        if noise_override is not None:
            return take_rows(torch.as_tensor(noise_override[key][step],
                                             device=device), mesh)
        fn = torch.randn if normal else torch.rand
        return draw_rows(lambda s: fn(s, generator=generator, device=device),
                         shape, mesh)

    for step, (t, s) in enumerate(zip(ts.tolist(), ss.tolist())):
        with span('sample.step', step=step):
            tb = torch.full((B,), t, dtype=torch.long, device=device)
            sb = torch.full((B,), s, dtype=torch.long, device=device)
            with span('sample.denoiser'):
                preds = model.apply(batch, xt, vt, bt, tb)

            # guidance at x_t (ref :638-677); strided applies it once per
            # jump, scaled by the jump length t - s
            with span('sample.guidance'):
                grad = _guidance_grad(model, cfg, batch, xt, tb, offset,
                                      full_protein, mesh)
                if strided:
                    grad = grad * float(t - s)

            with span('sample.posterior'):
                # positions (C0 / noise parameterization; ref :601-613)
                if model.config.get('model_mean_type', 'C0') == 'C0':
                    pos0 = preds['pred_ligand_pos']
                else:
                    pos0 = model.pos_diff.predict_x0_from_eps(
                        xt, preds['pred_ligand_pos'] - xt, tb)

                # atom types (ref :617-622; strided: exact skip posterior)
                log_v_recon = torch.log_softmax(preds['pred_ligand_v'],
                                                dim=-1)
                log_vt = index_to_log_onehot(vt, model.atom_diff.num_classes)
                if strided:
                    log_v_model = model.atom_diff.q_v_posterior_skip(
                        log_v_recon, log_vt, tb, sb)
                else:
                    log_v_model = model.atom_diff.q_v_posterior(
                        log_v_recon, log_vt, tb)
                v_next = gumbel_argmax(
                    draw('v_uniform', step, log_v_model.shape), log_v_model)
                v_next = torch.where(upd, v_next, vt.long()).to(vt.dtype)

                # bonds (ref :628-636)
                if model.bond_diffusion:
                    log_b_recon = torch.log_softmax(preds['pred_bond'],
                                                    dim=-1)
                    log_bt = index_to_log_onehot(bt,
                                                 model.bond_diff.num_classes)
                    if strided:
                        log_b_model = model.bond_diff.q_v_posterior_skip(
                            log_b_recon, log_bt, tb, sb)
                    else:
                        log_b_model = model.bond_diff.q_v_posterior(
                            log_b_recon, log_bt, tb)
                    b_next = gumbel_argmax(
                        draw('b_uniform', step, log_b_model.shape),
                        log_b_model)
                    b_next = torch.where(batch.bond_mask, b_next,
                                         0).to(bt.dtype)
                else:
                    b_next = bt

                if strided:
                    pos_mean = model.pos_diff.q_posterior_mean_skip(
                        pos0, xt, tb, sb)
                else:
                    pos_mean = model.pos_diff.q_posterior_mean(pos0, xt, tb)
                pos_mean = pos_mean - grad

                # the host drift, only inside its window (t of the step, in
                # strided mode the jump's start): outside it no copy to the
                # host is made
                if (cfg.mmff_callback is not None
                        and cfg.mmff_end_time <= t < cfg.mmff_start_time):
                    with span('sample.host_drift'):
                        pos_mean = pos_mean - _host_drift(
                            cfg.mmff_callback, pos_mean, v_next,
                            batch.ligand_mask)

                # ancestral update with prior-std-scaled noise
                # (ref :679-684)
                if strided:
                    logvar = model.pos_diff.posterior_logvar_skip(tb, sb,
                                                                  xt.ndim)
                    nonzero = float(s >= 0)
                else:
                    logvar = model.pos_diff.extract(
                        model.pos_diff.posterior_logvar, tb, xt.ndim)
                    nonzero = float(t > 0)
                noise = draw('pos_eps', step, xt.shape, normal=True)
                x_next = (pos_mean
                          + nonzero * torch.exp(0.5 * logvar) * noise * stds)
                xt = torch.where(upd[..., None], x_next, xt)
            vt, bt = v_next, b_next

            if cfg.save_traj:
                out = {'pos': xt + offset[:, None, :], 'v': vt,
                       'v0_log': log_v_recon, 'vt_log': log_v_model}
                if model.bond_diffusion:
                    out['bond'] = bt
                traj.append(out)

    result = {'pos': xt + offset[:, None, :], 'v': vt, 'bond': bt}
    if cfg.save_traj:
        result['traj'] = {k: torch.stack([o[k] for o in traj])
                          for k in traj[0]} if traj else {}
    return result
