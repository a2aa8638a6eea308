"""The diffusion processes, guidance energies, one sampling step and the
training loss of DecompDiff, in plain PyTorch (float32) and numpy.

Written from the published description (bytedance/DecompDiff
models/decompdiff.py, models/transitions.py, utils/guidance_funcs.py): the
sigmoid beta schedule for coordinates anchored on the decomposed priors,
the cosine schedule for the categorical atom and bond types, the
armsca_prox and clash guidance, the ancestral update with prior-std-scaled
noise, and the sigma-normalised MSE plus categorical KL losses. It imports
nothing of the program. Schedule tables are computed in float64 and kept
in float32, as the reference code registers them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BIG = 1e10


# --- schedules ---------------------------------------------------------------

def _cosine_sqrt_alphas(T: int, s: float) -> np.ndarray:
    steps = T + 1
    x = np.linspace(0, steps, steps)
    ac = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    return np.sqrt(np.clip(ac[1:] / ac[:-1], 0.001, 1.0))


def schedules(cfg: dict, device) -> dict:
    """The coordinate and categorical tables of a model config."""
    T = cfg['num_diffusion_timesteps']
    if cfg['beta_schedule'] != 'sigmoid' or cfg['v_beta_schedule'] != 'cosine':
        raise ValueError('the reference implements the sigmoid coordinate '
                         'and cosine type schedules')
    x = np.linspace(-6, 6, T)
    betas = (1.0 / (1.0 + np.exp(-x)) * (cfg['beta_end'] - cfg['beta_start'])
             + cfg['beta_start'])
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    var = betas * (1.0 - ac_prev) / (1.0 - ac)
    log_a = np.log(_cosine_sqrt_alphas(T, cfg.get('v_beta_s', 0.01)))
    log_ac = np.cumsum(log_a)
    tabs = {
        'sqrt_ac': np.sqrt(ac), 'sqrt_1m_ac': np.sqrt(1.0 - ac),
        'c0': betas * np.sqrt(ac_prev) / (1.0 - ac),
        'ct': (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
        'logvar': np.log(np.append(var[1], var[1:])),
        'log_a': log_a, 'log_1m_a': np.log(1 - np.exp(log_a) + 1e-40),
        'log_ac': log_ac, 'log_1m_ac': np.log(1 - np.exp(log_ac) + 1e-40),
    }
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in tabs.items()}


def at(table, t, ndim):
    return table[t.long()].reshape(t.shape + (1,) * (ndim - 1))


# --- categorical types -------------------------------------------------------

def log_onehot(x, K):
    return torch.log(torch.clamp(F.one_hot(x.long(), K).float(), min=1e-30))


def log_add_exp(a, b):
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def q_v_pred(S, log_v0, t, K):
    """log q(v_t | v_0) towards the uniform prior."""
    n = log_v0.ndim
    return log_add_exp(log_v0 + at(S['log_ac'], t, n),
                       at(S['log_1m_ac'], t, n) - float(np.log(K)))


def q_v_posterior(S, log_v0, log_vt, t, K):
    """log q(v_{t-1} | v_t, v_0), normalised over the classes."""
    n = log_v0.ndim
    one = log_add_exp(log_vt + at(S['log_a'], t, n),
                      at(S['log_1m_a'], t, n) - float(np.log(K)))
    u = q_v_pred(S, log_v0, torch.clamp(t - 1, min=0), K) + one
    return u - torch.logsumexp(u, -1, keepdim=True)


def gumbel_scores(uniform, logits):
    return -torch.log(-torch.log(uniform + 1e-30) + 1e-30) + logits


# --- guidance ----------------------------------------------------------------

def _norm(v):
    return torch.sqrt(torch.clamp((v * v).sum(-1), min=1e-12))


def armsca_prox(x, decomp, num_arms, lig_mask, A, min_d, max_d,
                batch_size):
    """Each arm's closest approach to the scaffold held inside [min_d,
    max_d]: the hinge averaged over arms, summed over graphs, over the
    batch size (ref utils/guidance_funcs.py)."""
    decomp, num_arms = decomp.long(), num_arms.long()
    is_arm = (decomp < num_arms[:, None]) & lig_mask
    is_sca = (decomp == num_arms[:, None]) & lig_mask
    d = _norm(x[:, :, None, :] - x[:, None, :, :])
    d = torch.where(is_arm[:, :, None] & is_sca[:, None, :], d, BIG)
    near = d.amin(2)
    groups = torch.arange(A, device=x.device)
    in_g = (decomp[:, :, None] == groups) & is_arm[:, :, None]
    per_arm = torch.where(in_g, near[:, :, None], BIG).amin(1)
    ok = per_arm < BIG / 2
    hinge = torch.where(ok, torch.clamp(min_d - per_arm, min=0.0)
                        + torch.clamp(per_arm - max_d, min=0.0), 0.0)
    n_ok = ok.sum(1).to(x.dtype)
    per_graph = hinge.sum(1) / torch.clamp(n_ok, min=1.0)
    return (per_graph * (n_ok > 0).to(x.dtype)).sum() / batch_size


def clash(receptor, receptor_mask, x, lig_mask, sigma, gamma):
    """Ligand atoms kept outside the receptor's smoothed surface
    -sigma log(1e-3 + sum exp(-d^2 / sigma)), per-graph mean, summed."""
    d2 = ((x[:, :, None, :] - receptor[:, None, :, :]) ** 2).sum(-1)
    e = torch.where(receptor_mask[:, None, :], torch.exp(-d2 / sigma), 0.0)
    g = -sigma * torch.log(1e-3 + e.sum(2))
    viol = torch.clamp(gamma - g, min=0.0)
    m = lig_mask.to(viol.dtype)
    return ((viol * m).sum(1) / torch.clamp(m.sum(1), min=1.0)).sum()


def guidance_grad(guidance, b, xt, offset, receptor, receptor_mask,
                  batch_size):
    """Gradient at x_t of the summed energies (armsca_prox on the centred
    coordinates, clash on the un-centred ones). `guidance` is the traffic
    file's list; armsca_prox's mean is over the whole batch's
    `batch_size` graphs, so rows can be taken in blocks."""
    x = xt.detach().requires_grad_(True)
    with torch.enable_grad():
        total = 0.0
        for d in guidance:
            if d['type'] == 'armsca_prox':
                total = total + armsca_prox(
                    x, b['ligand_decomp_idx'], b['num_arms'],
                    b['ligand_mask'], b['prior_centers'].shape[1],
                    d['min_d'], d['max_d'], batch_size)
            elif d['type'] == 'clash':
                total = total + clash(receptor, receptor_mask,
                                      x + offset[:, None, :],
                                      b['ligand_mask'], d['sigma'],
                                      d['gamma'])
            else:
                raise ValueError(d['type'])
        return torch.autograd.grad(total, x)[0]


# --- the batch ---------------------------------------------------------------

def centred(b: dict):
    """(batch with the protein and priors translated to the protein
    centroid, the offset [B, 3])."""
    m = b['protein_mask'][..., None].to(b['protein_pos'].dtype)
    offset = (b['protein_pos'] * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    c = dict(b)
    c['protein_pos'] = b['protein_pos'] - offset[:, None]
    c['prior_centers'] = b['prior_centers'] - offset[:, None]
    return c, offset


def per_atom(b, key):
    idx = b['ligand_decomp_idx'].long()[..., None].expand(-1, -1, 3)
    return torch.gather(b[key], 1, idx)
