"""One guided sampling step and the first training steps, as the reference
computes them (plain PyTorch, float32 with TF32 off unless a control asks
for TF32), in blocks of rows so that the materialised attentions fit.

Every batch here is a dict of tensors under the port's ComplexBatch field
names, made by the harness (reference/featurize.py); nothing the program
derived enters, only the program's state where the reference follows it
one step (see compare.py).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from perfbench.reference import diffusion as D
from perfbench.reference.nets import denoise, knn_margin


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 matrix products with TF32 off (the reference), or on (the
    control: the nearest precision below the configuration's)."""
    m = torch.backends.cuda.matmul
    before = (m.allow_tf32, torch.backends.cudnn.allow_tf32)
    m.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def rows(b: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in b.items()}


@torch.no_grad()
def sample_step(P, cfg, S, batch, state, t, draws, receptor, receptor_mask,
                guidance, block):
    """One truncate-mode reverse step at timestep t from state (x_t centred,
    v_t, b_t) with the step's uniforms and normals. Returns the denoiser's
    predictions, each molecule's kNN margin (nets.knn_margin), the Gumbel
    scores of the atom and bond types (the sampled class is their argmax)
    and x_{t-1} (centred)."""
    xt, vt, bt = state
    B = xt.shape[0]
    out = {}
    for lo in range(0, B, block):
        hi = min(B, lo + block)
        b, offset = D.centred(rows(batch, lo, hi))
        x, v, bond = xt[lo:hi], vt[lo:hi], bt[lo:hi]
        tb = torch.full((hi - lo,), t, dtype=torch.long, device=x.device)
        preds = denoise(P, cfg, b, x, v, bond)
        preds['knn_margin'] = knn_margin(b, x, cfg['knn'])
        K = preds['pred_ligand_v'].shape[-1]
        log_v = D.q_v_posterior(S, F.log_softmax(preds['pred_ligand_v'], -1),
                                D.log_onehot(v, K), tb, K)
        part = dict(preds)
        part['v_scores'] = D.gumbel_scores(draws['v_uniform'][lo:hi], log_v)
        if 'pred_bond' in preds:
            Kb = preds['pred_bond'].shape[-1]
            log_b = D.q_v_posterior(S, F.log_softmax(preds['pred_bond'], -1),
                                    D.log_onehot(bond, Kb), tb, Kb)
            part['b_scores'] = D.gumbel_scores(draws['b_uniform'][lo:hi],
                                               log_b)
        mean = (D.at(S['c0'], tb, 3) * preds['pred_ligand_pos']
                + D.at(S['ct'], tb, 3) * x)
        mean = mean - D.guidance_grad(
            guidance, b, x, offset, receptor[lo:hi], receptor_mask[lo:hi], B)
        noise = (float(t > 0) * torch.exp(0.5 * D.at(S['logvar'], tb, 3))
                 * draws['pos_eps'][lo:hi] * D.per_atom(b, 'prior_stds'))
        part['x_next'] = torch.where(b['ligand_mask'][..., None], mean + noise,
                                     x)
        for k, val in part.items():
            out.setdefault(k, []).append(val)
    return {k: torch.cat(v) for k, v in out.items()}


def draw_train(gen, batch, T, K, Kb):
    """The draws of one training step, in the order the algorithm takes
    them from its generator: the protein and prior-centre jitter, the
    antithetic timesteps, the coordinate noise, the atom-type and the
    bond-type uniforms (Kb None: no bond diffusion, no bond draw)."""
    dev = batch['protein_pos'].device
    B, Nl = batch['ligand_pos'].shape[:2]
    d = {'jit_p': torch.randn(batch['protein_pos'].shape, generator=gen,
                              device=dev),
         'jit_c': torch.randn(batch['prior_centers'].shape, generator=gen,
                              device=dev)}
    half = torch.randint(0, T, (B // 2 + 1,), generator=gen, device=dev)
    d['t'] = torch.cat([half, T - half - 1])[:B]
    d['pos_noise'] = torch.randn((B, Nl, 3), generator=gen, device=dev)
    d['u_v'] = torch.rand((B, Nl, K), generator=gen, device=dev)
    if Kb:
        d['u_b'] = torch.rand((B, Nl, Nl, Kb), generator=gen, device=dev)
    return d


def _kl_term(S, log_recon, log_x0, log_xt, t, mask, K):
    """Per-graph masked mean of KL(q(x_{t-1}|x_t,x_0) || p_theta), the
    decoder NLL at t = 0."""
    log_model = D.q_v_posterior(S, log_recon, log_xt, t, K)
    log_true = D.q_v_posterior(S, log_x0, log_xt, t, K)
    kl = (torch.exp(log_true) * (log_true - log_model)).sum(-1)
    nll = -(torch.exp(log_x0) * log_model).sum(-1)
    t0 = (t == 0).to(kl.dtype).reshape(t.shape + (1,) * (kl.ndim - 1))
    per = t0 * nll + (1.0 - t0) * kl
    m = mask.to(per.dtype)
    dims = tuple(range(1, per.ndim))
    return (per * m).sum(dims) / torch.clamp(m.sum(dims), min=1.0)


def train_losses(P, cfg, S, b, d, train_cfg):
    """Per-graph weighted loss [rows] and the per-term per-graph losses of
    rows `b` with their draws `d` (ref models/decompdiff.py:419-550 and
    scripts/train_diffusion_decomp.py:160-164)."""
    b = dict(b)
    b['protein_pos'] = (b['protein_pos']
                        + train_cfg['pos_noise_std'] * d['jit_p'])
    b['prior_centers'] = (b['prior_centers']
                          + train_cfg['prior_noise_std'] * d['jit_c'])
    t = d['t']
    centers, stds = D.per_atom(b, 'prior_centers'), D.per_atom(b, 'prior_stds')
    x0 = b['ligand_pos']
    x_pert = (D.at(S['sqrt_ac'], t, 3) * (x0 - centers)
              + D.at(S['sqrt_1m_ac'], t, 3) * d['pos_noise'] * stds + centers)
    K = d['u_v'].shape[-1]
    log_v0 = D.log_onehot(b['ligand_v'], K)
    v_t = D.gumbel_scores(d['u_v'], D.q_v_pred(S, log_v0, t, K)).argmax(-1)
    log_vt = D.log_onehot(v_t, K)
    v_t = torch.where(b['ligand_mask'], v_t, 0)
    b_t = b['bond_type']
    if 'u_b' in d:
        Kb = d['u_b'].shape[-1]
        log_b0 = D.log_onehot(b['bond_type'], Kb)
        b_t = D.gumbel_scores(d['u_b'], D.q_v_pred(S, log_b0, t, Kb)
                              ).argmax(-1)
        log_bt = D.log_onehot(b_t, Kb)
        b_t = torch.where(b['bond_mask'], b_t, 0)
    c, offset = D.centred(b)
    preds = denoise(P, cfg, c, x_pert - offset[:, None], v_t, b_t)
    target = x0 - offset[:, None]
    per_atom = (((preds['pred_ligand_pos'] - target) ** 2) / stds ** 2).sum(-1)
    m = b['ligand_mask'].to(per_atom.dtype)
    terms = {'pos': (per_atom * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0),
             'v': _kl_term(S, F.log_softmax(preds['pred_ligand_v'], -1),
                           log_v0, log_vt, t, b['ligand_mask'], K)}
    if cfg.get('bond_diffusion', False):
        terms['bond'] = _kl_term(S, F.log_softmax(preds['pred_bond'], -1),
                                 log_b0, log_bt, t, b['bond_mask'], Kb)
    w = train_cfg['loss_weights']
    return sum(w[k] * v for k, v in terms.items()), terms


class Adam:
    """Global-norm clipping (gradients pass below the limit and are scaled
    to it above), then Adam with bias correction."""

    def __init__(self, params: dict, opt: dict, max_norm: float,
                 state=None):
        """`state`: (first moments, second moments, steps taken) to go on
        from; None starts from zero."""
        self.lr, self.b1, self.b2 = opt['lr'], opt['beta1'], opt['beta2']
        self.eps, self.max_norm = 1e-8, max_norm
        if state is None:
            state = ({k: torch.zeros_like(p) for k, p in params.items()},
                     {k: torch.zeros_like(p) for k, p in params.items()}, 0)
        m, v, self.t = state
        self.m = {k: m[k].clone() for k in params}
        self.v = {k: v[k].clone() for k in params}

    def step(self, params: dict, grads: dict) -> dict:
        """Updates params in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(norm >= self.max_norm, self.max_norm / norm,
                            torch.ones_like(norm))
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        clipped = {}
        for k, p in params.items():
            g = clipped[k] = grads[k] * scale
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            p -= (self.lr / c1) * self.m[k] / (
                torch.sqrt(self.v[k]) / math.sqrt(c2) + self.eps)
        return clipped


def train_steps(P, cfg, S, batches, gen_states, train_cfg, block,
                keep=None, opt_state=None):
    """Steps of the reference from parameters P (updated in place) and
    Adam's `opt_state` (None: a fresh optimizer): for each batch its draws
    from the generator state the program's step started from, the loss and
    its gradient summed over blocks of rows, then the clip and Adam.
    Returns the losses, the first step's clipped gradients and the
    optimizer. `keep` plants a fault for the calibration: only the first
    `keep` rows, the mean taken over them."""
    T = cfg['num_diffusion_timesteps']
    K = P['v_inf_1.kernel'].shape[1]
    Kb = (cfg.get('num_bond_classes', 5) if cfg.get('bond_diffusion', False)
          else None)
    opt = Adam(P, train_cfg['optimizer'], train_cfg['max_grad_norm'],
               opt_state)
    losses, first = [], None
    for batch, state in zip(batches, gen_states):
        gen = torch.Generator(device=batch['protein_pos'].device)
        gen.set_state(state)
        d = draw_train(gen, batch, T, K, Kb)
        B = keep or batch['protein_pos'].shape[0]
        grads = {k: torch.zeros_like(p) for k, p in P.items()}
        total = 0.0
        for lo in range(0, B, block):
            hi = min(B, lo + block)
            leaves = {k: p.detach().requires_grad_(True) for k, p in P.items()}
            with torch.enable_grad():
                loss, _ = train_losses(leaves, cfg, S, rows(batch, lo, hi),
                                       rows(d, lo, hi), train_cfg)
                loss = loss.sum() / B
                gs = torch.autograd.grad(loss, list(leaves.values()),
                                         allow_unused=True)
            for (k, _), g in zip(leaves.items(), gs):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            clipped = opt.step(P, grads)
        if first is None:
            first = clipped
    return losses, first, opt
