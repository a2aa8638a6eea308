"""Decomposed-prior Gaussian coordinate diffusion (port of
decompdiff_tpu/diffusion/gaussian.py).

Forward process anchored on per-arm/scaffold prior centers/stds
(ref models/decompdiff.py:437-447):

    x_t = sqrt(a_bar) * (x0 - mu_k) + sqrt(1 - a_bar) * eps * sigma_k + mu_k

The reverse posterior mean uses the unanchored DDPM coefficients
(ref :358-362), and the reverse noise is scaled by the prior std (ref
:679-681). x is [B, Nl, 3]; t and s are [B] integer timesteps.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Optional

import torch

from decompdiff_tpu_torch.diffusion.schedules import pos_schedule_coefficients


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Coefficient tables (float32 tensors of shape [T] on one device)."""
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    one_minus_alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_mean_c0_coef: torch.Tensor
    posterior_mean_ct_coef: torch.Tensor
    posterior_var: torch.Tensor
    posterior_logvar: torch.Tensor
    pos_score_coef: torch.Tensor

    @classmethod
    def create(cls, config: dict, device) -> "GaussianDiffusion":
        coefs = pos_schedule_coefficients(types.SimpleNamespace(**config))
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: torch.as_tensor(v, device=device)
                      for k, v in coefs.items() if k in names})

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @staticmethod
    def _bcast(coef_t: torch.Tensor, ndim: int) -> torch.Tensor:
        """[B] -> [B, 1, ..., 1] with `ndim` total dims."""
        return coef_t.reshape(coef_t.shape + (1,) * (ndim - 1))

    def extract(self, table, t, ndim):
        return self._bcast(table[t.long()], ndim)

    def q_sample(self, x0, t, noise, centers, stds):
        """Anchored forward sample x_t (ref models/decompdiff.py:442-447)."""
        a = self.extract(self.sqrt_alphas_cumprod, t, x0.ndim)
        one_minus = self.extract(self.sqrt_one_minus_alphas_cumprod, t, x0.ndim)
        return a * (x0 - centers) + one_minus * noise * stds + centers

    def predict_x0_from_eps(self, xt, eps, t):
        """ref models/decompdiff.py:353-356."""
        return (self.extract(self.sqrt_recip_alphas_cumprod, t, xt.ndim) * xt -
                self.extract(self.sqrt_recipm1_alphas_cumprod, t, xt.ndim) * eps)

    def q_posterior_mean(self, x0, xt, t):
        """Posterior mean c0*x0 + ct*xt (ref models/decompdiff.py:358-362)."""
        return (self.extract(self.posterior_mean_c0_coef, t, xt.ndim) * x0 +
                self.extract(self.posterior_mean_ct_coef, t, xt.ndim) * xt)

    def _ab_pair(self, t, s, ndim):
        """(ab_t, om_t, ab_s, om_s) for skip steps, with om = 1 - alpha_bar
        from the f64-computed complement table; s == -1 denotes the clean
        endpoint (ab = 1, om = 0)."""
        ab_t = self.extract(self.alphas_cumprod, t, ndim)
        om_t = self.extract(self.one_minus_alphas_cumprod, t, ndim)
        sc = torch.clamp(s.long(), min=0)
        live = s >= 0
        ab_s = self._bcast(torch.where(live, self.alphas_cumprod[sc], 1.0),
                           ndim)
        om_s = self._bcast(
            torch.where(live, self.one_minus_alphas_cumprod[sc], 0.0), ndim)
        return ab_t, om_t, ab_s, om_s

    def q_posterior_mean_skip(self, x0, xt, t, s):
        """Posterior mean of q(x_s | x_t, x0) for an arbitrary earlier step
        s < t (strided sampling); s == t-1 gives `q_posterior_mean`."""
        ab_t, om_t, ab_s, om_s = self._ab_pair(t, s, xt.ndim)
        one_minus_a_ts = (om_t - om_s) / ab_s
        c0 = torch.sqrt(ab_s) * one_minus_a_ts / om_t
        ct = torch.sqrt(ab_t / ab_s) * om_s / om_t
        return c0 * x0 + ct * xt

    def posterior_logvar_skip(self, t, s, ndim):
        """log Var[q(x_s | x_t, x0)]; the s == -1 endpoint is clamped (the
        caller gates the noise on s >= 0)."""
        ab_t, om_t, ab_s, om_s = self._ab_pair(t, s, ndim)
        var = om_s / om_t * (om_t - om_s) / ab_s
        return torch.log(torch.clamp(var, min=1e-20))

    def reverse_step(self, generator: Optional[torch.Generator], x0_pred,
                     xt, t, stds, noise: Optional[torch.Tensor] = None):
        """One ancestral step: mean + 1[t>0] * exp(0.5 logvar) * eps *
        sigma_k (ref models/decompdiff.py:612-615,679-684). eps is drawn
        from `generator` on xt's device, or is `noise` when given."""
        mean = self.q_posterior_mean(x0_pred, xt, t)
        logvar = self.extract(self.posterior_logvar, t, xt.ndim)
        nonzero = self._bcast((t > 0).to(xt.dtype), xt.ndim)
        if noise is None:
            noise = torch.randn(xt.shape, generator=generator,
                                device=xt.device, dtype=xt.dtype)
        return mean + nonzero * torch.exp(0.5 * logvar) * noise * stds

    # -- losses --------------------------------------------------------------
    @staticmethod
    def pos_mse_per_graph(pred, target, stds, atom_mask):
        """std-normalized per-graph-mean MSE (ref models/decompdiff.py:
        530-531): pred/target/stds [B, Nl, 3], atom_mask [B, Nl] bool ->
        [B], the mean over real atoms of sum_xyz (pred - target)^2 / sigma^2.
        The per-graph values feed the importance-sampling Lt history."""
        per_atom = (((pred - target) ** 2) / (stds ** 2)).sum(-1)
        m = atom_mask.to(per_atom.dtype)
        return (per_atom * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)

    def pos_mse_loss(self, pred, target, stds, atom_mask):
        """Scalar mean over graphs of `pos_mse_per_graph`."""
        return self.pos_mse_per_graph(pred, target, stds, atom_mask).mean()


def normal_kl(mean1, logvar1, mean2, logvar2):
    """ref models/decompdiff.py:44-49 (sum over last dim)."""
    kl = 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                + (mean1 - mean2) ** 2 * torch.exp(-logvar2))
    return kl.sum(-1)


def log_normal(values, means, log_scales):
    """ref models/decompdiff.py:52-55 (sum over last dim)."""
    var = torch.exp(log_scales * 2)
    log_prob = (-((values - means) ** 2) / (2 * var) - log_scales
                - math.log(math.sqrt(2 * math.pi)))
    return log_prob.sum(-1)
