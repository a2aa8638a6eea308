"""Log-space categorical (uniform-or-prior) diffusion for atom and bond
types (port of decompdiff_tpu/diffusion/categorical.py; ref
models/transitions.py:65-161).

Class variables live in [..., K] log-one-hot tensors; t is [B] and
broadcasts over the atom/bond axes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from decompdiff_tpu_torch.diffusion.schedules import cosine_alpha_schedule
from decompdiff_tpu_torch.parallel.mesh import draw_rows


def index_to_log_onehot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[...] int -> [..., K] log-one-hot, clamped at 1e-30
    (ref models/transitions.py:65-71)."""
    onehot = F.one_hot(x.long(), num_classes).float()
    return torch.log(torch.clamp(onehot, min=1e-30))


def log_onehot_to_index(log_x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(log_x, dim=-1)


def gumbel_argmax(uniform: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-max sample over the last axis from a uniform draw, with the
    reference's -log(-log(U + 1e-30) + 1e-30) construction
    (ref models/transitions.py:78-84)."""
    g = -torch.log(-torch.log(uniform + 1e-30) + 1e-30)
    return torch.argmax(g + logits, dim=-1)


def log_sample_categorical(logits: torch.Tensor,
                           generator: torch.Generator = None,
                           mesh=None) -> torch.Tensor:
    """Gumbel-max sample over the last axis, with a uniform draw from
    `generator` (ref models/transitions.py:78-84); with a data-parallel
    `mesh` the draw is the global batch's, this rank's rows kept."""
    uniform = draw_rows(lambda shape: torch.rand(
        shape, generator=generator, device=logits.device), logits.shape, mesh)
    return gumbel_argmax(uniform, logits)


def categorical_kl(log_p: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    """sum_k p (log p - log q) over the last axis
    (ref models/decompdiff.py:35-37)."""
    return (torch.exp(log_p) * (log_p - log_q)).sum(-1)


def log_categorical(log_x0: torch.Tensor,
                    log_prob: torch.Tensor) -> torch.Tensor:
    """sum_k onehot(x0) log_prob (ref models/decompdiff.py:40-41)."""
    return (torch.exp(log_x0) * log_prob).sum(-1)


def log_add_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    maximum = torch.maximum(a, b)
    return maximum + torch.log(torch.exp(a - maximum) + torch.exp(b - maximum))


def log_1_min_a(a: np.ndarray) -> np.ndarray:
    return np.log(1 - np.exp(a) + 1e-40)


@dataclasses.dataclass(frozen=True)
class CategoricalDiffusion:
    """Tables are [T]; prior_logprobs is [K] (log of the terminal
    distribution: uniform, or dataset marginals with `prior_types`)."""
    log_alphas: torch.Tensor
    log_one_minus_alphas: torch.Tensor
    log_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    prior_logprobs: torch.Tensor
    num_classes: int

    @classmethod
    def create(cls, noise_schedule: str, num_timesteps: int, s: float,
               num_classes: int, prior_probs=None,
               device=None) -> "CategoricalDiffusion":
        if noise_schedule != 'cosine':
            raise NotImplementedError(noise_schedule)
        alphas = cosine_alpha_schedule(num_timesteps, s)
        log_alphas = np.log(alphas)
        log_alphas_cumprod = np.cumsum(log_alphas)
        if prior_probs is None:
            prior = np.full((num_classes,), -np.log(num_classes))
        else:
            prior = np.log(np.clip(np.asarray(prior_probs, np.float64),
                                   1e-30, None))

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(
            log_alphas=t(log_alphas),
            log_one_minus_alphas=t(log_1_min_a(log_alphas)),
            log_alphas_cumprod=t(log_alphas_cumprod),
            log_one_minus_alphas_cumprod=t(log_1_min_a(log_alphas_cumprod)),
            prior_logprobs=t(prior),
            num_classes=num_classes,
        )

    @staticmethod
    def _coef(table, t, ndim):
        return table[t.long()].reshape(t.shape + (1,) * (ndim - 1))

    def q_v_pred_one_timestep(self, log_vt_1, t):
        """q(v_t | v_{t-1}) (ref models/transitions.py:123-133)."""
        log_alpha_t = self._coef(self.log_alphas, t, log_vt_1.ndim)
        log_1_min_alpha_t = self._coef(self.log_one_minus_alphas, t,
                                       log_vt_1.ndim)
        return log_add_exp(log_vt_1 + log_alpha_t,
                           log_1_min_alpha_t + self.prior_logprobs)

    def q_v_pred(self, log_v0, t):
        """q(v_t | v_0) (ref models/transitions.py:135-144)."""
        log_cum = self._coef(self.log_alphas_cumprod, t, log_v0.ndim)
        log_1_min_cum = self._coef(self.log_one_minus_alphas_cumprod, t,
                                   log_v0.ndim)
        return log_add_exp(log_v0 + log_cum,
                           log_1_min_cum + self.prior_logprobs)

    def q_v_sample(self, log_v0, t, generator=None, mesh=None):
        """Sample v_t ~ q(v_t | v_0); returns (index, log-one-hot)
        (ref models/transitions.py:146-150)."""
        idx = log_sample_categorical(self.q_v_pred(log_v0, t), generator,
                                     mesh)
        return idx, index_to_log_onehot(idx, self.num_classes)

    def q_v_posterior(self, log_v0, log_vt, t):
        """q(v_{t-1} | v_t, v_0), normalized over classes
        (ref models/transitions.py:153-161)."""
        t_minus_1 = torch.clamp(t - 1, min=0)
        log_qvt1_v0 = self.q_v_pred(log_v0, t_minus_1)
        unnormed = log_qvt1_v0 + self.q_v_pred_one_timestep(log_vt, t)
        return unnormed - torch.logsumexp(unnormed, dim=-1, keepdim=True)

    def _log_ab(self, s, ndim):
        """log alpha_bar_s; s == -1 denotes the clean endpoint (log = 0)."""
        tab = self.log_alphas_cumprod[torch.clamp(s.long(), min=0)]
        return torch.where(s >= 0, tab, 0.0).reshape(
            s.shape + (1,) * (ndim - 1))

    def q_v_pred_skip(self, log_vs, t, s):
        """q(v_t | v_s) for an arbitrary pair s < t: a mixture with
        alpha_ts = ab_t / ab_s (strided-sampling extension)."""
        log_a_ts = (self._coef(self.log_alphas_cumprod, t, log_vs.ndim)
                    - self._log_ab(s, log_vs.ndim))
        log_1m = torch.log(-torch.expm1(log_a_ts) + 1e-40)
        return log_add_exp(log_vs + log_a_ts, log_1m + self.prior_logprobs)

    def q_v_posterior_skip(self, log_v0, log_vt, t, s):
        """q(v_s | v_t, v_0) for an arbitrary earlier step s (s == -1 lands
        on the clean class)."""
        log_ab_s = self._log_ab(s, log_v0.ndim)
        log_qvs_v0 = log_add_exp(
            log_v0 + log_ab_s,
            torch.log(-torch.expm1(log_ab_s) + 1e-40) + self.prior_logprobs)
        unnormed = log_qvs_v0 + self.q_v_pred_skip(log_vt, t, s)
        return unnormed - torch.logsumexp(unnormed, dim=-1, keepdim=True)

    def sample_terminal(self, shape, generator=None) -> torch.Tensor:
        """Sample from the terminal distribution (init types at sampling
        time; ref scripts/sample_diffusion_decomp.py:306-312)."""
        logits = self.prior_logprobs.expand(tuple(shape) + (self.num_classes,))
        return log_sample_categorical(logits, generator)
