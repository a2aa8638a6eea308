"""Diffusion noise schedules (a copy of decompdiff_tpu/diffusion/schedules.py).

Pure numpy, computed once at model build time and turned into device
tensors. Behavioral parity:
  * cosine alpha schedule (sqrt-ed, clipped):  ref models/transitions.py:12-28
  * quad/linear/const/jsd/sigmoid beta schedules: ref models/transitions.py:31-61
The released config (configs/training.yml) uses `sigmoid` (1e-7 -> 2e-3) for
coordinates and `cosine` (s=0.01) for the categorical processes.
"""

import numpy as np


def cosine_alpha_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol-Dhariwal cosine schedule, returning sqrt(alpha_t) per the
    reference convention (their per-step 'alpha' is the sqrt of the DDPM one).
    """
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    alphas = alphas_cumprod[1:] / alphas_cumprod[:-1]
    alphas = np.clip(alphas, a_min=0.001, a_max=1.0)
    return np.sqrt(alphas)


def get_beta_schedule(beta_schedule: str, *, beta_start: float, beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    T = num_diffusion_timesteps
    if beta_schedule == 'quad':
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T,
                            dtype=np.float64) ** 2
    elif beta_schedule == 'linear':
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == 'const':
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == 'jsd':
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == 'sigmoid':
        x = np.linspace(-6, 6, T)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (T,)
    return betas


def pos_schedule_coefficients(config) -> dict:
    """All coordinate-diffusion coefficient tables, as float32 numpy arrays.

    Parity with the constant setup in ref models/decompdiff.py:96-131, including
    the idiosyncratic posterior_logvar clipping (t=0 entry replaced by t=1's).
    """
    if config.beta_schedule == 'cosine':
        alphas = cosine_alpha_schedule(
            config.num_diffusion_timesteps, config.pos_beta_s) ** 2
        betas = 1.0 - alphas
    else:
        betas = get_beta_schedule(
            beta_schedule=config.beta_schedule,
            beta_start=config.beta_start,
            beta_end=config.beta_end,
            num_diffusion_timesteps=config.num_diffusion_timesteps,
        )
        alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    out = {
        'betas': betas,
        'alphas_cumprod': alphas_cumprod,
        'alphas_cumprod_prev': alphas_cumprod_prev,
        # f64-computed small complement: the strided skip posteriors
        # need (1 - ab) without float32 cancellation at ab ~ 1
        'one_minus_alphas_cumprod': 1.0 - alphas_cumprod,
        'sqrt_alphas_cumprod': np.sqrt(alphas_cumprod),
        'sqrt_one_minus_alphas_cumprod': np.sqrt(1.0 - alphas_cumprod),
        'sqrt_recip_alphas_cumprod': np.sqrt(1.0 / alphas_cumprod),
        'sqrt_recipm1_alphas_cumprod': np.sqrt(1.0 / alphas_cumprod - 1.0),
        'posterior_mean_c0_coef':
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        'posterior_mean_ct_coef':
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
        'posterior_var': posterior_variance,
        # t=0 variance is 0; the reference replaces its log with the t=1 value
        'posterior_logvar': np.log(
            np.append(posterior_variance[1], posterior_variance[1:])),
        'pos_score_coef': betas / np.sqrt(alphas),
    }
    return {k: np.asarray(v, dtype=np.float32) for k, v in out.items()}
