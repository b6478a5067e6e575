"""Beta schedules, the port's own copy of
``simpleaicv_tpu/diffusion/schedules.py`` (parity: reference
simpleAICV/diffusion_model/diffusion_methods/module.py:17-80 — linear/cosine/
quad/sqrt_linear/const/jsd/sigmoid, computed in float64)."""

from __future__ import annotations

import math

import numpy as np


def compute_beta_schedule(mode: str, t: int, linear_beta_1=1e-4,
                          linear_beta_t=0.02, cosine_s=0.008) -> np.ndarray:
    if mode == "linear":
        betas = np.linspace(linear_beta_1, linear_beta_t, t, dtype=np.float64)
    elif mode == "cosine":
        x = np.arange(t + 1, dtype=np.float64)
        ac = np.cos(((x / t) + cosine_s) / (1 + cosine_s) * math.pi * 0.5)**2
        ac = ac / ac[0]
        betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)
    elif mode == "quad":
        betas = np.linspace(linear_beta_1**0.5, linear_beta_t**0.5, t,
                            dtype=np.float64)**2
    elif mode == "sqrt_linear":
        betas = np.linspace(linear_beta_1, linear_beta_t, t,
                            dtype=np.float64)**0.5
    elif mode == "const":
        betas = linear_beta_t * np.ones(t, np.float64)
    elif mode == "jsd":
        betas = 1.0 / np.linspace(t, 1, t, dtype=np.float64)
    elif mode == "sigmoid":
        x = np.linspace(-6, 6, t, dtype=np.float64)
        betas = 1 / (1 + np.exp(-x)) * (linear_beta_t - linear_beta_1) \
            + linear_beta_1
    else:
        raise ValueError(mode)
    return betas


class DiffusionConstants:
    """Precomputed schedule constants (reference ddpm.py:128-176)."""

    def __init__(self, mode: str, t: int, linear_beta_1=1e-4,
                 linear_beta_t=0.02, cosine_s=0.008):
        self.t = t
        betas = compute_beta_schedule(mode, t, linear_beta_1, linear_beta_t,
                                      cosine_s)
        self.betas = betas
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        self.alphas = alphas
        self.alphas_cumprod = ac
        self.alphas_cumprod_prev = np.concatenate([[1.0], ac[:-1]])
        self.sqrt_alphas_cumprod = np.sqrt(ac)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - ac)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / ac)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / ac - 1.0)
        self.posterior_variance = betas * (1.0 - self.alphas_cumprod_prev) / \
            (1.0 - ac)
        self.posterior_log_variance_clipped = np.log(
            np.clip(self.posterior_variance, 1e-8, None))
        self.posterior_mean_coef1 = betas * np.sqrt(
            self.alphas_cumprod_prev) / (1.0 - ac)
        self.posterior_mean_coef2 = (1.0 - self.alphas_cumprod_prev) * \
            np.sqrt(alphas) / (1.0 - ac)
