"""DDIM sampler (counterpart of ``simpleaicv_tpu/diffusion/ddim.py``):
uniform or quadratic subsets of the DDPM time steps (shifted by 1),
eta-scaled sigmas and optional clipping of x0. The reverse process is a
Python loop over the DDIM steps (JAX's is a ``lax.scan``), drawing its noise
from an explicit ``torch.Generator`` unless a sequence is given."""

from __future__ import annotations

import numpy as np
import torch

from .ddpm import _noise_source
from .schedules import DiffusionConstants

__all__ = ["DDIMSampler"]


class DDIMSampler:

    def __init__(self, beta_schedule_mode="linear", linear_beta_1=1e-4,
                 linear_beta_t=0.02, cosine_s=0.008, ddpm_t=1000, ddim_t=50,
                 ddim_eta=0.0, ddim_discr_method="uniform",
                 clip_denoised=True):
        assert ddim_discr_method in ("uniform", "quad")
        self.ddpm_t = ddpm_t
        self.ddim_t = ddim_t
        self.ddim_eta = ddim_eta
        self.clip_denoised = clip_denoised
        self.c = DiffusionConstants(beta_schedule_mode, ddpm_t, linear_beta_1,
                                    linear_beta_t, cosine_s)
        if ddim_discr_method == "uniform":
            step = ddpm_t // ddim_t
            timesteps = np.asarray(list(range(0, ddpm_t, step)))
        else:
            timesteps = (np.linspace(0, np.sqrt(ddpm_t * 0.8),
                                     ddim_t) ** 2).astype(int)
        self.ddim_timesteps = timesteps + 1
        ac = self.c.alphas_cumprod
        self.ddim_alphas = ac[np.clip(self.ddim_timesteps, 0, ddpm_t - 1)]
        self.ddim_alphas_prev = np.concatenate(
            [[ac[0]], self.ddim_alphas[:-1]])
        self.ddim_sigmas = ddim_eta * np.sqrt(
            (1 - self.ddim_alphas_prev) / (1 - self.ddim_alphas)
            * (1 - self.ddim_alphas / self.ddim_alphas_prev))
        self.ddim_sqrt_one_minus_alphas = np.sqrt(1.0 - self.ddim_alphas)

    @torch.no_grad()
    def __call__(self, model_fn, shape, generator=None, class_label=None,
                 input_images=None, noise=None, device=None):
        """The DDIM reverse process from x_T = ``input_images`` (else a
        draw); ``noise`` is the sequence of the steps' noise (else drawn
        from ``generator``). Returns the images."""
        if input_images is None:
            x = torch.randn(shape, device=device, generator=generator)
        else:
            x = input_images.float()
        draw = _noise_source(noise, generator)

        def f32(a):
            return torch.as_tensor(np.asarray(a[::-1], np.float32),
                                   device=x.device)

        a_t, a_prev = f32(self.ddim_alphas), f32(self.ddim_alphas_prev)
        sigma, s1a = f32(self.ddim_sigmas), f32(
            self.ddim_sqrt_one_minus_alphas)
        for i, step in enumerate(self.ddim_timesteps[::-1].tolist()):
            t = torch.full((shape[0],), step, dtype=torch.int64,
                           device=x.device)
            eps = model_fn(x, t, class_label)
            x0 = (x - s1a[i] * eps) / torch.sqrt(a_t[i])
            if self.clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            dir_xt = torch.sqrt((1.0 - a_prev[i] - sigma[i] ** 2).clamp(
                min=0.0)) * eps
            x = torch.sqrt(a_prev[i]) * x0 + dir_xt + sigma[i] * draw(x)
        return x
