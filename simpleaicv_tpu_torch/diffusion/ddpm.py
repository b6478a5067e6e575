"""DDPM trainer and sampler (counterpart of
``simpleaicv_tpu/diffusion/ddpm.py``).

The trainer draws t ~ U[0, T) and the noise, q-samples and predicts the
noise; the sampler runs the reverse process (mean types xprev, xstart and
epsilon; variances fixedlarge and fixedsmall; optional clipping of x0).

Against the JAX package: JAX draws t and the noise with ``jax.random``
inside the jitted step and runs the reverse process as one ``lax.scan``;
here the draws come from an explicit ``torch.Generator`` on the images'
device (the engine's step generator, seeded from (seed, step)), and the
sampler is a Python loop over the time steps, one model call each. Both
take their draws as arguments too (``t``, ``noise``), which is how the
tests feed both sides the same numbers. The schedule's constants are f64
numpy cast to f32, as JAX casts them.
"""

from __future__ import annotations

import numpy as np
import torch

from .schedules import DiffusionConstants

__all__ = ["DDPMTrainer", "DDPMSampler", "extract"]


# (id of a numpy array, device) -> (the array, its f32 copy there): one copy
# a schedule array and device, not one from pageable memory at every step,
# which would wait for the card's stream
_ON_DEVICE = {}


def _on_device(v, device):
    key = (id(v), str(device))
    hit = _ON_DEVICE.get(key)
    if hit is None or hit[0] is not v:
        with torch.inference_mode(False):
            hit = (v, torch.as_tensor(np.asarray(v, np.float32),
                                      device=device))
        _ON_DEVICE[key] = hit
    return hit[1]


def extract(v, t, ndim: int):
    """The f32 schedule constants ``v`` (numpy) at time steps ``t`` [B], as
    [B, 1, ...] with ``ndim`` dims, on t's device."""
    out = _on_device(v, t.device)[t]
    return out.reshape((t.shape[0],) + (1,) * (ndim - 1))


class DDPMTrainer:

    def __init__(self, beta_schedule_mode="linear", linear_beta_1=1e-4,
                 linear_beta_t=0.02, cosine_s=0.008, t=1000):
        self.t = t
        self.c = DiffusionConstants(beta_schedule_mode, t, linear_beta_1,
                                    linear_beta_t, cosine_s)

    def add_noise(self, x_start, t, noise):
        nd = x_start.dim()
        return (extract(self.c.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(self.c.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def draw(self, x_start, generator=None):
        """(t [B] in [0, T), noise like ``x_start``) from ``generator``."""
        t = torch.randint(0, self.t, (x_start.shape[0],),
                          device=x_start.device, generator=generator)
        noise = torch.randn(x_start.shape, device=x_start.device,
                            dtype=x_start.dtype, generator=generator)
        return t, noise

    def __call__(self, model_fn, x_start, generator=None, class_label=None,
                 t=None, noise=None):
        """(predicted noise, noise); ``model_fn(x_noisy, t, class_label)``.
        ``t`` and ``noise`` are drawn from ``generator`` unless given."""
        if t is None or noise is None:
            t_draw, noise_draw = self.draw(x_start, generator)
            t = t_draw if t is None else t
            noise = noise_draw if noise is None else noise
        x_noisy = self.add_noise(x_start, t, noise)
        return model_fn(x_noisy, t, class_label), noise


def _noise_source(noise, generator):
    """A callable ``shape, like -> tensor``: the next tensor of ``noise``
    (a sequence) when given, else a draw from ``generator``."""
    if noise is not None:
        it = iter(noise)
        return lambda like: next(it).to(device=like.device, dtype=like.dtype)
    return lambda like: torch.randn(like.shape, device=like.device,
                                    dtype=like.dtype, generator=generator)


class DDPMSampler:

    def __init__(self, beta_schedule_mode="linear", linear_beta_1=1e-4,
                 linear_beta_t=0.02, cosine_s=0.008, t=1000,
                 mean_type="epsilon", var_type="fixedsmall",
                 clip_denoised=True):
        assert mean_type in ("xprev", "xstart", "epsilon")
        assert var_type in ("fixedlarge", "fixedsmall")
        self.t = t
        self.mean_type = mean_type
        self.var_type = var_type
        self.clip_denoised = clip_denoised
        self.c = c = DiffusionConstants(beta_schedule_mode, t, linear_beta_1,
                                        linear_beta_t, cosine_s)
        self.log_var = (np.log(np.concatenate([c.posterior_variance[1:2],
                                               c.betas[1:]]))
                        if var_type == "fixedlarge"
                        else c.posterior_log_variance_clipped)

    def _p_mean_log_variance(self, pred, x_t, t):
        c = self.c
        nd = x_t.dim()
        if self.mean_type == "xprev":
            model_mean = pred
        else:
            if self.mean_type == "xstart":
                x_0 = pred
            else:
                x_0 = (extract(c.sqrt_recip_alphas_cumprod, t, nd) * x_t
                       - extract(c.sqrt_recipm1_alphas_cumprod, t, nd) * pred)
            if self.clip_denoised:
                x_0 = x_0.clamp(-1.0, 1.0)
            model_mean = (extract(c.posterior_mean_coef1, t, nd) * x_0
                          + extract(c.posterior_mean_coef2, t, nd) * x_t)
        return model_mean, extract(self.log_var, t, nd)

    def sample_per_time_step(self, model_fn, x_t, t, noise,
                             class_label=None):
        """One reverse step from x_t at time steps ``t`` [B] with
        ``noise`` (unused where t is 0)."""
        pred = model_fn(x_t, t, class_label)
        mean, log_var = self._p_mean_log_variance(pred, x_t, t)
        nonzero = (t != 0).to(x_t.dtype).reshape(
            (-1,) + (1,) * (x_t.dim() - 1))
        return mean + torch.exp(0.5 * log_var) * noise * nonzero

    @torch.no_grad()
    def __call__(self, model_fn, shape, generator=None, class_label=None,
                 input_images=None, noise=None, device=None):
        """The whole reverse process from x_T = ``input_images`` (else a
        draw) over t = T-1, ..., 0; ``noise`` is the sequence of the steps'
        noise (else drawn from ``generator``). Returns the images."""
        if input_images is None:
            x = torch.randn(shape, device=device, generator=generator)
        else:
            x = input_images.float()
        draw = _noise_source(noise, generator)
        for step in range(self.t - 1, -1, -1):
            t = torch.full((shape[0],), step, dtype=torch.int64,
                           device=x.device)
            x = self.sample_per_time_step(model_fn, x, t, draw(x),
                                          class_label)
        return x
