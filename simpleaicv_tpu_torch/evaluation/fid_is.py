"""FID and Inception Score (counterpart of
``simpleaicv_tpu/evaluation/fid_is.py``): the Frechet distance and the
Inception Score in numpy and scipy, and the InceptionV3 feature function.

FID numbers mean something only with the pretrained FID-Inception weights;
the feature function runs on seeded weights without them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import linalg

from ..core.checkpoint import load_state_dict_partial
from ..models.common import init_params, resolve_device
from ..models.inception_v3 import InceptionV3

__all__ = ["calculate_frechet_distance", "compute_fid",
           "compute_inception_score", "make_inception_feature_fn",
           "load_torch_state_dict", "resize_to_inception"]

FEATURE_BATCH = 64


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """The JAX package's formula. scipy's ``sqrtm`` is called without
    ``disp``, which newer scipy no longer takes; both return the root."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_fid(real_features: np.ndarray, fake_features: np.ndarray) -> float:
    mu1, sigma1 = real_features.mean(0), np.cov(real_features, rowvar=False)
    mu2, sigma2 = fake_features.mean(0), np.cov(fake_features, rowvar=False)
    return calculate_frechet_distance(mu1, sigma1, mu2, sigma2)


def compute_inception_score(probs: np.ndarray, splits: int = 10):
    """probs [N, classes] softmax outputs -> (mean IS, its std)."""
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        py = part.mean(0, keepdims=True)
        kl = part * (np.log(part + 1e-10) - np.log(py + 1e-10))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def load_torch_state_dict(path: str) -> dict:
    """The tensors of a torch checkpoint file, unwrapped from a
    'state_dict', 'model' or 'ema_model' entry."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "ema_model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def resize_to_inception(images):
    """[N, H, W, 3] -> [N, 299, 299, 3]: bilinear at half-pixel centres
    without antialiasing (``jax.image.resize(..., antialias=False)``)."""
    out = F.interpolate(images.permute(0, 3, 1, 2), size=(299, 299),
                        mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)


def make_inception_feature_fn(weights_path: Optional[str] = None,
                              fid_variant: bool = True,
                              resize_input: bool = True,
                              normalize_input: bool = True, device="cuda"):
    """feature_fn(images [N, H, W, 3] f32 in [0, 1], numpy) -> (pool3
    features [N, 2048], softmax probabilities [N, classes]) as numpy: the
    299 resize, 2x - 1, the blocks, the pool and the classifier's softmax,
    on ``device`` in batches of ``FEATURE_BATCH``. ``weights_path`` (a
    torchvision or ``pt_inception`` state dict) must fill every tensor;
    without it the weights are seeded."""
    device = resolve_device(device)
    model = init_params(InceptionV3(fid=fid_variant),
                        torch.Generator().manual_seed(0))
    if weights_path:
        expected = model.state_dict()
        tensors, n = load_state_dict_partial(
            load_torch_state_dict(weights_path), expected)
        if n < len(expected):
            raise ValueError(f"inception weights loaded {n}/{len(expected)} "
                             f"tensors from {weights_path}")
        model.load_state_dict(tensors)
    model.to(device).eval()

    @torch.no_grad()
    def feature_fn(images):
        pools, probs = [], []
        for i in range(0, len(images), FEATURE_BATCH):
            x = torch.as_tensor(np.asarray(images[i:i + FEATURE_BATCH],
                                           np.float32), device=device)
            if resize_input and tuple(x.shape[1:3]) != (299, 299):
                x = resize_to_inception(x)
            if normalize_input:
                x = 2.0 * x - 1.0
            pool, logits = model(x)
            pools.append(pool.cpu().numpy())
            probs.append(torch.softmax(logits, -1).cpu().numpy())
        return np.concatenate(pools), np.concatenate(probs)

    return feature_fn
