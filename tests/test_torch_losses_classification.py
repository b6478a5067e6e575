"""The port's five classification losses against the JAX package's on the
same seeded logits and labels: value (atol 1e-6, f32) and gradient with
respect to the logits (atol 1e-6), from f32 and from bf16 logits."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.losses import classification as jax_losses
from simpleaicv_tpu_torch.core.registry import LOSSES
from simpleaicv_tpu_torch.losses import classification as port_losses

B, C = 6, 11


def _case(name):
    """(constructor kwargs, logits, labels) of one loss, from a seed."""
    rng = np.random.RandomState(len(name))
    logits = (3 * rng.randn(B, C)).astype(np.float32)
    labels = rng.randint(0, C, (B,)).astype(np.int32)
    if name == "OneHotLabelCELoss":
        lam = rng.rand(B, 1).astype(np.float32)  # mixup-style soft labels
        labels = (lam * np.eye(C, dtype=np.float32)[labels] +
                  (1 - lam) * np.eye(C, dtype=np.float32)[labels[::-1]])
    if name == "SemanticSoftmaxLoss":
        logits = [logits, (2 * rng.randn(B, 5)).astype(np.float32)]
        labels = np.stack([labels, rng.randint(-1, 5, (B,))], 1).astype(
            np.int32)
        labels[0, 0] = -1
        return {"normalization_factor_list": [1.0, 0.5],
                "smoothing": 0.2}, logits, labels
    kwargs = {"FocalCELoss": {"gamma": 1.5},
              "LabelSmoothCELoss": {"smoothing": 0.15}}.get(name, {})
    return kwargs, logits, labels


LOSS_NAMES = ["CELoss", "FocalCELoss", "LabelSmoothCELoss",
              "OneHotLabelCELoss", "SemanticSoftmaxLoss"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_loss_value_and_gradient_match_jax(name, dtype):
    kwargs, logits, labels = _case(name)
    many = isinstance(logits, list)
    jdt = getattr(jnp, dtype)
    jax_loss = getattr(jax_losses, name)(**kwargs)
    j_in = [jnp.asarray(a).astype(jdt) for a in (logits if many else [logits])]
    fn = (lambda *xs: jax_loss(list(xs), jnp.asarray(labels))) if many else \
        (lambda x: jax_loss(x, jnp.asarray(labels)))
    want, want_grads = jax.value_and_grad(fn, argnums=tuple(range(len(j_in))))(
        *j_in)

    port_loss = LOSSES.create(name, **kwargs)
    assert type(port_loss) is getattr(port_losses, name)
    t_in = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
            for a in (logits if many else [logits])]
    got = port_loss(t_in if many else t_in[0], torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    # a bf16 gradient is the f32 one rounded to 8 bits of mantissa
    atol = 1e-6 if dtype == "float32" else 4e-3
    for t, w in zip(t_in, want_grads):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=atol)
