"""Pipeline-parallel execution of the port's ViT family (counterpart of
``simpleaicv_tpu/parallel/pipeline_vit.py``).

The encoder blocks of a ``models.backbones.vit.ViT`` are split into
``pipe``-many stages of ``block_nums / S`` blocks each; the patch
embedding and the head run on every rank of the pipe (a few percent of the
work), and the blocks run as ``parallel.pipeline``'s fill-and-drain
microbatch pipeline. Each rank keeps only its own stage's blocks
(``vit_stage_params``). Eval mode, as in the JAX package (dropout and
drop-path off), and ``block_nums % S == 0``. The blocks keep their
``use_flash_attention``: with it on, every block's attention is the K1
kernel on the card.

The embed and head follow ``ViT.forward`` over the model's own modules;
``tests/test_torch_parallel_pipeline.py`` holds the result to the plain
forward.
"""

from __future__ import annotations

import torch
from torch import nn

from .pipeline import pipeline_forward

__all__ = ["vit_stage_params", "make_vit_pipeline_apply"]


def vit_stage_params(model, n_stages: int, mesh, axis: str = "pipe"):
    """This rank's stage: ``model.blocks[s * L / S:(s + 1) * L / S]`` for
    stage ``s`` (its rank along ``axis``), as an ``nn.ModuleList``."""
    n_blocks = len(model.blocks)
    assert n_blocks % n_stages == 0, (n_blocks, n_stages)
    assert mesh[axis].size() == n_stages, (mesh[axis].size(), n_stages)
    lps = n_blocks // n_stages
    s = mesh[axis].get_local_rank()
    return nn.ModuleList(model.blocks[s * lps:(s + 1) * lps])


def _vit_embed(model, x):
    """Patch embedding + cls token + position encoding (``ViT.forward``,
    eval)."""
    b = x.shape[0]
    tok = model.patch_embedding(x)
    tok = tok.reshape(b, -1, tok.shape[-1])
    cls = model.cls_token.expand(b, -1, -1).to(tok.dtype)
    return torch.cat([cls, tok], dim=1) + model.position_encoding.to(
        tok.dtype)


def _vit_head(model, x):
    """Final norm + cls token or global pool + fc (``ViT.forward``)."""
    if model.global_pool:
        x = model.norm(x[:, 1:].float().mean(dim=1))
    else:
        x = model.norm(x[:, 0])
    return model.fc(x)


def make_vit_pipeline_apply(model, mesh, *, n_micro: int, axis: str = "pipe",
                            data_axis: str | None = None,
                            remat: bool = False):
    """``apply(stage, x) -> logits``: ``x`` [B, S, S, 3] through the
    model's embedding, then its blocks as a fill-and-drain pipeline over
    ``mesh``'s ``axis`` (``stage`` is this rank's ``vit_stage_params``),
    then its head, in eval mode. With ``data_axis`` each slice of that
    dim runs its own pipeline over its own rows: ``x`` is then this rank's
    slice of the batch, and the logits are its rows."""
    del data_axis  # each data slice passes its own rows; nothing to do
    group = mesh[axis].get_group()

    def apply(stage, x):
        model.eval()
        stage.eval()

        def stage_fn(h):
            for block in stage:
                h = block(h)
            return h

        tok = _vit_embed(model, x)
        b = tok.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        xm = tok.reshape((n_micro, b // n_micro) + tok.shape[1:])
        out = pipeline_forward(stage_fn, xm, group=group, remat=remat)
        return _vit_head(model, out.reshape((b,) + tok.shape[1:]))

    return apply
