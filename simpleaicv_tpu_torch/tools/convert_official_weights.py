"""Converts an official PyTorch checkpoint into a port checkpoint
(counterpart of ``tools/convert_official_weights.py``):

    python -m simpleaicv_tpu_torch.tools.convert_official_weights \\
        --family torchvision_resnet --network resnet50 \\
        --checkpoint resnet50-official.pth --out converted_resnet50 \\
        [--num-classes 1000] [--image-size 224]

Families: ``core/converters.py::FAMILIES`` (torchvision_resnet, mae_vit,
dinov2_vit, convformer, inception_v3, sapiens_vit and the ref_* ones). It
builds the registered network seeded (seed 0) on the card, or on the CPU
under ``SIMPLEAICV_PLATFORM=cpu`` (without a card it raises), fills it
from the checkpoint through the family's converter, prints
``loaded n/total``, and writes the model's state dict, which any train or
test config restores through ``trained_model_path``. The tensors the
checkpoint does not hold keep the seeded initialisation.
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import models  # noqa: F401  (registers the networks)
from ..core.checkpoint import _atomic_save
from ..core.converters import apply_converted, convert_torch_file
from ..core.platform import device_from_env
from ..core.registry import BACKBONES, MODELS
from ..models.common import init_params, resolve_device

__all__ = ["main"]


def build(network: str, family: str, num_classes: int, image_size: int,
          device):
    """The registered network, seeded (seed 0), on ``device``."""
    registry = BACKBONES if network in BACKBONES.names() else MODELS
    kwargs = {"num_classes": num_classes}
    if family in ("mae_vit", "dinov2_vit", "sapiens_vit"):
        kwargs["image_size"] = image_size
    return init_params(registry.create(network, **kwargs),
                       torch.Generator().manual_seed(0)).to(device)


def main(argv=None):
    p = argparse.ArgumentParser(description="official-weight conversion")
    p.add_argument("--family", required=True)
    p.add_argument("--network", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=224)
    args = p.parse_args(argv)

    device = resolve_device(device_from_env())
    model = build(args.network, args.family, args.num_classes,
                  args.image_size, device)
    model, n = apply_converted(model,
                               convert_torch_file(args.checkpoint,
                                                  args.family))
    state = model.state_dict()
    print(f"loaded {n}/{len(state)} tensors from {args.checkpoint}")
    out = os.path.abspath(args.out)
    _atomic_save({k: v.detach().cpu() for k, v in state.items()}, out)
    print(f"saved converted checkpoint to {out}")
    return n, len(state)


if __name__ == "__main__":
    main()
