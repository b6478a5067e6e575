"""Model export (counterpart of ``tools/convert_to_stablehlo.py``, which
lowers the JAX model to StableHLO): the port's model becomes a
``torch.export`` program, saved with ``torch.export.save``.

    python -m simpleaicv_tpu_torch.tools.convert_to_export --work-dir <dir> \\
        --output model.pt2 [--batch 1]

The work dir's ``test_config.py`` gives ``config.model`` and
``config.input_image_size``; ``trained_model_path``, where set, is restored
onto the seeded model first (``tools/common.py``). The program is the
model's evaluation forward on a [batch, size, size, 3] f32 image,
``model(x)`` after ``model.eval()``: the port's form of the JAX tool's
``model.apply(variables, x, False)``. It runs on the card unless
``SIMPLEAICV_PLATFORM=cpu`` asks for the CPU, and raises without a card.

The hand kernels are ``torch.library`` operators
(``torch.ops.simpleaicv.*``), so they stay nodes of the program. Loading a
saved program therefore needs ``import simpleaicv_tpu_torch.ops`` first,
which registers them (``load_program`` does it):

    import simpleaicv_tpu_torch.ops  # registers torch.ops.simpleaicv.*
    program = torch.export.load("model.pt2")
    out = program.module()(x)
"""

from __future__ import annotations

import argparse

import torch

from ..core.config import load_config
from ..core.logging_utils import get_logger
from ..core.platform import device_from_env
from ..models.common import init_params, resolve_device
from .common import restore_trained_params

__all__ = ["export_model", "load_program", "simpleaicv_nodes", "main"]


def export_model(model, image_size: int, batch: int = 1, device="cuda"):
    """The ``torch.export`` program of ``model``'s evaluation forward on a
    [batch, image_size, image_size, 3] f32 image on ``device``. Traced
    without Python's bytecode (``strict=False``), which follows the
    models' shape arithmetic as written."""
    device = resolve_device(device)
    model = model.to(device).eval()
    x = torch.zeros((batch, image_size, image_size, 3), device=device)
    with torch.no_grad():
        return torch.export.export(model, (x,), strict=False)


def load_program(path: str):
    """A program saved by ``torch.export.save``, with the port's operators
    registered first."""
    from .. import ops  # noqa: F401  (registers torch.ops.simpleaicv.*)
    return torch.export.load(path)


def simpleaicv_nodes(program) -> list:
    """The names of the program's calls of the port's operators, in graph
    order (``simpleaicv.flash_attention_fwd.default``, ...)."""
    return [str(node.target) for node in program.graph.nodes
            if node.op == "call_function"
            and str(node.target).startswith("simpleaicv.")]


def main(argv=None):
    parser = argparse.ArgumentParser(description="model export")
    parser.add_argument("--work-dir", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--batch", type=int, default=1)
    args = parser.parse_args(argv)

    config = load_config(args.work_dir, "test_config")
    logger = get_logger("export")
    device = resolve_device(device_from_env())
    model = init_params(config.model, torch.Generator().manual_seed(
        getattr(config, "seed", 0)))
    ckpt_path = getattr(config, "trained_model_path", "")
    if ckpt_path:
        n = restore_trained_params(ckpt_path, model)
        logger.info(f"loaded {n} tensors from {ckpt_path}")
    program = export_model(model, config.input_image_size, args.batch, device)
    torch.export.save(program, args.output)
    nodes = simpleaicv_nodes(program)
    logger.info(f"exported {len(program.graph.nodes)} nodes ({len(nodes)} "
                f"calls of the port's hand kernels) to {args.output}")
    return program


if __name__ == "__main__":
    main()
