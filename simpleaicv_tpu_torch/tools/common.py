"""Shared plumbing of the port's CLIs (counterpart of ``tools/common.py``):
the ``--work-dir`` argument, the experiment's configs read through the
port's ``load_config``, and restoring trained weights from a port
checkpoint."""

from __future__ import annotations

import argparse

from ..core.checkpoint import load_checkpoint_tensors, load_state_dict_partial
from ..core.config import load_config


def parse_work_dir(description="", argv=None):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--work-dir", type=str, required=True)
    return parser.parse_args(argv)


def load_train_config(args):
    return load_config(args.work_dir, "train_config")


def load_test_config(args):
    return load_config(args.work_dir, "test_config")


def restore_trained_params(ckpt_path, model) -> int:
    """Loads a port checkpoint (``best``, a named final link, a latest
    checkpoint or a bare state dict) into ``model``, keeping only the
    tensors whose names and shapes match the model's, as the reference's
    name-filtered ``load_state_dict`` does; returns how many it loaded."""
    tensors, n = load_state_dict_partial(load_checkpoint_tensors(ckpt_path),
                                         model.state_dict())
    model.load_state_dict(tensors)
    return n
