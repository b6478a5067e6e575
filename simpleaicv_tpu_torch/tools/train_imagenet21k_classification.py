"""ImageNet-21K semantic-softmax training (counterpart of
``tools/train_imagenet21k_classification.py``):

    python -m simpleaicv_tpu_torch.tools.train_imagenet21k_classification \
        --work-dir <dir>

The config's ``train_dataset`` is an ``ImageNet21KSemanticTreeLabelDataset``.
The model's logits are cut into one group a hierarchy level (the tree's
``hierarchy_indices_list``) and trained by ``SemanticSoftmaxLoss`` with the
tree's normalisation factors and the config's ``smoothing`` (0.1). The
evaluation counts, over every level, the top-1 hits among the valid labels
(not -1), pooled over the levels as the JAX CLI pools them. Checkpoints,
logs and resume are the Trainer's. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.

The semantic labels are the batch's ``label`` looked up in a per-class
table of the tree on the batch's device. Every collater gives ``label``:
``ImageNet21KSemanticCollater``, whose ``semantic_label`` is the same
table's rows, and ``ClassificationCollater``, which the repository's
ImageNet-21K configs use.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..losses.classification import SemanticSoftmaxLoss
from ..tasks import classification
from .common import load_train_config, parse_work_dir


class SemanticTree:
    """The dataset's hierarchy levels as index tensors, and every class's
    semantic labels as a [num_classes, levels] table, moved to a batch's
    device on first use."""

    def __init__(self, dataset):
        dataset._load_tree()
        self.indices = [torch.as_tensor(np.asarray(i), dtype=torch.long)
                        for i in dataset.hierarchy_indices_list]
        self.table = torch.as_tensor(
            dataset.convert_single_labels_to_semantic_labels(
                np.arange(len(dataset.class_tree_list))), dtype=torch.long)
        self.normalization_factor_list = [
            float(f) for f in dataset.normalization_factor_list]

    def on(self, device):
        if self.table.device != device:
            self.indices = [i.to(device) for i in self.indices]
            self.table = self.table.to(device)
        return self

    def outputs(self, logits):
        return [logits[:, idx] for idx in self.on(logits.device).indices]

    def labels(self, batch):
        label = batch["label"].long()
        return self.on(label.device).table[label]


def make_adapters(tree: SemanticTree, smoothing: float = 0.1):
    """(make_loss_fn, make_eval_fn) of the engine for ``tree``."""
    criterion = SemanticSoftmaxLoss(tree.normalization_factor_list,
                                    smoothing=smoothing)

    def make_loss_fn(_criterion=None):

        def loss_fn(model, batch, generator, train):
            out = model(batch["image"], generator=generator if train else None)
            return criterion(tree.outputs(out), tree.labels(batch)), {}

        return loss_fn

    def make_eval_fn():

        def eval_fn(model, batch, generator, train):
            del generator, train
            out = model(batch["image"])
            labels = tree.labels(batch)
            correct = out.new_zeros((), dtype=torch.float32)
            total = out.new_zeros((), dtype=torch.float32)
            for level, logits in enumerate(tree.outputs(out)):
                lab = labels[:, level]
                valid = (lab >= 0).float()
                hit = (torch.argmax(logits, dim=-1) == lab).float()
                correct = correct + (hit * valid).sum()
                total = total + valid.sum()
            return {"acc1_correct": correct, "acc5_correct": correct,
                    "n": total}

        return eval_fn

    return make_loss_fn, make_eval_fn


def main(argv=None):
    args = parse_work_dir("ImageNet-21K semantic-softmax training", argv)
    config = load_train_config(args)
    make_loss_fn, make_eval_fn = make_adapters(
        SemanticTree(config.train_dataset),
        getattr(config, "smoothing", 0.1))
    trainer = Trainer(config, args.work_dir, make_loss_fn=make_loss_fn,
                      make_eval_fn=make_eval_fn,
                      evaluate=classification.evaluate,
                      device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
