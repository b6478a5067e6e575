"""ImageNet-21K datasets (counterpart of
``simpleaicv_tpu/data/datasets/imagenet21k.py``): the single-label folder
reader, and the semantic-tree reader that turns a label into one label per
hierarchy level of the miil semantic tree (``imagenet21k_miil_tree.pth``,
read with ``torch.load``), with the per-level normalisation factors that
``SemanticSoftmaxLoss`` takes. Images are decoded by the port's libjpeg
binding (``ilsvrc2012.decode_file``) where the JAX reader calls
``cv2.imread``; a file that does not decode raises naming it.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from .ilsvrc2012 import decode_file

__all__ = ["ImageNet21KSingleLabelDataset",
           "ImageNet21KSemanticTreeLabelDataset",
           "ImageNet21KSemanticCollater"]


class ImageNet21KSingleLabelDataset:

    def __init__(self, root_dir: str, set_name: str = "train",
                 transform: Optional[Callable] = None):
        self.root_dir = root_dir
        self.set_name = set_name
        self.transform = transform
        self._items = None

    def _scan(self):
        if self._items is not None:
            return
        set_dir = os.path.join(self.root_dir, self.set_name)
        classes = sorted(os.listdir(set_dir))
        self.class_name_to_label = {c: i for i, c in enumerate(classes)}
        items = []
        for c in classes:
            cdir = os.path.join(set_dir, c)
            for fname in os.listdir(cdir):
                items.append((os.path.join(cdir, fname),
                              self.class_name_to_label[c]))
        self._items = sorted(items)

    def __len__(self):
        self._scan()
        return len(self._items)

    def __getitem__(self, idx):
        self._scan()
        path, label = self._items[idx]
        sample = {"image": decode_file(path), "label": int(label)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class ImageNet21KSemanticTreeLabelDataset(ImageNet21KSingleLabelDataset):
    """Per hierarchy level, the class indices at that level and the loss's
    normalisation factors, from the semantic tree; labels become
    fixed-shape [n_hierarchies] semantic labels (-1 where a class has no
    ancestor at a level) at collate time."""

    def __init__(self, root_dir: str, set_name: str = "train",
                 transform: Optional[Callable] = None,
                 tree_file: str = "imagenet21k_miil_tree.pth"):
        super().__init__(root_dir, set_name, transform)
        self._tree_loaded = False
        self.tree_path = os.path.join(root_dir, tree_file)

    def _load_tree(self):
        if self._tree_loaded:
            return
        import torch
        tree = torch.load(self.tree_path, map_location="cpu",
                          weights_only=False)
        self.class_tree_list = tree["class_tree_list"]
        depth = np.array([len(t) - 1 for t in self.class_tree_list])
        max_depth = int(depth.max()) + 1
        hist = np.bincount(depth, minlength=max_depth).astype(np.float64)
        # per level, the classes whose chain reaches that level
        self.hierarchy_indices_list = [
            np.where(depth >= level)[0] for level in range(max_depth)
            if hist[level] > 1]
        cum = np.cumsum(hist[::-1])[::-1]
        norm = np.array([cum[i] for i in
                         range(len(self.hierarchy_indices_list))])
        norm = cum[0] / np.clip(norm, 1.0, None)
        self.normalization_factor_list = np.clip(norm, None, 20.0)
        self._tree_loaded = True

    def convert_outputs_to_semantic_outputs(self, outputs):
        self._load_tree()
        return [outputs[:, idx] for idx in self.hierarchy_indices_list]

    def convert_single_labels_to_semantic_labels(self, labels):
        self._load_tree()
        labels = np.asarray(labels)
        n_h = len(self.hierarchy_indices_list)
        out = np.full((labels.shape[0], n_h), -1, np.int64)
        if not hasattr(self, "_pos_lookup"):
            self._pos_lookup = [{int(c): i for i, c in enumerate(idxs)}
                                for idxs in self.hierarchy_indices_list]
        for i, label in enumerate(labels):
            chain = self.class_tree_list[int(label)]
            levels = len(chain)
            for j, cls in enumerate(chain):
                level = levels - j - 1
                if level >= n_h:
                    continue
                out[i, level] = self._pos_lookup[level].get(int(cls), -1)
        return out


class ImageNet21KSemanticCollater:
    """Stacks the images and adds the semantic labels of the batch's
    labels."""

    def __init__(self, dataset: ImageNet21KSemanticTreeLabelDataset):
        self.dataset = dataset

    def __call__(self, samples):
        images = np.stack([s["image"] for s in samples]).astype(np.float32)
        labels = np.asarray([s["label"] for s in samples], np.int64)
        semantic = self.dataset.convert_single_labels_to_semantic_labels(
            labels)
        return {"image": images, "label": labels.astype(np.int32),
                "semantic_label": semantic.astype(np.int32)}
