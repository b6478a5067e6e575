"""Face-parsing training (counterpart of
``tools/train_face_parsing.py``), with the semantic-segmentation adapter:

    python -m simpleaicv_tpu_torch.tools.train_face_parsing --work-dir <dir>

(see ``tools.train_semantic_segmentation``).
"""

from __future__ import annotations

from .train_semantic_segmentation import train


def main(argv=None):
    return train("face-parsing training", argv)


if __name__ == "__main__":
    main()
