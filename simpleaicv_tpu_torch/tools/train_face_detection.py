"""Face-detection training (counterpart of
``tools/train_face_detection.py``), with the detection adapter and a
single-class COCO evaluation every epoch:

    python -m simpleaicv_tpu_torch.tools.train_face_detection --work-dir <dir>

(see ``tools.train_detection``).
"""

from __future__ import annotations

from .train_detection import train


def main(argv=None):
    return train("face-detection training", argv, num_classes=1)


if __name__ == "__main__":
    main()
