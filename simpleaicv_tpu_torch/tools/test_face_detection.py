"""Face-detection evaluation (counterpart of ``tools/test_face_detection.py``):
the single-class COCO statistics of the face detector,

    python -m simpleaicv_tpu_torch.tools.test_face_detection --work-dir <dir>

(see ``tools.test_detection``).
"""

from __future__ import annotations

from .test_detection import evaluate


def main(argv=None):
    return evaluate("face-detection evaluation", argv, num_classes=1)


if __name__ == "__main__":
    main()
