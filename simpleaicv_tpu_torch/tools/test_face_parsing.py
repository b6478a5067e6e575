"""Face-parsing evaluation (counterpart of
``tools/test_face_parsing.py``): the mIoU-family metrics of the parsing
head,

    python -m simpleaicv_tpu_torch.tools.test_face_parsing --work-dir <dir>

(see ``tools.test_semantic_segmentation``).
"""

from __future__ import annotations

from .test_semantic_segmentation import evaluate


def main(argv=None):
    return evaluate("face-parsing evaluation", argv)


if __name__ == "__main__":
    main()
