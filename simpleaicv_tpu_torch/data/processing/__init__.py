"""Dataset preparation of the PyTorch port (counterpart of
``simpleaicv_tpu/data/processing``), without OpenCV: converts raw
public-dataset downloads into the folder and JSON layouts that the
readers of ``data/datasets`` consume. It runs on the host and opens no
device.

CLI entry point: ``python -m simpleaicv_tpu_torch.tools.prepare_dataset``.
"""

from .common import (IGNORE_CHAR, normalize_text, half_angle,  # noqa: F401
                     resize_max_side, write_standard_set)
from .text_detection import (process_rctw, process_art,  # noqa: F401
                             process_lsvt, process_mlt, process_rects,
                             standardize_detection_set)
from .text_lines import (extract_text_lines, build_char_table)  # noqa: F401
from .parsing import (process_face_synthetics,  # noqa: F401
                      process_celebamask_hq, process_lip, process_cihp)
from .sam_labels import convert_mask_folder_to_sa1b  # noqa: F401
