"""Command-line entry points of the PyTorch port, run as modules:

    python -m simpleaicv_tpu_torch.tools.train_classification --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.test_classification --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.train_interactive_segmentation --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.test_interactive_segmentation --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.train_detr_detection --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.test_detection --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.run_synthetic_smokes [filter ...]

They run on the card; ``SIMPLEAICV_PLATFORM=cpu`` runs them on the CPU
(the smoke runner always runs on the CPU).
"""
