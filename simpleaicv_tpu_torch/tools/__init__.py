"""Command-line entry points of the PyTorch port, run as modules:

    python -m simpleaicv_tpu_torch.tools.train_classification --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.test_classification --work-dir <dir>

They run on the card; ``SIMPLEAICV_PLATFORM=cpu`` runs them on the CPU.
"""
