"""Data pipelines of the PyTorch port: host-side datasets, transforms and
collaters (numpy), and ``device_augment``, torch ops on the card's batch."""
