"""Host-side data pipelines of the PyTorch port (numpy only)."""
