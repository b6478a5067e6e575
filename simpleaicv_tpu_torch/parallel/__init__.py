"""Mixture-of-Experts layers of the PyTorch port (one device; sharding the
expert stacks over several cards is not ported)."""
