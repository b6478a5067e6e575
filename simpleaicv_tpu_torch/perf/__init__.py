"""Roofline probes of the PyTorch port (counterparts of ``perf/``), each a
hand kernel beside its plain version and the library calls it is measured
against, at the ResNet-50 training step's shapes."""
