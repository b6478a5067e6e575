"""The parallel layer of the PyTorch port over ``torch.distributed``: the
mesh (``mesh``), the multi-process start (``multihost``), GPipe
(``pipeline``, ``pipeline_vit``), ring attention (``ring_attention``) and
the Mixture-of-Experts layers with their expert sharding (``moe``)."""

from .mesh import (MeshConfig, make_mesh, batch_sharding, replicated,
                   infer_param_sharding, shard_batch)  # noqa: F401
