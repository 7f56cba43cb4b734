"""Batched corpus pipelines and data parallelism (port of
magphase_tpu/parallel)."""
from .analysis_batch import (analysis_compressed_batch,
                             analysis_compressed_batch_async,
                             analysis_lossless_batch)
from .batch import synthesis_batches_pipelined, synthesis_from_compressed_batch
from .copy_synthesis import copy_synthesis_batch
from .mesh import (DataMesh, batch_sharding, data_mesh,
                   maybe_initialize_distributed, pad_batch_to_devices,
                   shard_batch)

__all__ = ["DataMesh", "data_mesh", "shard_batch", "batch_sharding",
           "pad_batch_to_devices", "maybe_initialize_distributed",
           "analysis_compressed_batch", "analysis_compressed_batch_async",
           "analysis_lossless_batch", "copy_synthesis_batch",
           "synthesis_batches_pipelined", "synthesis_from_compressed_batch"]
