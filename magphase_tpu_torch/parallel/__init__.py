"""Batched corpus pipelines (port of magphase_tpu/parallel)."""
from .analysis_batch import (analysis_compressed_batch,
                             analysis_compressed_batch_async,
                             analysis_lossless_batch)
from .batch import synthesis_batches_pipelined, synthesis_from_compressed_batch
from .copy_synthesis import copy_synthesis_batch

__all__ = ["analysis_compressed_batch", "analysis_compressed_batch_async",
           "analysis_lossless_batch", "copy_synthesis_batch",
           "synthesis_batches_pipelined", "synthesis_from_compressed_batch"]
