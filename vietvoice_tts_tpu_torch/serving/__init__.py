"""Serving: continuous micro-batching dispatcher for the synthesis core."""

from .batcher import BatcherStats, ChunkJob, MicroBatcher

__all__ = ["BatcherStats", "ChunkJob", "MicroBatcher"]
