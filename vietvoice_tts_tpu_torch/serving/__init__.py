"""Serving: continuous micro-batching dispatcher for the synthesis core,
and the lockstep loop that serves a mesh of ranks."""

from .batcher import BatcherStats, ChunkJob, MicroBatcher
from .multihost import MultiHostServingLoop, ServingLoopStopped

__all__ = [
    "BatcherStats",
    "ChunkJob",
    "MicroBatcher",
    "MultiHostServingLoop",
    "ServingLoopStopped",
]
