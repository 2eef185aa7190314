"""Captured CUDA graphs of the chunk programs and of the train step: the
port of the JAX core's compiled-program cache and of the trainer's
``jax.jit`` (``training/train.py:TrainStep``).

The JAX ``EngineCore`` compiles each chunk program once per shape
(``vietvoice_tts_tpu/runtime/engine_core.py:251-314``: ``_jit_cache``, keyed
``(batch, n_frames, cond_cached)``; ``latent_fn`` alike at ``:530-556``) and
dispatches one compiled call per chunk batch. PyTorch's counterpart of a
program compiled per shape is a CUDA graph captured per shape.
:class:`GraphCache` holds one per key, with its static input tensors and its
static output, and a batch is one replay of it:

- A capture follows PyTorch's recipe: one eager run of the program on a
  side stream, which makes what a program makes at its first call
  (kernel builds, device constants, library handles and workspaces), then
  the capture on the same stream. It captures with
  ``capture_error_mode="thread_local"``, so other threads go on while one
  thread captures: the micro-batcher's fetcher waiting on an event, or the
  REST app's warm-up thread beside a request. A capture that fails raises
  to the caller. Nothing falls back to eager.
- Between capture and instantiation every memset node of the graph is
  rewritten as a kernel node that writes the same bytes, and every memcpy
  node between linear memory as a kernel node that copies them, with the
  same edges (:func:`rewrite_graph`, ``csrc/graph_fill.cu``). cuBLAS puts
  ``cudaMemsetAsync`` calls into a capture at some GEMM shapes; a graph
  that held them (686–2,808 beside ~17,600 kernels) held the host in its
  launch for 25–82% of its device time on an H100; rewritten, every graph's
  launch returned in 0.2–0.5 ms (``chip_smoke.py`` phase 14 (c)). The
  GEMMs keep cuBLAS's
  algorithms, so a replay stays bit-identical to the eager program. A
  rewrite that fails raises; no graph is instantiated with its memsets.
  Each graph's nodes are counted by type (:func:`graph_node_types`:
  kernel, memset, memcpy, event, host, other).
- Every graph of a cache shares one memory pool. Static inputs are
  allocated outside it. Static outputs are held by their entries, so no
  later capture reuses their blocks. The intermediates of different graphs
  may share blocks, because replays run one at a time, in the order they
  are queued on the caller's stream (``engine_core._QUEUE_LOCK``).
- :meth:`GraphCache.run` copies a batch's inputs into the static inputs
  before the replay. The caller copies the static output out behind it, on
  the same stream: the next replay of that key overwrites it.
- The kernels' ``launches`` counters move in their wrappers, in Python: at
  capture, when nothing runs, and never at replay. So a capture takes back
  what its eager run and its capture counted, and each replay adds what the
  capture recorded. ``launches`` then counts the kernels that ran for
  dispatched batches.

The graph class is a parameter: the CPU tests drive the cache with a class
that re-runs the captured callable into the same static buffers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Any, Callable

import torch

from ..ops.kernels import add_launches, launch_counts
from ..ops.kernels.build import load_library
from ..utils.logging import get_logger

log = get_logger("graphs")

# CUgraphNodeType, the driver's node types, by the names a count uses;
# the others (child graph, empty, semaphore, allocation and conditional
# nodes) count as "other".
_NODE_TYPE_NAMES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    6: "event", 7: "event"}
NODE_TYPES = ("kernel", "memset", "memcpy", "event", "host", "other")

# Captures and replays by this process, over every cache; callers may reset
# them to 0 (a run shows with them that each batch was one replay).
captures = 0
replays = 0


def graph_node_types(raw_graph: int) -> dict[str, int]:
    """Nodes of a ``cudaGraph_t`` by type (:data:`NODE_TYPES`; wait and
    record event nodes are both "event"), through the driver API
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(raw_graph)
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(graph, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int()
    types = dict.fromkeys(NODE_TYPES, 0)
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        types[_NODE_TYPE_NAMES.get(kind.value, "other")] += 1
    return types


def rewrite_graph(raw_graph: int, device: torch.device) -> dict[str, int]:
    """Replace every memset node of a captured, not yet instantiated
    ``cudaGraph_t`` by a kernel node that writes the same bytes, and every
    memcpy node between linear memory that a kernel reaches by a kernel node
    that copies the same bytes, each with the same edges
    (``csrc/graph_fill.cu``). Returns how many of each were replaced. Raises
    on a driver error: the graph is then not to be instantiated."""
    fn = load_library("graph_fill").vv_graph_rewrite
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    counts = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = fn(raw_graph, counts)
    if err != 0:
        raise RuntimeError(
            f"rewriting a captured graph's memset and memcpy nodes failed: CUDA error {err} "
            f"after {counts[0]} memsets and {counts[1]} memcpys")
    return {"memset": counts[0], "memcpy": counts[1]}


# One side stream per card for every capture of the process, as
# ``torch.cuda.graph`` keeps one default capture stream: cuBLAS keeps a
# workspace (32 MiB on an H100) for each stream it has run on, for the life of
# the process, so a stream per cache would hold one more each.
_side_streams: dict = {}


class CudaGraph:
    """One ``torch.cuda.CUDAGraph``, captured on the process's side stream
    into the cache's pool."""

    @staticmethod
    def shared(device: torch.device):
        """What every graph of a cache shares: (memory pool, side stream).
        Caches share the stream too; their captures are serialized by the
        caller (``engine_core._QUEUE_LOCK``)."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in _side_streams:
            _side_streams[index] = torch.cuda.Stream(index)
        load_library("graph_fill")  # built here, not between capture and instantiation
        return torch.cuda.graph_pool_handle(), _side_streams[index]

    def __init__(self, shared):
        self.pool, self.stream = shared
        # The cudaGraph_t is kept after capture so that its memset nodes can
        # be rewritten and its nodes counted; it is instantiated once, right
        # after.
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.node_types: dict[str, int] | None = None  # as instantiated
        self.rewritten: dict[str, int] | None = None  # nodes rewritten as kernels, by type

    def warm(self, fn: Callable[[], Any]) -> Any:
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        with torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()
        raw = self.graph.raw_cuda_graph()
        self.rewritten = rewrite_graph(raw, self.stream.device)
        self.node_types = graph_node_types(raw)
        if self.node_types["memset"]:
            raise RuntimeError(f"{self.node_types['memset']} memset nodes left after the rewrite")
        self.graph.instantiate()
        return out

    def replay(self) -> None:
        self.graph.replay()


@dataclasses.dataclass
class GraphEntry:
    """One captured program: its graph, static inputs and static output."""

    graph: Any
    inputs: tuple
    output: torch.Tensor
    launches: dict  # kernel launches of one replay, by kernel module
    capture_s: float  # host wall of the eager run and the capture


class GraphCache:
    """Captured programs of one core, keyed as the caller says; one
    memory pool for all of them."""

    def __init__(self, device, graph_cls=CudaGraph):
        self.device = torch.device(device)
        self._graph_cls = graph_cls
        self._shared = None
        self.entries: dict = {}
        self.captures = 0
        self.replays = 0

    def pool_bytes(self) -> tuple[int, int]:
        """(reserved, allocated) bytes of the cache's memory pool on the
        card, from the allocator's snapshot; (0, 0) before the first
        capture."""
        if self._shared is None:
            return 0, 0
        pool = tuple(self._shared[0])
        segments = [s for s in torch.cuda.memory_snapshot()
                    if tuple(s.get("segment_pool_id", ())) == pool]
        return (sum(s["total_size"] for s in segments),
                sum(s["allocated_size"] for s in segments))

    def run(self, key, program: Callable[..., torch.Tensor], inputs,
            prepared: Callable[[], None] | None = None,
            warm_is_call: bool = False) -> torch.Tensor:
        """Replay ``key``'s graph on ``inputs`` (host or device tensors of
        fixed shapes), capturing ``program(*static_inputs)`` first if the key
        is new. ``prepared`` runs between the eager run and the capture: it
        raises if something the capture needs is missing, or makes it.
        Returns the static output: copy it before the next replay of ``key``.

        With ``warm_is_call`` a new key's eager run is this call: its output
        is returned and the new graph is not replayed. That is for a program
        that changes state, such as a train step, which must run once a
        call."""
        global replays
        entry = self.entries.get(key)
        if entry is None:
            entry, warm = self._capture(key, program, inputs, prepared)
            if warm_is_call:
                add_launches(entry.launches)
                return warm
        else:
            self._load(entry, inputs)
        entry.graph.replay()
        add_launches(entry.launches)
        self.replays += 1
        replays += 1
        return entry.output

    @staticmethod
    def _load(entry: GraphEntry, inputs) -> None:
        for static, x in zip(entry.inputs, inputs, strict=True):
            if static.shape != x.shape or static.dtype != x.dtype:
                raise ValueError(
                    f"input {tuple(x.shape)} {x.dtype} does not fit the graph's "
                    f"{tuple(static.shape)} {static.dtype}")
            static.copy_(x, non_blocking=True)

    def _capture(self, key, program, inputs, prepared) -> tuple[GraphEntry, Any]:
        """Capture ``key``'s graph; returns its entry and the eager run's
        output."""
        global captures
        t0 = time.perf_counter()
        statics = tuple(
            torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in inputs)
        entry = GraphEntry(None, statics, None, {}, 0.0)
        self._load(entry, inputs)
        if self._shared is None:
            self._shared = self._graph_cls.shared(self.device)
        graph = self._graph_cls(self._shared)
        before = launch_counts()
        try:
            warm = graph.warm(lambda: program(*statics))
            if prepared is not None:
                prepared()
            start = launch_counts()
            output = graph.capture(lambda: program(*statics))
            end = launch_counts()
        finally:
            now = launch_counts()
            add_launches({k: before[k] - now[k] for k in now})
        entry.graph, entry.output = graph, output
        entry.launches = {k: end[k] - start[k] for k in end if end[k] != start[k]}
        entry.capture_s = time.perf_counter() - t0
        self.entries[key] = entry
        self.captures += 1
        captures += 1
        log.info("Captured %s in %.2fs: nodes by type %s, rewritten as kernels %s; "
                 "attention launches %s", key[:3], entry.capture_s,
                 getattr(graph, "node_types", None), getattr(graph, "rewritten", None),
                 entry.launches)
        return entry, warm
