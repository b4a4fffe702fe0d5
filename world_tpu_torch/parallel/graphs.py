"""One CUDA graph per static signature: the port's ``jax.jit``.

The Harvest/Requiem and the classic round trips run on static shapes with
no host sync (:func:`.batch.encode_decode_one`,
:func:`.batch.encode_decode_classic_one`), so one call can be captured into
a CUDA graph and replayed: the host then issues one launch for the whole round
trip instead of thousands.  A :class:`GraphCache` keeps one graph per
signature (the caller's key: device, shapes, caps, type, the tables'
identity):

  * a signature's first call runs the same static code eagerly: a capture
    costs a few eager calls, and pays only where a signature comes back (a
    ragged server's buckets change their rows from call to call);
  * its second call captures the graph and replays it, and every later
    call replays it;
  * the graphs' memory pools (each about its call's peak) are held to
    ``GRAPH_POOL_BUDGET`` together: past it the least recently used graphs
    are dropped (the newest always stays), and a dropped signature starts
    again at its first call.  ``clear()`` drops them all; the pools then
    return to PyTorch's caching allocator (``torch.cuda.empty_cache()``
    gives them back to the card).

Capture (:meth:`GraphCache.capture`):
  * a warm-up call on a side stream first: it builds the kernel library,
    the kept tables (:mod:`..tables`), cuFFT's and cuBLAS's plans and sets
    each kernel's shared-memory attribute, none of which a capture may do;
  * then the capture, in ``thread_local`` mode, so that the worker threads
    of a call over several devices do not void each other's captures; one
    capture at a time in the process;
  * a capture that fails raises with the shapes.  Nothing falls back to an
    eager call on the card.
Replay (:meth:`Graph.replay`): the inputs are copied into the graph's
static buffers, the graph is replayed on the current stream and the
outputs are cloned out of its pool.  The kernels' launch counters get, at
each replay, the launches recorded at capture
(:class:`.._backend.LaunchCounter`).
"""
import threading
import time
from collections import OrderedDict

import torch

from .. import tables
from .._backend import STAGE_BYTES_BUDGET
from ..ops import edge_interp, extension_scan, fix_step3, refine_dft

# the pool bytes a cache's graphs hold together: 4 GiB, a twentieth of an
# 80 GB card, holds the 60 s round trip's graph (2.6 GiB) or a ragged
# server's few hot buckets; the stages' own budget is a quarter of it
GRAPH_POOL_BUDGET = 4 * STAGE_BYTES_BUDGET
# the signatures called once and not yet captured that a cache remembers
SEEN_SIZE = 256

_COUNTERS = {"event_engine": edge_interp.counter,
             "refine_dft": refine_dft.counter,
             "extension_scan": extension_scan.counter,
             "extend_chains": fix_step3.extend_counter,
             "merge_sections": fix_step3.merge_counter}
# one capture at a time in the process: the warm-up and the capture of two
# worker threads on one card would share the allocator's capture state
_CAPTURE_LOCK = threading.Lock()


class GraphCaptureError(RuntimeError):
    """A round trip could not be captured into a CUDA graph."""


class Graph:
    """A captured call: its static inputs and outputs, the kernel launches
    one replay makes, the tables it reads, its capture time and the bytes
    its memory pool took."""

    def __init__(self, device, graph, inputs, outputs, launches, kept,
                 capture_s, pool_bytes):
        self.device = device
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches, self.kept = launches, kept
        self.capture_s, self.pool_bytes = capture_s, pool_bytes
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()

    def replay(self, inputs) -> dict:
        """The outputs of the captured call on ``inputs`` (copied into the
        static buffers), cloned out of the graph's pool."""
        with self._lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            # the last replay's outputs are cloned before the buffers change
            stream.wait_event(self._done)
            for static, x in zip(self.inputs, inputs):
                static.copy_(x)
            self.graph.replay()
            for name, n in self.launches.items():
                if n:
                    _COUNTERS[name].add(n)
            out = {k: v.clone() for k, v in self.outputs.items()}
            self._done.record(stream)
        return out

    def finish(self):
        """Wait for the last replay's outputs to be cloned."""
        self._done.synchronize()


def _shapes(inputs) -> str:
    return ", ".join(f"{tuple(t.shape)} {t.dtype} on {t.device}" for t in inputs)


def _end_pool(device, pool):
    """Stop routing the capture stream's allocations to a failed capture's
    memory pool and free the pool.  The capture's end stops the routing
    itself unless the end failed before it got there, so a second stop may
    find nothing to stop: that is not an error here."""
    try:
        torch._C._cuda_endAllocateToPool(device.index, pool)
    except RuntimeError:
        pass
    torch._C._cuda_releasePool(device.index, pool)


def _capture(fn, inputs, device) -> Graph:
    with torch.cuda.device(device), tables.retained() as kept:
        static = [torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)
                  for x in inputs]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = {name: c.captured() for name, c in _COUNTERS.items()}
        generator = torch.cuda.default_generators[device.index]
        rng_state = generator.get_state()
        t0 = time.perf_counter()
        # torch.cuda.graph's steps, with its stream restored and its pool
        # ended where the capture fails: there its __exit__ raises before it
        # restores the stream, so the caller would go on issuing work on the
        # capture stream, and the allocator, told nothing, would go on
        # reserving memory for the failed graph that empty_cache() cannot free
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        capture = torch.cuda.Stream(device)
        capture.wait_stream(torch.cuda.current_stream(device))
        error = None
        pool = torch.cuda.graph_pool_handle()   # the graph's own, as by default
        with torch.cuda.stream(capture):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                reserved = torch.cuda.memory_reserved(device)
                outputs = fn(*static)
                pool_bytes = torch.cuda.memory_reserved(device) - reserved
            except Exception as e:       # noqa: BLE001 (raised below)
                error = e
            try:
                graph.capture_end()
            except Exception as e:       # noqa: BLE001 (raised below)
                error = error or e
                _end_pool(device, pool)
        torch.cuda.current_stream(device).wait_stream(capture)
        if error is not None:
            # a capture that ends in an error leaves the device's default
            # generator marked as capturing, and every later draw on it
            # fails: give it a fresh state with its seed and offset
            fresh = torch.Generator(device=device)
            fresh.set_state(rng_state)
            generator.graphsafe_set_state(fresh)
            raise GraphCaptureError(
                f"CUDA graph capture failed for inputs {_shapes(inputs)}: "
                f"{type(error).__name__}: {error}") from error
        capture_s = time.perf_counter() - t0
        launches = {name: c.captured() - before[name]
                    for name, c in _COUNTERS.items()}
    return Graph(device, graph, static, outputs, launches, kept, capture_s,
                 pool_bytes)


class GraphCache:
    """Graphs by key: a key's first call runs eagerly, its second captures
    its graph, later calls replay it; the pools are held to ``budget``
    bytes together, the least recently used graph dropped first.
    ``calls`` counts the calls run eagerly, captured and replayed."""

    def __init__(self, budget: int = GRAPH_POOL_BUDGET):
        self.budget = budget
        self.calls = {"eager": 0, "captured": 0, "replayed": 0}
        self._graphs = OrderedDict()
        self._seen = OrderedDict()
        self._lock = threading.Lock()

    def clear(self):
        """Drop every graph (their pools are freed) and every key seen."""
        with self._lock:
            for graph in self._graphs.values():
                graph.finish()
            self._graphs.clear()
            self._seen.clear()

    def graphs(self) -> list:
        """The graphs held, least recently used first."""
        with self._lock:
            return list(self._graphs.values())

    def pool_bytes(self) -> int:
        """The bytes the graphs' memory pools hold."""
        with self._lock:
            return sum(g.pool_bytes for g in self._graphs.values())

    def _count(self, kind: str):
        with self._lock:
            self.calls[kind] += 1

    def _lookup(self, key):
        with self._lock:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
            return graph

    def _first_call(self, key) -> bool:
        """Whether ``key`` has not been called since it was last dropped
        (it is remembered from now on)."""
        with self._lock:
            if key in self._seen:
                del self._seen[key]
                return False
            self._seen[key] = None
            while len(self._seen) > SEEN_SIZE:
                self._seen.popitem(last=False)
            return True

    def capture(self, key, fn, inputs, device) -> Graph:
        """The graph of ``key``, captured from ``fn(*inputs)`` now unless it
        is held (once, when several threads ask for it together)."""
        with _CAPTURE_LOCK:
            graph = self._lookup(key)
            if graph is not None:
                return graph
            graph = _capture(fn, inputs, tables.device_key(device))
            with self._lock:
                self._graphs[key] = graph
                self.calls["captured"] += 1
                held = sum(g.pool_bytes for g in self._graphs.values())
                while held > self.budget and len(self._graphs) > 1:
                    _, old = self._graphs.popitem(last=False)
                    # its pool is freed: let its last replay finish
                    old.finish()
                    held -= old.pool_bytes
        return graph

    def run(self, key, fn, inputs, device) -> dict:
        """``fn(*inputs)``: run eagerly on ``device`` on the first call of
        ``key``, by the replay of its graph from the second on."""
        graph = self._lookup(key)
        if graph is None:
            if self._first_call(key):
                self._count("eager")
                return fn(*(x.to(device) for x in inputs))
            graph = self.capture(key, fn, inputs, device)
        self._count("replayed")
        return graph.replay(inputs)
