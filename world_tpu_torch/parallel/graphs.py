"""One CUDA graph per static signature: the port's ``jax.jit``.

The Harvest/Requiem and the classic round trips run on static shapes with
no host sync (:func:`.batch.encode_decode_one`,
:func:`.batch.encode_decode_classic_one`), so one call can be captured into
a CUDA graph and replayed: the host then issues one launch for the whole round
trip instead of thousands.  A :class:`GraphCache` keeps one graph per
signature (the caller's key: device, shapes, caps, type, the tables'
identity), as ``jax.jit`` keeps one executable per shape:

  * a signature's first call runs the same static code eagerly, so that a
    signature seen once costs no capture (a ragged server's buckets change
    their rows from call to call);
  * its second call captures the graph and replays it, and every later
    call replays it.  The capture does not run the call again first: the
    eager call already built what a capture may not (below);
  * every graph a cache captures on one device goes into one memory pool,
    which the cache owns.  The pool holds about its largest call's peak
    plus every graph's static outputs, not the sum of the peaks, and
    ``GRAPH_POOL_BUDGET`` counts it once: the bytes it reserved, each
    capture adding what it grew the pool by;
  * a pool gives its memory back only with its last graph, so past the
    budget the cache drops whole pools, least recently used first, before
    its next capture; a dropped signature starts again at its first call.
    ``clear()`` drops them all; the pools then return to PyTorch's caching
    allocator (``torch.cuda.empty_cache()`` gives them back to the card).

Why graphs that share a pool may replay in any order.  PyTorch calls a
shared pool safe when its graphs replay in the order they were captured;
here they replay in any order, from several threads.  A graph's
intermediates lie in blocks that the graphs captured after it may have
taken for their own intermediates or outputs, so the cache guarantees:
  (a) the replays of a pool never overlap: one lock a pool is held from the
      copy of the inputs to the clone of the outputs, and each replay's
      stream waits for the event recorded after the pool's last clone (the
      worker threads of a call over several devices, two of them on one
      card, replay different signatures of one pool);
  (b) a replay's outputs are cloned out of the pool before any other graph
      of the pool replays.  The static outputs stay allocated in the pool,
      so no later capture takes their blocks; another graph's
      intermediates overwrite them between two replays, which (a) and (b)
      make harmless.
The static inputs are allocated outside the pool.  Every capture of a pool
runs on the pool's own stream: the allocator hands a pool's free blocks
only to allocations on the stream that freed them, so captures on other
streams would each grow the pool by their peak.  cuBLAS keeps a workspace a
(handle, stream): the workspaces are cleared before and after each capture,
so that a capture allocates its own in the pool (one of its intermediates)
and no eager call or other pool's graph ever uses a block of the pool.

Capture (:meth:`GraphCache.capture`):
  * an eager call of the signature on the device comes first, in the same
    cache: through :meth:`GraphCache.run` the signature's first call, or
    one that ``capture`` makes itself when called directly.  It builds the
    kernel library, the kept tables (:mod:`..tables`), cuFFT's plans and the
    thread's cuBLAS handle and sets each kernel's shared-memory attribute,
    none of which a capture may do.  The tables it read are kept with the
    signature until the capture, which finds them even where the table
    cache has dropped them since;
  * then the capture, in ``thread_local`` mode, so that the worker threads
    of a call over several devices do not void each other's captures; one
    capture at a time in the process;
  * a capture that fails raises :class:`GraphCaptureError` with the
    shapes.  Nothing retries it and nothing falls back to an eager call on
    the card.  What PyTorch 2.11's allocator does then
    (``tools/probe_graph_pool_torch.py`` on the card): a capture whose end
    fails leaves the capture stream's allocations routed to the pool;
    ``_end_capture`` stops that and gives back one use of the pool, which
    frees nothing while other graphs hold it, and they replay right.  But
    the allocator refuses any later capture into the pool ("already
    recording to mempool_id") and keeps one use of it that nothing gives
    back, so its segments stay reserved after its last graph goes.  So the
    pool takes no more captures: its graphs stay and replay, and the
    device's next capture opens a new pool.
Replay (:meth:`Graph.replay`): under (a), the inputs are copied into the
graph's static buffers, the graph is replayed on the current stream and the
outputs are cloned out of the pool.  The kernels' launch counters get, at
each replay, the launches recorded at capture
(:class:`.._backend.LaunchCounter`).

The copy back (:func:`copy_back`): a round trip's outputs on the card go to
the host as asynchronous copies into pinned host tensors, one wait for them
all, so that the copies run at the bus's rate with no bounce buffer and no
page faults.  The pinned blocks come from PyTorch's host caching
allocator, which hands a block out again only once its tensor is freed and
the copies that used it have completed: a caller keeps the tensors it is
given for as long as it likes, and no later call writes into them.  Only
the calls whose outputs are still held when the next call allocates pin
fresh memory (``copy_back.fresh_bytes``, read while the tracer records).
The allocator rounds each block up to a power of two and never gives its
blocks back to the system: a caller that keeps many outputs holds about
twice their size in pinned memory, which cannot be swapped, until it
frees them, and then the process keeps the blocks for later copies.

Tracing (:mod:`..utils.profiling`): a capture records the round trip's
stage stamps as event-record nodes of the graph, which the graph owns; a
replay made while the tracer records files them under its launch span, and
the tracer reads them as stage spans once the replay has run (before the
graph's next replay at the latest).
"""
import threading
import time
from collections import OrderedDict

import torch

from .. import tables
from .._backend import STAGE_BYTES_BUDGET
from ..utils.profiling import TRACER
from ..ops import (classic_pulses, d4c_spectra, edge_interp, extension_scan,
                   fix_step3, refine_dft)

# the bytes a cache's pools hold together: 4 GiB, a twentieth of an 80 GB
# card, holds the 60 s round trip's graph (2.6 GiB) or a ragged server's
# hot set; the stages' own budget is a quarter of it
GRAPH_POOL_BUDGET = 4 * STAGE_BYTES_BUDGET
# the signatures called once and not yet captured that a cache remembers
SEEN_SIZE = 256

_COUNTERS = {"event_engine": edge_interp.counter,
             "refine_dft": refine_dft.counter,
             "extension_scan": extension_scan.counter,
             "extend_chains": fix_step3.extend_counter,
             "merge_sections": fix_step3.merge_counter,
             "d4c_centroid": d4c_spectra.centroid_counter,
             "d4c_band_ap": d4c_spectra.band_ap_counter,
             "classic_pulses": classic_pulses.pulse_counter}
# one capture at a time in the process: two captures would share the
# allocator's capture state
_CAPTURE_LOCK = threading.Lock()


class GraphCaptureError(RuntimeError):
    """A round trip could not be captured into a CUDA graph."""


class Pool:
    """The memory pool a cache's graphs on one device share, with what
    keeps their replays apart: the lock and the event of (a) and (b) in the
    module's docstring, and the stream every capture into it runs on.
    ``bytes``: what its captures grew the allocator's reservation by."""

    def __init__(self, device):
        self.device = device
        self.lock = threading.Lock()
        self.bytes = 0
        self.handle = self.stream = self.done = None

    def open(self):
        """Make the pool's handle, capture stream and replay event (at its
        first capture)."""
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
            self.done = torch.cuda.Event()

    def finish(self):
        """Wait for the last replay's outputs to be cloned."""
        if self.done is not None:
            self.done.synchronize()


def _pinned_blocks() -> int:
    """The pinned blocks PyTorch's host caching allocator has made so far."""
    return torch.cuda.memory.host_memory_stats_as_nested_dict()["num_host_alloc"]


def copy_back(outputs: dict) -> dict:
    """``outputs`` (name -> tensor) on the host, as the caller's own
    tensors of the same shapes and types: each tensor on the card is copied
    into a pinned host tensor on its device's current stream, as one memcpy
    (a dense tensor's strides are kept; one whose layout has gaps goes
    through a dense copy on the card first), and the copies are waited for
    once; a tensor on the host is handed back as it is.  The copies run
    under the span ``world.batch.copy_back``, whose device ms are theirs.
    Counts one host sync, the bytes handed back (``bytes.d2h``,
    ``copy_back.bytes``) and, while the tracer records, those for which the
    allocator made a fresh pinned block (``copy_back.fresh_bytes``; the
    allocator's count is global, so two threads copying back at once may
    credit each other's blocks)."""
    host, copies, fresh = dict(outputs), [], 0
    devices = list(dict.fromkeys(v.device for v in outputs.values() if v.is_cuda))
    watch = bool(devices) and TRACER.on()
    blocks = _pinned_blocks() if watch else 0
    for k, v in outputs.items():
        if v.is_cuda:
            dst = host[k] = torch.empty_like(v, device="cpu", pin_memory=True)
            if watch:
                now = _pinned_blocks()
                fresh, blocks = fresh + v.nbytes * (now != blocks), now
            if dst.stride() != v.stride():
                v = torch.empty_like(dst, device=v.device).copy_(v)
            flat = (v.numel(),), (1,)
            copies.append((dst.as_strided(*flat), v.as_strided(*flat)))
    n_bytes = sum(v.nbytes for v in outputs.values())
    TRACER.count("host.syncs")
    TRACER.count("bytes.d2h", n_bytes)
    TRACER.count("copy_back.bytes", n_bytes)
    TRACER.count("copy_back.fresh_bytes", fresh)
    with TRACER.span("world.batch.copy_back",
                     device=devices[0] if devices else None):
        for dst, src in copies:
            dst.copy_(src, non_blocking=True)
        for device in devices:
            torch.cuda.current_stream(device).synchronize()
    return host


class Graph:
    """A captured call: its pool, static inputs and outputs, the kernel
    launches one replay makes, the tables it reads, its capture time, the
    bytes its capture grew the pool by and its stage stamps ((stage, event)
    of each event-record node)."""

    def __init__(self, pool, graph, inputs, outputs, launches, kept,
                 capture_s, pool_growth, stamps):
        self.pool = pool
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches, self.kept = launches, kept
        self.capture_s, self.pool_growth = capture_s, pool_growth
        self.stamps = stamps

    def replay(self, inputs) -> dict:
        """The outputs of the captured call on ``inputs`` (copied into the
        static buffers), cloned out of the pool."""
        pool = self.pool
        with pool.lock, torch.cuda.device(pool.device):
            stream = torch.cuda.current_stream()
            # the pool's last replay has cloned its outputs
            stream.wait_event(pool.done)
            with TRACER.span("world.batch.copy_in"):
                for static, x in zip(self.inputs, inputs):
                    if not x.is_cuda:
                        TRACER.count("bytes.h2d", x.nbytes)
                    static.copy_(x)
            TRACER.settle(self.stamps)
            with TRACER.span("world.batch.launch", device=pool.device) as launch:
                self.graph.replay()
            TRACER.file(self.stamps, launch)
            for name, n in self.launches.items():
                if n:
                    _COUNTERS[name].add(n)
            with TRACER.span("world.batch.clone"):
                out = {k: v.clone() for k, v in self.outputs.items()}
            pool.done.record(stream)
        return out


def _shapes(inputs) -> str:
    return ", ".join(f"{tuple(t.shape)} {t.dtype} on {t.device}" for t in inputs)


def _end_capture(device, handle):
    """Stop routing the capture stream's allocations to the pool and give
    back the use the capture counted on it, after a capture whose end
    failed before it stopped the routing itself.  Where the end got that
    far, the graph gives the use back when it is destroyed."""
    try:
        torch._C._cuda_endAllocateToPool(device.index, handle)
    except RuntimeError:
        return
    torch._C._cuda_releasePool(device.index, handle)


def _eager(fn, inputs, device):
    """``fn`` on ``inputs`` moved to ``device``, and the tables it read."""
    TRACER.count("bytes.h2d", sum(x.nbytes for x in inputs if not x.is_cuda))
    with tables.retained() as kept:
        out = fn(*(x.to(device) for x in inputs))
    return out, kept


def _capture(fn, inputs, pool, kept) -> Graph:
    """The graph of ``fn`` on ``inputs``, captured into ``pool``; ``kept``:
    the tables of the eager call of ``fn`` that came before on the device."""
    device = pool.device
    with torch.cuda.device(device), tables.retained(kept) as held:
        pool.open()
        static = [torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)
                  for x in inputs]
        current = torch.cuda.current_stream(device)
        graph = torch.cuda.CUDAGraph()
        before = {name: c.captured() for name, c in _COUNTERS.items()}
        generator = torch.cuda.default_generators[device.index]
        rng_state = generator.get_state()
        # this thread's cuBLAS handle: a capture cannot create one
        torch.cuda.current_blas_handle()
        t0 = time.perf_counter()
        # torch.cuda.graph's steps, with its stream restored and the pool's
        # routing ended where the capture fails: there its __exit__ raises
        # before it restores the stream, so the caller would go on issuing
        # work on the capture stream, and the allocator, told nothing, would
        # go on reserving memory for the failed graph
        pool.stream.wait_stream(current)
        torch._C._cuda_clearCublasWorkspaces()
        error = None
        reserved = torch.cuda.memory_reserved(device)
        with torch.cuda.stream(pool.stream):
            graph.capture_begin(pool=pool.handle,
                                capture_error_mode="thread_local")
            try:
                with TRACER.collecting() as stamps:
                    outputs = fn(*static)
            except Exception as e:       # noqa: BLE001 (raised below)
                error = e
            try:
                graph.capture_end()
            except Exception as e:       # noqa: BLE001 (raised below)
                error = error or e
                _end_capture(device, pool.handle)
        growth = torch.cuda.memory_reserved(device) - reserved
        pool.bytes += growth
        torch._C._cuda_clearCublasWorkspaces()
        current.wait_stream(pool.stream)
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
    return Graph(pool, graph, static, outputs, launches, held, capture_s,
                 growth, stamps)


class GraphCache:
    """Graphs by key: a key's first call runs eagerly, its second captures
    its graph, later calls replay it.  The graphs of one device share one
    memory pool; the pools are held to ``budget`` bytes together, the least
    recently used pool dropped first.  ``calls`` counts the calls run
    eagerly, captured and replayed; ``dropped`` the graphs dropped past the
    budget and ``recaptured`` the captures of a key captured before (both
    since the last ``clear()``)."""

    def __init__(self, budget: int = GRAPH_POOL_BUDGET):
        self.budget = budget
        self.calls = {"eager": 0, "captured": 0, "replayed": 0}
        self.dropped = self.recaptured = 0
        self._graphs = OrderedDict()
        self._pools = {}
        self._seen = OrderedDict()
        self._captured = set()
        self._lock = threading.Lock()

    def clear(self):
        """Drop every graph and pool (the pools are freed) and every key
        seen."""
        with self._lock:
            for pool in self._live():
                pool.finish()
            self._graphs.clear()
            self._pools.clear()
            self._seen.clear()
            self._captured.clear()
            self.dropped = self.recaptured = 0

    def graphs(self) -> list:
        """The graphs held, least recently used first."""
        with self._lock:
            return list(self._graphs.values())

    def pool_bytes(self) -> int:
        """The bytes the cache's memory pools hold (each pool once)."""
        with self._lock:
            return self._held()

    def _live(self) -> list:
        """The pools the cache holds: the devices' and its graphs'."""
        pools = {id(p): p for p in self._pools.values()}
        pools.update((id(g.pool), g.pool) for g in self._graphs.values())
        return list(pools.values())

    def _held(self) -> int:
        return sum(p.bytes for p in self._live())

    def _count(self, kind: str):
        with self._lock:
            self.calls[kind] += 1

    def _lookup(self, key):
        with self._lock:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
            return graph

    def _eager_tables(self, key):
        """The tables of ``key``'s eager call where one ran to its end since
        ``key`` was last dropped, else None."""
        with self._lock:
            return self._seen.get(key)

    def _remember(self, key, kept):
        with self._lock:
            if key not in self._graphs:
                self._seen[key] = kept
                while len(self._seen) > SEEN_SIZE:
                    self._seen.popitem(last=False)

    def _drop_pool(self, pool):
        """Drop a pool and its graphs (under the lock)."""
        pool.finish()
        for key in [k for k, g in self._graphs.items() if g.pool is pool]:
            del self._graphs[key]
            self.dropped += 1
        if self._pools.get(pool.device) is pool:
            del self._pools[pool.device]

    def _pool_for(self, device) -> Pool:
        """The device's pool, after the least recently used pools are
        dropped while the pools pass the budget (under the lock)."""
        while self._graphs and self._held() > self.budget:
            recent = []
            for graph in reversed(self._graphs.values()):
                if graph.pool not in recent:
                    recent.append(graph.pool)
            self._drop_pool(recent[-1])
        pool = self._pools.get(device)
        if pool is None:
            pool = self._pools[device] = Pool(device)
        return pool

    def capture(self, key, fn, inputs, device, kept=None) -> Graph:
        """The graph of ``key``, captured from ``fn(*inputs)`` now unless it
        is held (once, when several threads ask for it together).
        ``kept``: the tables of ``key``'s eager call in this cache on
        ``device``; where it is None, ``fn`` runs eagerly first."""
        device = tables.device_key(device)
        with _CAPTURE_LOCK:
            graph = self._lookup(key)
            if graph is not None:
                return graph
            if kept is None:
                _, kept = _eager(fn, inputs, device)
            with self._lock:
                pool = self._pool_for(device)
            try:
                graph = _capture(fn, inputs, pool, kept)
            except GraphCaptureError:
                with self._lock:
                    self._seen.pop(key, None)
                    # the pool takes no more captures; its graphs stay
                    if self._pools.get(device) is pool:
                        del self._pools[device]
                raise
            with self._lock:
                self._seen.pop(key, None)
                self._graphs[key] = graph
                self.calls["captured"] += 1
                self.recaptured += key in self._captured
                self._captured.add(key)
        return graph

    def run(self, key, fn, inputs, device) -> dict:
        """``fn(*inputs)``: run eagerly on ``device`` on the first call of
        ``key``, by the replay of its graph from the second on (the capture
        waits for the first call's end: two first calls of one key at once
        both run eagerly).  Its span's ``kind`` says which: eager, capture
        (then replay) or replay."""
        graph = self._lookup(key)
        kept = None if graph is not None else self._eager_tables(key)
        kind = ("replay" if graph is not None else "eager" if kept is None
                else "capture")
        with TRACER.span("world.batch.run", device=device, kind=kind):
            if graph is None:
                if kept is None:
                    out, kept = _eager(fn, inputs, device)
                    self._remember(key, kept)
                    self._count("eager")
                    return out
                graph = self.capture(key, fn, inputs, device, kept)
            self._count("replayed")
            return graph.replay(inputs)
