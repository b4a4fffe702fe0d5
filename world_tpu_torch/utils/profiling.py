"""Observability of the port (port of world_tpu/utils/profiling.py): the
tracer, a timer that waits for the device, and a ``torch.profiler`` trace
exporter.

The tracer, :data:`TRACER`, records:

  * spans at the layer boundaries (:meth:`Tracer.span`), named
    ``world.<layer>.<step>``: a name, its own id, its parent's id, the id of
    the call into an entry point it belongs to (the id of the call's
    outermost span), its host start and end from ``time.perf_counter_ns()``
    and, for a span given a CUDA device, its device ms from CUDA events on
    the device's current stream.  While a ``torch.profiler`` session
    records, each span is also a profiler range of its name, so that it
    sits in the profiler's trace on the device trace's clock and the
    operations it issues nest under it;
  * stage spans (``world.stage.f0``, ``.envelope``, ``.aperiodicity``,
    ``.synthesis``) between the stamps the round trips make at their stage
    boundaries (:meth:`Tracer.stamp`).  Inside a captured CUDA graph a stamp
    is an event-record node of the graph, captured whether or not tracing
    is on; a replay made while tracing reads them once it has run;
  * counters (:meth:`Tracer.count`), always on, added where the work
    happens (:data:`COUNTERS`).  A call's outermost span keeps what each
    counter gained during the call.  A counter that device work adds to
    (:meth:`Tracer.device_counter`, a kernel's int64 on the card) is read
    into its counter only at the end of an entry point's call (an outermost
    span given a device) while the tracer records, so off it costs no wait
    for the device.

It records while :func:`tracing` is entered, or while a profiler session
records in the process.  Otherwise a boundary costs one check and records,
allocates and opens nothing.  Spans are kept in memory, at most
``capacity`` of them; the tracer counts those it refuses past that.
"""
import collections
import contextlib
import functools
import itertools
import threading
import time

import torch

# whether a torch.profiler session records in the process: ~0.2 us a call,
# where a record_function range costs ~17 us even with no profiler
_profiler_on = torch._C._autograd._profiler_enabled
# a profiler range of the function scope, as aten's ops are: the kernels it
# issues nest under it, and the profiler draws no range of it on the device
# timeline (record_function's user scope does, which the device's busy time
# and kernel counts read from a trace would then include)
_RANGE = torch._C._profiler._RecordFunctionFast

SPAN_CAPACITY = 1 << 16
# a round trip's stage boundaries in order: "start" before the first stage,
# then each stage's name where it ends
STAGES = ("start", "f0", "envelope", "aperiodicity", "synthesis")
# the counters and what each counts (on the CPU the same reads and copies,
# within host memory)
COUNTERS = {
    "host.syncs": "reads of a tensor's values on the host: on the card, a "
                  "wait for the device",
    "bytes.d2h": "bytes of those reads",
    "bytes.h2d": "bytes the program copies from host memory into tensors",
    "samples.computed": "samples the round trips compute: rows times the "
                        "padded length",
    "samples.true": "the callers' own samples among them, where the entry "
                    "knows them",
    "copy_back.bytes": "bytes the copy back hands to the host "
                       "(parallel/graphs.py::copy_back)",
    "copy_back.fresh_bytes": "those of them for which the host caching "
                             "allocator had no free pinned block: fresh "
                             "pinned memory",
    "synth.pulses.slots": "pulse slots of the classic syntheses' static "
                          "pulse axes: rows times max_pulses",
    "synth.pulses.live": "the live pulses among them, which the classic "
                         "syntheses compute (K8's live blocks count them on "
                         "the card): read off the device at a traced call's "
                         "end",
}


class Span:
    """One span: ``name``, ``id``, ``parent`` (None for a call's outermost
    span), ``call``, ``attrs``, host ``t0``/``t1`` in ns (None for a stage
    span read off a graph replay, which has only device time), ``device_ms``
    (None without a CUDA device) and, on a call's outermost span,
    ``counts``: what each counter gained during the call."""

    __slots__ = ("name", "id", "parent", "call", "attrs", "t0", "t1",
                 "device_ms", "counts", "_events", "_tracer", "_device",
                 "_range", "_at_entry")

    def __init__(self, name, id, parent=None, call=None, attrs=None, t0=None,
                 t1=None, device_ms=None, events=None):
        self.name, self.id, self.parent = name, id, parent
        self.call = id if call is None else call
        self.attrs = attrs or {}
        self.t0, self.t1, self.device_ms = t0, t1, device_ms
        self.counts = None
        self._events = events
        self._tracer = self._device = self._range = self._at_entry = None

    @property
    def host_ms(self):
        return None if self.t0 is None else (self.t1 - self.t0) / 1e6

    def _resolve(self):
        """Read the device ms off the span's events once they have run."""
        if self._events is not None and self._events[1] is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
        self._events = None

    def __enter__(self):
        tracer = self._tracer
        stack = tracer._local.stack
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.counts = tracer.counters()
            if self._device is not None:          # a call into an entry point
                self._at_entry = tracer._device_snapshot()
        if _profiler_on():
            self._range = _RANGE(self.name)
            self._range.__enter__()
        if self._device is not None:
            device = torch.device(self._device)
            if device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
                self._device = device
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(device))
                self._events = (start, None)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        tracer = self._tracer
        tracer._local.stack.pop()
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            self._events = (self._events[0], end)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self.counts is not None:
            if self._at_entry is not None:
                tracer._read_device_counters(self._at_entry)
            now = tracer.counters()
            self.counts = {k: v - self.counts.get(k, 0) for k, v in now.items()}
        self._tracer = self._device = self._range = self._at_entry = None
        tracer._keep(self)
        return False


class _Local(threading.local):
    """A thread's open spans, its last stage stamp and, while it captures a
    graph, the graph's stamps."""

    stamp = stamps = None

    def __init__(self):
        self.stack = []


class _Off:
    """What a boundary enters while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Tracer:
    """Spans, stage stamps and counters (the module's docstring)."""

    def __init__(self):
        self.capacity = SPAN_CAPACITY
        self.dropped = 0
        self._depth = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = _Local()
        self._spans = collections.deque()
        self._pending = {}
        self._counts = dict.fromkeys(COUNTERS, 0)
        self._device_counters = {}

    # ------------------------------------------------------------ switches
    def on(self) -> bool:
        """Whether the tracer records: within :meth:`tracing`, or while a
        profiler session records."""
        return self._depth > 0 or _profiler_on()

    @contextlib.contextmanager
    def tracing(self):
        """Record within the block (on every thread)."""
        with self._lock:
            self._depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._depth -= 1

    # --------------------------------------------------------------- spans
    def span(self, name: str, device=None, **attrs):
        """A span of ``name`` around a ``with`` block; with a CUDA
        ``device``, its device ms from events on the device's current stream
        (not while that stream is captured).  Entering it gives the
        :class:`Span`, or None while the tracer is off."""
        if not self.on():
            return _OFF
        span = Span(name, next(self._ids), attrs=attrs)
        span._tracer, span._device = self, device
        return span

    def spanned(self, name: str):
        """A decorator: each call of the function is a span of ``name``."""
        def wrap(fn):
            @functools.wraps(fn)
            def traced(*args, **kwargs):
                with self.span(name):
                    return fn(*args, **kwargs)
            return traced
        return wrap

    def spans(self) -> list:
        """The spans kept, oldest first, every device time read (this waits
        for the device where a replay's stamps or an event are pending)."""
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for stamps, span in pending:
            self._read_stamps(stamps, span)
        with self._lock:
            spans = list(self._spans)
        for span in spans:
            span._resolve()
        return spans

    def clear(self):
        """Forget every span, pending stamp and count."""
        with self._lock:
            self._spans.clear()
            self._pending.clear()
            self._counts = dict.fromkeys(COUNTERS, 0)
            self.dropped = 0

    def _keep(self, span):
        with self._lock:
            if len(self._spans) >= self.capacity:
                self.dropped += 1
            else:
                self._spans.append(span)

    # ------------------------------------------------------------ counters
    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def device_counter(self, name: str, device) -> torch.Tensor:
        """The int64 tensor (1,) on ``device`` that work there adds the
        counter ``name``'s gains to (a kernel, or the plain version's
        tensor op on the CPU).  Made at its first use, which must not be
        under a graph capture (the capture would zero it at each replay);
        it then lives as long as the process, so graphs may hold it."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (name, str(device))
        t = self._device_counters.get(key)
        if t is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the device counter {name} on {device} is "
                                   f"first asked for under a graph capture: "
                                   f"make it in an eager call first")
            t = torch.zeros(1, dtype=torch.int64, device=device)
            with self._lock:
                t = self._device_counters.setdefault(key, t)
        return t

    def _device_snapshot(self) -> list:
        """At a call's entry: (name, tensor, a copy of its value) of each
        device counter, the copy made on the device without a wait."""
        if not self._device_counters or (torch.cuda.is_available()
                                         and torch.cuda.is_current_stream_capturing()):
            return []
        with self._lock:
            items = list(self._device_counters.items())
        return [(name, t, t.clone()) for (name, _), t in items
                if t.device.type != "meta"]

    def _read_device_counters(self, at_entry):
        """At a traced call's end: add what each device counter gained since
        ``at_entry`` (:meth:`_device_snapshot`) to its counter, after the
        device has run the call's work; a counter made during the call
        gained all it holds."""
        if not self._device_counters or (torch.cuda.is_available()
                                         and torch.cuda.is_current_stream_capturing()):
            return
        before = {id(t): snap for _, t, snap in at_entry or ()}
        with self._lock:
            items = list(self._device_counters.items())
        for (name, _), t in items:
            if t.device.type == "meta":
                continue
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            snap = before.get(id(t))
            gain = int(t.item()) - (0 if snap is None else int(snap.item()))
            if gain:
                self.count(name, gain)

    # --------------------------------------------------------- stage stamps
    def stamp(self, stage: str, device):
        """A round trip's stage boundary (:data:`STAGES`) for work on
        ``device``.  While this thread captures a graph under
        :meth:`collecting`: an event-record node of the graph.  Otherwise,
        while tracing: the span of the stage that ends here, from the
        previous stamp under the same open span (a timing event on a CUDA
        device's current stream marks the device side)."""
        collected = self._local.stamps
        if collected is not None:
            event = torch.cuda.Event(enable_timing=True, external=True)
            event.record()
            collected.append((stage, event))
            return
        if not self.on():
            return
        event = None
        device = torch.device(device)
        if device.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                return
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(device))
        now = time.perf_counter_ns()
        stack = self._local.stack
        parent = stack[-1] if stack else None
        last = self._local.stamp
        if last is not None and last[0] is parent and _follows(last[1], stage):
            ids = (None, None) if parent is None else (parent.id, parent.call)
            self._keep(Span(f"world.stage.{stage}", next(self._ids), *ids,
                            t0=last[2], t1=now,
                            events=None if event is None else (last[3], event)))
        self._local.stamp = (parent, stage, now, event)

    @contextlib.contextmanager
    def collecting(self):
        """Within the block this thread's stamps are recorded as event
        nodes of the graph it captures; gives their list of (stage,
        event)."""
        stamps = []
        self._local.stamps = stamps
        try:
            yield stamps
        finally:
            self._local.stamps = None

    def file(self, stamps: list, span):
        """After a replay of the graph whose capture collected ``stamps``,
        under ``span`` (None while the tracer is off): keep them pending
        until they are read."""
        if span is not None and stamps:
            with self._lock:
                self._pending[id(stamps)] = (stamps, span)

    def settle(self, stamps: list):
        """Read the pending stamps of a graph's last replay, before the
        graph replays again and records them anew."""
        if not self._pending:
            return
        with self._lock:
            entry = self._pending.pop(id(stamps), None)
        if entry is not None:
            self._read_stamps(*entry)

    def _read_stamps(self, stamps: list, span):
        """A replay's stage spans under ``span``, from its graph's events."""
        stamps[-1][1].synchronize()
        for (first, start), (stage, end) in zip(stamps, stamps[1:]):
            if _follows(first, stage):
                self._keep(Span(f"world.stage.{stage}", next(self._ids),
                                span.id, span.call,
                                device_ms=start.elapsed_time(end)))


def _follows(previous: str, stage: str) -> bool:
    """Whether ``stage`` ends a stage that began at the stamp ``previous``:
    the next stage, or any stage after "start" (a synthesis alone)."""
    if stage == "start":
        return False
    return previous == "start" or STAGES.index(previous) == STAGES.index(stage) - 1


TRACER = Tracer()


def tracing():
    """Switch :data:`TRACER` on within a ``with`` block."""
    return TRACER.tracing()


def _on_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_cuda(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_cuda(v) for v in out)
    return False


def timed(fn, *args, repeats: int = 3):
    """Median wall time of a computation after one warm-up call; where the
    outputs are on the GPU, each call is waited for with
    ``torch.cuda.synchronize``."""
    def run():
        out = fn(*args)
        if _on_cuda(out):
            torch.cuda.synchronize()
        return out

    out = run()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the host and, where there is one,
    the GPU, written to ``logdir`` as a Chrome trace (view in Perfetto or
    TensorBoard).  The tracer's spans are ranges in it."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
