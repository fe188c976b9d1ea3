# Adapted from src/repro/obs/trace.py (standard library only; torch is
# looked up, never imported).  What differs from it: the tracer also
# records while a torch.profiler session runs (``recording()``), exposes
# its clock origin (``origin``), can time a span's work on the card
# (``span(..., device=...)``), tags nested spans with a scope id
# (``scope``), and gives each event the thread's native id.
"""Tracing spans with a near-zero-cost disabled path (DESIGN.md §16).

One ``Tracer`` holds a bounded in-memory buffer of Chrome-trace
"complete" events (``ph: "X"``, microsecond timestamps from the
tracer's ``origin``, a ``time.perf_counter`` reading).  The API is
built so that EVERY production call site stays hot-path-safe when
tracing is off:

* ``span(name, **tags)`` — context manager.  Not recording, it returns
  a shared no-op singleton whose ``__enter__``/``__exit__`` are empty
  methods: no allocation, no clock read.  ``span(name, device=dev,
  **tags)`` also times the span's work on the card: a pair of CUDA
  timing events on the current stream of ``dev`` (a ``torch.device``,
  or True for the current CUDA device), drawn from a pool.  The event
  then carries ``device_ts`` (microseconds from ``origin``, the host
  clock) and ``device_ms`` in ``args``, resolved when ``events()`` or
  ``drain()`` is called; on the CPU both stay absent.  One anchor event
  per device and recording session, recorded on an idle card at a
  known ``perf_counter`` reading, places these intervals on the host
  clock.  A session starts at ``enable()``, ``clear()`` or ``drain()``.
* ``scope(name, key, **tags)`` — a span tagged ``key`` = a fresh id,
  which also tags every span its thread emits while it is open (the
  spans of one serve batch share its ``batch`` id).
* ``timed(name, out, key, **tags)`` — like ``span`` but ALWAYS times
  (one ``perf_counter`` pair) and writes the elapsed seconds into
  ``out[key]``.  This is the migration target for the hand-rolled
  ``timings["stage"] = time.perf_counter() - t0`` pattern in
  ``refresh_index``/``build_index``: the dict consumers keep their
  numbers, and the same measurement becomes a trace event when the
  tracer is recording — one clock, two views.
* ``event(name, t0, t1, **tags)`` — post-hoc emission for intervals
  the caller already measured (per-request lifecycle events derived
  from ``Request.t_sched``/``t_done``).  Not recording, it's one
  attribute check.
* ``capture()`` — while a thread captures a CUDA graph: its device spans
  become a pair of external timing events recorded into the graph
  (event-record nodes) and are listed, not emitted; its host spans
  record nothing.  ``replayed(spans, t0, t1, device)`` emits such spans
  as one replay ran them, once its work is done.

The tracer records while its ``enabled`` flag is set and while a
``torch.profiler`` session runs (torch's own ``_is_profiler_enabled``
flag), so an operator who profiles the process gets the program's spans
without a second switch.

Spans nest per-thread: each thread's open-span depth is tracked so
tests can assert nesting/ordering invariants, and events carry the
thread's native id so chrome://tracing lays concurrent flusher/refresh/
export activity out on separate rows.

A module-level default tracer (``get_tracer()``) is what the library
call sites use; ``serve.py --trace-out`` enables it and drains the
buffer into a Chrome-trace JSON at exit.
"""
from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time

# unresolved device intervals above which a new one first collects the
# finished ones (without waiting), so the event pool stays bounded; high
# enough that a window of a few seconds resolves only when read
_REAP_AT = 8192
# threads capturing a CUDA graph now (``capture``): while none is, a span
# that records nothing costs one more module read
_CAPTURES = 0
_CAPTURE = threading.local()
_CAPTURES_LOCK = threading.Lock()


def _profiling() -> bool:
    """True while a torch.profiler session runs; False where torch was
    never imported."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _card(device):
    """The CUDA device index ``device`` names, or None (a CPU device,
    or True before CUDA was initialised)."""
    if device is True:
        torch = sys.modules.get("torch")
        return (torch.cuda.current_device() if torch is not None
                and torch.cuda.is_initialized() else None)
    if device.type != "cuda":
        return None
    index = device.index
    return index if index is not None \
        else sys.modules["torch"].cuda.current_device()


class _NullSpan:
    """Shared do-nothing context manager — the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records wall-clock bounds on exit and appends a
    Chrome "X" event to its tracer's buffer."""

    __slots__ = ("_tracer", "name", "tags", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, tags: dict):
        self._tracer = tracer
        self.name = name
        self.tags = tags

    def __enter__(self):
        self._depth = self._tracer._enter_depth()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._exit_depth()
        self._tracer._emit(self.name, self._t0, t1, self.tags,
                           self._depth)
        return False


class _DeviceSpan(_Span):
    """A span that also records a CUDA timing event on the current
    stream at each end (the hot path: few Python frames)."""

    __slots__ = ("_dev", "_start", "_end", "_anchor", "_stream")

    def __init__(self, tracer, name, tags, dev: int):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self._dev = dev

    def __enter__(self):
        tr = self._tracer
        self._depth = tr._enter_depth()
        self._t0 = time.perf_counter()
        (self._start, self._end, self._anchor,
         self._stream) = tr._device_begin(self._dev)
        return self

    def __exit__(self, *exc):
        _record(self._end, self._stream)
        t1 = time.perf_counter()
        tr = self._tracer
        tr._exit_depth()
        ev = tr._emit(self.name, self._t0, t1, self.tags, self._depth)
        with tr._lock:
            tr._pending.append((ev, self._start, self._end, self._anchor,
                                self._dev))
        return False


def _record(event, stream) -> None:
    """``event.record(stream)`` without ``torch.cuda.Event``'s Python
    frame."""
    sys.modules["torch"]._C._CudaEventBase.record(event, stream)


class _Scope(_Span):
    """A span whose tags ``key`` = its id also go on every span its
    thread emits while it is open."""

    __slots__ = ("_key", "_outer")

    def __init__(self, tracer, name, tags, key):
        super().__init__(tracer, name, tags)
        self._key = key

    def __enter__(self):
        local = self._tracer._local
        self._outer = getattr(local, "scope", None)
        local.scope = {**(self._outer or {}), self._key: self.tags[self._key]}
        return super().__enter__()

    def __exit__(self, *exc):
        self._tracer._local.scope = self._outer
        return super().__exit__(*exc)


class _GraphSpan:
    """A device span opened while its thread captures a CUDA graph: two
    external timing events recorded on the capturing stream become
    event-record nodes of the graph; (name, tags, start, end) goes to the
    capture's list."""

    __slots__ = ("_spans", "name", "tags", "_start", "_end")

    def __init__(self, spans: list, name: str, tags: dict):
        self._spans = spans
        self.name = name
        self.tags = tags

    def __enter__(self):
        cuda = sys.modules["torch"].cuda
        self._start = cuda.Event(enable_timing=True, external=True)
        self._end = cuda.Event(enable_timing=True, external=True)
        self._start.record()
        return self

    def __exit__(self, *exc):
        self._end.record()
        self._spans.append((self.name, self.tags, self._start, self._end))
        return False


def _captured() -> list | None:
    """The span list of the graph this thread captures, or None."""
    return getattr(_CAPTURE, "spans", None) if _CAPTURES else None


def _open(tracer, name: str, device, tags: dict):
    """A recording span: on a card (``device``, see ``_card``) also its
    device interval.  On a thread that captures a graph, a device span
    on a card is a ``_GraphSpan`` and any other span records nothing."""
    spans = _captured()
    if spans is not None:
        if device is not None and _card(device) is not None:
            return _GraphSpan(spans, name, tags)
        return _NULL_SPAN
    if not (tracer.enabled or _profiling()):
        return _NULL_SPAN
    if device is not None:
        dev = _card(device)
        if dev is not None:
            return _DeviceSpan(tracer, name, tags, dev)
    return _Span(tracer, name, tags)


class _Timed:
    """Always-on timer that doubles as a span: elapsed seconds land in
    ``out[key]`` unconditionally, and in the trace buffer when the
    tracer is recording.  ``.elapsed`` is readable after exit."""

    __slots__ = ("_tracer", "name", "_out", "_key", "tags", "_t0",
                 "_depth", "_rec", "elapsed")

    def __init__(self, tracer, name, out, key, tags):
        self._tracer = tracer
        self.name = name
        self._out = out
        self._key = key
        self.tags = tags
        self.elapsed = 0.0

    def __enter__(self):
        self._rec = self._tracer.recording()
        self._depth = self._tracer._enter_depth() if self._rec else 0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.elapsed = t1 - self._t0
        if self._out is not None:
            self._out[self._key] = self.elapsed
        if self._rec:
            self._tracer._exit_depth()
            self._tracer._emit(self.name, self._t0, t1, self.tags,
                               self._depth)
        return False


class Tracer:
    """Bounded buffer of Chrome-trace events + the span/timed/event
    API.  Disabled by default; ``enable()`` flips one attribute read
    by every call site.  The buffer keeps at most ``max_events``
    (oldest dropped, drop count reported) so a long-lived server can
    leave tracing on without unbounded growth."""

    def __init__(self, *, enabled: bool = False,
                 max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self.dropped = 0
        self._local = threading.local()
        # one fixed origin so every event's ts is a positive offset;
        # ts * 1e-6 + origin is the event's perf_counter reading
        self.origin = time.perf_counter()
        self._ids = itertools.count(1)
        # device intervals: (event, start, end, anchor, device) not yet
        # resolved; free (start, end) event pairs and the anchors, by
        # device index
        self._pending: list[tuple] = []
        self._pool: dict[int, list] = {}
        self._anchors: dict[int, tuple] = {}
        self._streams: dict[int, object] = {}

    def recording(self) -> bool:
        """Whether spans are recorded now: ``enabled``, or a
        torch.profiler session is running."""
        return self.enabled or _profiling()

    # -- depth tracking (per-thread nesting, for tests/ordering) ------
    def _enter_depth(self) -> int:
        d = getattr(self._local, "depth", 0)
        self._local.depth = d + 1
        return d

    def _exit_depth(self) -> None:
        self._local.depth = getattr(self._local, "depth", 1) - 1

    @property
    def depth(self) -> int:
        """Current thread's open-span depth."""
        return getattr(self._local, "depth", 0)

    # -- emission -----------------------------------------------------
    def _emit(self, name, t0, t1, tags, depth) -> dict:
        local = self._local
        scope = getattr(local, "scope", None)
        args = {**scope, **tags} if scope else dict(tags)
        tid = getattr(local, "tid", None)
        if tid is None:
            # a system call: read once a thread
            tid = local.tid = threading.get_native_id()
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0 - self.origin) * 1e6,
            "dur": max(0.0, (t1 - t0) * 1e6),
            "pid": 1,
            "tid": tid,
            "args": args,
        }
        if depth:
            ev["args"]["depth"] = depth
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self.max_events:
                drop = len(self._events) - self.max_events
                del self._events[:drop]
                self.dropped += drop
        return ev

    # -- device intervals ---------------------------------------------
    def _device_begin(self, dev: int) -> tuple:
        """(start, end, anchor, stream) of a new device interval on
        ``dev``, its start event recorded on the current stream."""
        torch = sys.modules["torch"]
        if len(self._pending) >= _REAP_AT:
            self._resolve(wait=False)
        anchor = self._anchors.get(dev)
        if anchor is None:
            anchor = self._anchors[dev] = self._make_anchor(torch, dev)
        try:
            # list.pop is atomic under the interpreter lock
            start, end = self._pool[dev].pop()
        except (KeyError, IndexError):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        # torch.cuda.current_stream builds a Stream object a call: keep
        # one per raw stream
        raw = torch._C._cuda_getCurrentRawStream(dev)
        stream = self._streams.get(raw)
        if stream is None:
            stream = self._streams[raw] = torch.cuda.current_stream(dev)
        _record(start, stream)
        return start, end, anchor, stream

    @staticmethod
    def _make_anchor(torch, dev: int) -> tuple:
        """(event, perf_counter seconds): an event recorded on an idle
        card, and the host time the record returned, which the card
        runs it just after (the quickest of three records; the wait
        that sees it done can return much later)."""
        stream = torch.cuda.current_stream(dev)
        best = None
        for _ in range(3):
            ev = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _record(ev, stream)
            t1 = time.perf_counter()
            if best is None or t1 - t0 < best[0]:
                best = (t1 - t0, ev, t1)
        torch.cuda.synchronize(dev)
        return best[1], best[2]

    def _resolve(self, wait: bool = True) -> None:
        """Write ``device_ts``/``device_ms`` into the pending device
        intervals' events and return their timing events to the pool;
        ``wait=False`` stops at the first interval not yet finished."""
        with self._lock:
            pending, self._pending = self._pending, []
        done = 0
        for ev, start, end, (a_ev, a_t), dev in pending:
            if wait:
                end.synchronize()
            elif not end.query():
                break
            ev["args"]["device_ms"] = start.elapsed_time(end)
            ev["args"]["device_ts"] = ((a_t - self.origin) * 1e6
                                       + a_ev.elapsed_time(start) * 1e3)
            self._pool.setdefault(dev, []).append((start, end))
            done += 1
        if done < len(pending):
            with self._lock:
                self._pending[:0] = pending[done:]

    # -- public API ---------------------------------------------------
    def enable(self, on: bool = True) -> "Tracer":
        self.enabled = on
        if on:
            self._anchors = {}
        return self

    def span(self, name: str, *, device=None, **tags):
        """Context manager; the no-op singleton when not recording.
        ``device`` (a torch.device, or True for the current CUDA
        device) also times the span's work there when it is a card."""
        if not (self.enabled or _profiling() or _CAPTURES):
            return _NULL_SPAN
        return _open(self, name, device, tags)

    def scope(self, name: str, key: str, **tags):
        """A span tagged ``key`` = a fresh id that also tags every span
        its thread emits while it is open; the no-op singleton when not
        recording."""
        if not (self.enabled or _profiling()):
            return _NULL_SPAN
        tags[key] = next(self._ids)
        return _Scope(self, name, tags, key)

    def timed(self, name: str, out: dict | None, key: str, **tags):
        """Context manager that always times into ``out[key]`` and
        additionally traces when recording."""
        return _Timed(self, name, out, key, tags)

    def event(self, name: str, t0: float, t1: float, **tags) -> None:
        """Emit a completed interval measured by the caller (both
        bounds on the ``perf_counter`` clock)."""
        if not (self.enabled or _profiling()):
            return
        self._emit(name, t0, t1, tags, 0)

    def replayed(self, spans: list, t0: float, t1: float,
                 device) -> None:
        """Emit the device spans a graph captured (``capture``) as one
        replay ran them: (name, tags, start, end); host bounds
        ``t0``-``t1`` (the replay's enqueue), ``device_ts``/``device_ms``
        from the events.  Call once the replay's work on the card
        ``device`` (a torch.device) is done and before the graph replays
        again, which overwrites the events."""
        if not spans:
            return
        device = _card(device)
        anchor = self._anchors.get(device)
        if anchor is None:
            anchor = self._anchors[device] = self._make_anchor(
                sys.modules["torch"], device)
        a_ev, a_t = anchor
        depth = self.depth
        for name, tags, start, end in spans:
            args = dict(tags)
            args["device_ms"] = start.elapsed_time(end)
            args["device_ts"] = ((a_t - self.origin) * 1e6
                                 + a_ev.elapsed_time(start) * 1e3)
            self._emit(name, t0, t1, args, depth)

    def events(self) -> list[dict]:
        """Copy of the buffered events (chronological emit order), their
        device intervals resolved (this waits for the card)."""
        self._resolve()
        with self._lock:
            return list(self._events)

    def drain(self) -> list[dict]:
        """Return and clear the buffer (device intervals resolved)."""
        self._resolve()
        self._anchors = {}
        with self._lock:
            out = self._events
            self._events = []
            return out

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._pending = []
            self.dropped = 0
        self._anchors = {}


# Module-level default: library call sites trace through this; it
# records nothing (no-op spans, skipped events) unless a front end —
# serve.py --trace-out, a test — enables it or a torch.profiler
# session runs.
_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    return _DEFAULT


def recording() -> bool:
    """Whether the default tracer records now: ``enabled``, or a
    torch.profiler session is running."""
    return _DEFAULT.enabled or _profiling()


def span(name: str, *, device=None, **tags):
    """Span on the default tracer (the common call-site spelling)."""
    if not (_DEFAULT.enabled or _profiling() or _CAPTURES):
        return _NULL_SPAN
    return _open(_DEFAULT, name, device, tags)


@contextlib.contextmanager
def capture():
    """While open, this thread captures a CUDA graph: yields the list
    its device spans go to (``_GraphSpan``)."""
    global _CAPTURES
    spans: list = []
    outer = getattr(_CAPTURE, "spans", None)
    _CAPTURE.spans = spans
    with _CAPTURES_LOCK:
        _CAPTURES += 1
    try:
        yield spans
    finally:
        with _CAPTURES_LOCK:
            _CAPTURES -= 1
        _CAPTURE.spans = outer


def replayed(spans: list, t0: float, t1: float, device) -> None:
    """``Tracer.replayed`` on the default tracer."""
    _DEFAULT.replayed(spans, t0, t1, device)


def scope(name: str, key: str, **tags):
    """Scope on the default tracer."""
    return _DEFAULT.scope(name, key, **tags)


def timed(name: str, out: dict | None, key: str, **tags):
    """Timed span on the default tracer (always populates ``out``)."""
    return _Timed(_DEFAULT, name, out, key, tags)


def event(name: str, t0: float, t1: float, **tags) -> None:
    if _DEFAULT.enabled or _profiling():
        _DEFAULT._emit(name, t0, t1, tags, 0)
