"""CUDA graphs of the query planner's bucket programs.

A planner bucket runs one serve program (``device_engine.serve_*``) at
one padded size.  On a hierarchical index a cross bucket issues ~90
launches (at 4 grouping levels, 71 torch ops and 9 kernel entries), and
at a batch of 1,024 the host takes longer to issue them than the card
takes to run them.  ``BucketGraph`` captures one program at one size
once, into a CUDA graph whose static input is the padded (s, t) pair
``st`` [2, size] and whose outputs are the graph's own tensors, and
replays it for every bucket of that shape.  ``GraphSet`` holds one
index epoch's graphs: one memory pool, one stream (the planner's), keyed
(kind, case, size), kind "d" for the distance programs and "w" for the
witness ones.  The planner (``dist_engine.QueryPlanner``) keys the sets
by the index object, as it keys its host maps.

Graphs of one set share their pool, so a replay may write over another
graph's intermediates, never over a graph's outputs.  A graph copies its
input in from pinned host memory and its outputs out to pinned host
memory itself, in stream order, so a batch issues one replay a bucket
(``BucketGraph.launch``) and waits once (``GraphSet.wait``).

Kernel 2 (``ops.minplus_twoside_grouped``) is not captured: the programs
call it through ``host_call``, which ends the segment being captured,
runs the call, and opens the next segment, so a replay runs the
segments with the call between them, from Python.  Every call of that
entry therefore stays observable with its operands, as it is on the
eager path (the benchmark's roofline reader matches them to the trace's
launches).  While the tracer records, a replay hands the call copies of
the operands that live in the graph's pool (one copy a base tensor),
which the next replay overwrites; the index's own tensors are passed as
they are.

What a capture cannot hold: a host read of a card value (``.item()``,
``nonzero``, a boolean mask); the serve programs make none.  Device
spans opened while capturing (``trace.span(..., device=...)``) become
event-record nodes of the graph (``trace.capture``), listed in
``BucketGraph.spans`` for the tracer to emit after each replay
(``trace.replayed``).

A capture launches nothing, so the kernel wrappers it calls count their
calls in the graph's tally (``_build.tally``), not in their
``.launches``; each replay adds the tally to the wrappers' counts, and
kernel 2's calls count themselves.  A wrapper's ``.launches`` thus
counts the kernels the card ran, replays included.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from ..kernels import _build
from ..obs import trace

_LOCAL = threading.local()


def new_stream(device: torch.device):
    """The stream a planner captures and replays its graphs on: a new
    CUDA stream on a card, None elsewhere (no graphs)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def host_call(owner, name: str):
    """The function ``getattr(owner, name)``, to be called at once, and
    kept outside the graph this thread is capturing (if any): there the
    capture's segment ends, the call runs (on real values: the segments
    before it are replayed first), and a new segment begins; each replay
    calls ``getattr(owner, name)`` again, looked up anew, between the same
    two segments.  The call must return one tensor."""
    graph = getattr(_LOCAL, "graph", None)
    if graph is None:
        return getattr(owner, name)
    return lambda *args, **kwargs: graph._step(owner, name, args, kwargs)


def _index_storage(dix) -> frozenset:
    """The data pointers of every tensor of the index ``dix`` (a
    dataclass whose fields are tensors or tuples of them)."""
    out = set()
    for f in dataclasses.fields(dix):
        val = getattr(dix, f.name)
        for x in val if isinstance(val, (tuple, list)) else (val,):
            if isinstance(x, torch.Tensor):
                out.add(x.untyped_storage().data_ptr())
    return frozenset(out)


class BucketGraph:
    """``fn(dix, s, t)`` at one padded size, captured into one or more
    CUDA graph segments with a ``host_call`` between each two; the copy
    of the pinned input ``host_in`` into the static input ``st`` opens
    the first segment, and the copies of the outputs ``outs`` (a tuple)
    into their pinned host buffers ``host_out`` close the last (numpy
    views: ``host_in_np``, ``host_out_np``).  ``spans`` lists the
    captured device spans, (name, tags, start, end), their events as the
    last replay left them (read once it is done).  Capture and replay
    run on ``stream``."""

    def __init__(self, fn, dix, size: int, *, pool, stream,
                 index_storage: frozenset):
        self.size = size
        self.stream = stream
        self._pool = pool
        self._index = index_storage
        self._segments: list = []
        self._steps: list = []
        self._cur = None
        # per segment {kernel wrapper: its calls there}
        self._launched: list = []
        with torch.cuda.stream(stream):
            # zeros: node 0 twice, a valid query for the real run that
            # each host_call makes during the capture
            self.st = torch.zeros((2, size), dtype=torch.int64,
                                  device=dix.device)
            self.host_in = torch.zeros((2, size), dtype=torch.int64,
                                       pin_memory=True)
            # one eager run gives the outputs' shapes and types, for
            # host buffers allocated before the capture
            out = fn(dix, self.st[0], self.st[1])
            self.host_out = tuple(
                torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in (out if isinstance(out, tuple) else (out,)))
            del out
            _LOCAL.graph = self
            try:
                with trace.capture() as spans:
                    self._begin()
                    self.st.copy_(self.host_in, non_blocking=True)
                    out = fn(dix, self.st[0], self.st[1])
                    self.outs = out if isinstance(out, tuple) else (out,)
                    for h, o in zip(self.host_out, self.outs):
                        h.copy_(o, non_blocking=True)
                    self.spans = spans
                    self._end()
            except BaseException:
                if self._cur is not None:
                    try:
                        self._cur.capture_end()
                    except RuntimeError:
                        pass
                raise
            finally:
                _build.tally(None)
                _LOCAL.graph = None
        self.host_in_np = self.host_in.numpy()
        self.host_out_np = tuple(h.numpy() for h in self.host_out)

    def _begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self._pool, capture_error_mode="thread_local")
        self._cur = g
        self._launched.append({})
        _build.tally(self._launched[-1])

    def _end(self) -> None:
        _build.tally(None)
        g, self._cur = self._cur, None
        g.capture_end()
        self._segments.append(g)

    def _step(self, owner, name, args, kwargs):
        """``host_call`` while capturing: close the segment, run it and
        the call for real, open the next one."""
        self._end()
        self._replay(-1)
        out = getattr(owner, name)(*args, **kwargs)
        owned = tuple(isinstance(a, torch.Tensor)
                      and a.untyped_storage().data_ptr() not in self._index
                      for a in args)
        self._steps.append((owner, name, args, kwargs, owned, out))
        self._begin()
        return out

    def launch(self) -> None:
        """Replay on the graph's stream, none of it waited for: each
        segment (the staged ``host_in`` in first, the outputs out to
        ``host_out`` last), and between them the host calls, whose
        results land where the capture's did; the kernel wrappers'
        counts go up by the segments' launches.  The outputs are on the
        host once the stream is waited for."""
        copies = trace.recording()
        with torch.cuda.stream(self.stream):
            for i, step in enumerate(self._steps):
                owner, name, args, kwargs, owned, out = step
                self._replay(i)
                if copies:
                    args = _fresh(args, owned)
                out.copy_(getattr(owner, name)(*args, **kwargs))
            self._replay(-1)

    def _replay(self, i: int) -> None:
        """Replay segment ``i``, its launches counted."""
        self._segments[i].replay()
        for wrapper, n in self._launched[i].items():
            wrapper.launches += n


def _fresh(args: tuple, owned: tuple) -> tuple:
    """``args`` with each ``owned`` tensor replaced by the same view of a
    copy of its base tensor (one copy a base)."""
    copies: dict = {}
    out = []
    for a, own in zip(args, owned):
        if own:
            base = a if a._base is None else a._base
            c = copies.get(id(base))
            if c is None:
                c = copies[id(base)] = base.clone()
            a = c.as_strided(a.size(), a.stride(),
                             a.storage_offset() - base.storage_offset())
        out.append(a)
    return tuple(out)


class GraphSet:
    """One index epoch's bucket graphs: ``graphs`` {(kind, case, size):
    BucketGraph}, one memory pool, captured and replayed on ``stream``
    (one thread at a time: the planner's lock)."""

    def __init__(self, dix, stream):
        self.dix = dix
        self.stream = stream
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict = {}
        self._index = _index_storage(dix)

    def capture(self, key: tuple, fn) -> BucketGraph:
        """Capture ``fn`` at ``key``'s size (its last entry) and keep it
        under ``key``."""
        bg = self.graphs[key] = BucketGraph(
            fn, self.dix, key[-1], pool=self.pool, stream=self.stream,
            index_storage=self._index)
        return bg

    def wait(self) -> None:
        """Wait for every replay and copy issued on the stream."""
        self.stream.synchronize()
