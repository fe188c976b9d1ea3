"""The traced run's readings: the benchmark's own host spans around its
calls into the program, and the profiler's record of the card.

``Spans`` keeps (name, start, end) on the host clock (``perf_counter``)
from any thread.  ``DeviceTrace`` runs ``torch.profiler`` over CUDA
activity only, writes the trace as JSON into the git-ignored
``bench/out/traces/``, and reads back every device operation (kernels,
copies, sets) as an interval on the host clock: a ``cudaDeviceSynchronize``
made at a known host time checks how well the trace's wall clock was tied
to ``perf_counter``.
"""
from __future__ import annotations

import functools
import json
import re
import threading
import time
from pathlib import Path

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host-clock spans of the benchmark's calls into the program."""

    def __init__(self):
        self.items: list = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.items.append((name, t0, t1))

    def wrap(self, name: str, fn):
        """``fn`` with each call recorded as a span called ``name``."""
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, t0, time.perf_counter())
        return spanned

    def seconds(self, name: str, lo: float = float("-inf"),
                hi: float = float("inf")) -> float:
        return sum(b - a for n, a, b in self.items
                   if n == name and a >= lo and b <= hi)

    def label(self, t: float) -> str:
        """The innermost span open at host time ``t`` (the latest to
        start of those that hold it), or "outside spans"."""
        best = None
        for n, a, b in self.items:
            if a <= t <= b and (best is None or a > best[1]):
                best = (n, a)
        return best[0] if best else "outside spans"


def base_name(kernel: str) -> str:
    """A kernel's name without its return type, arguments and template
    arguments: ``void at::native::foo<float>(int)`` -> ``at::native::foo``."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    depth = 0
    out = []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()


def _skip_parens(text: str, i: int) -> int:
    """The index just past the parenthesised group opening at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == "(":
            depth += 1
        elif text[j] == ")":
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


_WORD = re.compile(r"\s*(\w+)\s*")


def cuda_kernel_names(source: str) -> list:
    """The name of each ``__global__`` function of CUDA source text, in
    order: after ``__global__``, the return type and any ``__attr__(...)``
    (arguments nested to any depth) are skipped, and the first other word
    followed by ``(`` is the name."""
    names = []
    for m in re.finditer(r"\b__global__\b", source):
        i = m.end()
        while True:
            w = _WORD.match(source, i)
            if w is None:
                break
            i = w.end()
            word = w.group(1)
            if i < len(source) and source[i] == "(":
                if word.startswith("__") and word.endswith("__"):
                    i = _skip_parens(source, i)
                    continue
                names.append(word)
                break
    return names


def triton_kernel_names(source: str) -> list:
    """The name of each ``@triton.jit`` function of Python source text."""
    return re.findall(r"@triton\.jit\b[^\n]*\n(?:\s*@[^\n]*\n)*"
                      r"\s*def\s+(\w+)", source)


def port_kernel_names(pkg: Path) -> set:
    """The names of the program's hand-written kernels: every
    ``__global__`` function of the CUDA sources and every ``@triton.jit``
    function of the Python sources under its package directory."""
    names = set()
    for src in sorted(pkg.rglob("*.cu")) + sorted(pkg.rglob("*.cuh")):
        names.update(cuda_kernel_names(src.read_text()))
    for src in sorted(pkg.rglob("*.py")):
        text = src.read_text()
        if "triton" in text:
            names.update(triton_kernel_names(text))
    return names


class DeviceTrace:
    """``torch.profiler`` over CUDA activity for one traced window."""

    def __init__(self, out_path: Path):
        self.out_path = out_path
        self._prof = None
        self.t_start = self.t_stop = None
        self._anchor = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        # the anchor: a synchronise of an idle card at a known host time,
        # and the wall clock against the host clock beside it
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self._anchor = (t0, t1, time.time() - time.perf_counter())

    def mark_start(self) -> None:
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self._prof is None or self.t_stop is not None:
            return
        self.t_stop = time.perf_counter()
        torch.cuda.synchronize()
        self._prof.stop()

    def read(self) -> dict:
        """-> {"ops": [(name, cat, start, end)] on the host clock, sorted by
        start, "t_start", "t_stop", "anchor_error_s"}; ops cover the
        traced window only."""
        self.out_path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.out_path))
        with open(self.out_path) as f:
            events = json.load(f)
        base_us = events.get("baseTimeNanoseconds", 0) / 1e3 \
            if isinstance(events, dict) else 0.0
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        a0, a1, wall = self._anchor
        # trace time (wall-clock microseconds) -> host clock seconds
        offset = (base_us * 1e-6 - wall) if base_us else -wall
        syncs = [e["ts"] * 1e-6 + offset for e in events
                 if e.get("ph") == "X"
                 and e.get("name") == "cudaDeviceSynchronize"]
        # how far the nearest traced synchronise lies from the anchor's
        err = min((max(a0 - t, t - a1, 0.0) for t in syncs), default=None)
        ops = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = e["ts"] * 1e-6 + offset
            ops.append((e.get("name", ""), e["cat"], a,
                        a + e.get("dur", 0.0) * 1e-6))
        ops.sort(key=lambda o: o[2])
        self.counts = {"events": len(events), "device_ops": len(ops),
                       "syncs": len(syncs), "anchor_error_s": err}
        lo, hi = self.t_start, self.t_stop
        ops = [o for o in ops if o[3] > lo and o[2] < hi]
        return {"ops": ops, "t_start": lo, "t_stop": hi,
                "anchor_error_s": err, "counts": self.counts}


def summarise(trace: dict, spans: Spans, port_names: set) -> dict:
    """busy and idle seconds of the traced window, device seconds by
    kernel, the port's and torch's kernel seconds, and the breakdown."""
    lo, hi = trace["t_start"], trace["t_stop"]
    ops = trace["ops"]
    iv = [(a, b) for _n, _c, a, b in ops]
    busy = stats.union_seconds(iv, lo, hi)
    by_name: dict = {}
    port_s = torch_s = 0.0
    for name, cat, a, b in ops:
        d = min(b, hi) - max(a, lo)
        key = base_name(name) if cat == "kernel" else cat
        by_name[key] = by_name.get(key, 0.0) + d
        if cat == "kernel":
            if base_name(name) in port_names:
                port_s += d
            else:
                torch_s += d
    gaps = stats.idle_gaps(iv, lo, hi)[:10]
    return {
        "busy_s": busy, "window_s": hi - lo,
        "port_kernel_s": port_s, "torch_kernel_s": torch_s,
        "by_name": by_name,
        "breakdown": {
            "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[spans.label((a + b) / 2), b - a]
                          for a, b in gaps]},
    }
