# Copied from src/repro/obs/export.py (standard library only); keep the two in step.
"""Exporters: Chrome-trace JSONL, periodic metrics snapshots,
Prometheus text over HTTP, and the slow-query log (DESIGN.md §16).

The trace file is the Chrome Trace Event Format's JSON-array form
written one event per line — chrome://tracing and Perfetto load it
directly (the format explicitly tolerates the trailing comma and a
missing ``]``), and line-oriented tools can stream it.  Metrics
snapshots are atomic (temp file + ``os.replace``), so a scraper never
reads a half-written JSON.  The ``SlowQueryLog`` keeps the worst-N
requests by latency with their span breakdown — bounded memory, O(log
N) per offer via a min-heap keyed on latency.
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile
import threading
import time


# -- Chrome trace -----------------------------------------------------

def write_chrome_trace(path: str, events: list[dict]) -> None:
    """Write events as a Chrome-trace JSON array, one event per line
    (loadable by chrome://tracing AND greppable/streamable)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".trace.", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            f.write("[\n")
            for ev in events:
                f.write(json.dumps(ev, separators=(",", ":")) + ",\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_chrome_trace(path: str) -> list[dict]:
    """Load a trace written by ``write_chrome_trace`` (or any Chrome
    trace array, complete or trailing-comma-truncated)."""
    with open(path) as f:
        text = f.read().strip()
    if not text.startswith("["):
        raise ValueError(f"{path}: not a Chrome trace array")
    body = text[1:].rstrip().rstrip(",").rstrip()
    if body.endswith("]"):
        body = body[:-1].rstrip().rstrip(",")
    if not body:
        return []
    return json.loads(f"[{body}]")


# -- metrics snapshots ------------------------------------------------

def _atomic_write_text(path: str, text: str) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".metrics.", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_snapshot(path: str, registry, extra: dict | None = None) \
        -> dict:
    """One atomic metrics-snapshot write: ``{path}`` gets the JSON
    dump (registry snapshot + ``extra``), ``{path_base}.prom`` the
    Prometheus text exposition.  Returns the snapshot dict."""
    snap = {"unix_time": time.time(), "metrics": registry.snapshot()}
    if extra:
        snap.update(extra)
    _atomic_write_text(path, json.dumps(snap, indent=1))
    base, _ext = os.path.splitext(path)
    _atomic_write_text(base + ".prom", registry.prometheus())
    return snap


class MetricsExporter:
    """Daemon thread writing a metrics snapshot every ``interval_s``;
    ``stop()`` writes one final snapshot so short runs always leave a
    complete file.  ``extra`` is an optional callable returning a dict
    merged into each snapshot (slow-query log, run metadata)."""

    def __init__(self, registry, path: str, *,
                 interval_s: float = 2.0, extra=None):
        self.registry = registry
        self.path = path
        self.interval_s = interval_s
        self._extra = extra
        self._stop = threading.Event()
        self.writes = 0
        self._thread = threading.Thread(target=self._run,
                                        name="metrics-exporter",
                                        daemon=True)

    def start(self) -> "MetricsExporter":
        self._thread.start()
        return self

    def _write(self) -> None:
        extra = self._extra() if self._extra is not None else None
        write_snapshot(self.path, self.registry, extra)
        self.writes += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._write()


class MetricsServer:
    """Minimal stdlib HTTP endpoint: ``GET /metrics`` serves the
    Prometheus text exposition, anything else the JSON snapshot.
    Binds 127.0.0.1:``port`` (port 0 picks a free one — read
    ``.port`` after start)."""

    def __init__(self, registry, port: int = 0):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):           # noqa: N802 (stdlib API name)
                if self.path.startswith("/metrics"):
                    body = reg.prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    body = json.dumps(
                        {"metrics": reg.snapshot()}, indent=1).encode()
                    ctype = "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # quiet
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10.0)


# -- slow-query log ---------------------------------------------------

class SlowQueryLog:
    """Worst-N requests by latency, with their serve breakdown.

    ``offer`` is called once per resolved request (flusher thread);
    a min-heap on latency keeps exactly the N worst in O(log N) per
    offer and O(N) memory.  ``records()`` returns them slowest-first,
    JSON-safe — surfaced in metrics snapshots and printed by
    ``serve.py --live``.
    """

    def __init__(self, n: int = 16):
        self.n = max(1, int(n))
        self._lock = threading.Lock()
        self._heap: list[tuple[float, int, dict]] = []
        self._seq = 0
        self.offered = 0

    def offer(self, latency_s: float, detail: dict) -> None:
        with self._lock:
            self.offered += 1
            self._seq += 1
            item = (float(latency_s), self._seq, detail)
            if len(self._heap) < self.n:
                heapq.heappush(self._heap, item)
            elif item[0] > self._heap[0][0]:
                heapq.heapreplace(self._heap, item)

    def records(self) -> list[dict]:
        with self._lock:
            worst = sorted(self._heap, reverse=True)
        return [{"latency_ms": round(lat * 1e3, 3), **detail}
                for lat, _seq, detail in worst]
