# Copied from src/repro/perflog.py; keep the two in step.
"""Append-only JSON perf records.

One list-of-dicts file per metric family; every run that is given a
path (``launch/serve.py --json PATH``) appends, so a trajectory stays in
one place.  The port writes no file unless asked: the reference's
``BENCH_serve.json`` is not the port's.  A corrupt or
missing file degrades to an empty history instead of failing the run.

Appends are crash-safe and concurrency-safe: the new history is
written to a temp file in the same directory and swapped in with
``os.replace`` (readers always see a complete JSON — a crash mid-write
can no longer truncate the committed history to ``[]``), and the whole
read-modify-write is serialized through an ``fcntl`` lock on a sidecar
``<path>.lock`` file, so concurrent appenders (live serve loop +
refresh loop, or two processes) compose instead of losing records.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import List

try:
    import fcntl
except ImportError:          # non-POSIX: atomic replace still holds
    fcntl = None


def read_records(path: str) -> List[dict]:
    """Full history at ``path`` ([] on missing/corrupt, same policy as
    append_records)."""
    if not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            out = json.load(f)
        return out if isinstance(out, list) else []
    except (json.JSONDecodeError, OSError):
        return []


def latest(path: str, **filters) -> dict | None:
    """Most recent record whose fields match ``filters`` exactly, e.g.
    ``latest(path, section="refresh", graph="road4000")``.  The serve
    CLI uses it to print the previous record beside a fresh one."""
    for rec in reversed(read_records(path)):
        if all(rec.get(k) == v for k, v in filters.items()):
            return rec
    return None


@contextlib.contextmanager
def _append_lock(path: str):
    """Exclusive advisory lock serializing read-modify-write cycles.
    ``flock`` locks the open file description, so two opens of the
    sidecar — same process or different ones — exclude each other."""
    if fcntl is None:
        yield
        return
    with open(path + ".lock", "a") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def append_records(path: str, records: List[dict]) -> None:
    """Append ``records`` to the history at ``path`` atomically: the
    merged list lands via temp-file + ``os.replace`` under the append
    lock, so neither a crash mid-write nor a concurrent appender can
    corrupt or drop committed history."""
    with _append_lock(path):
        existing = read_records(path)
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(
            prefix="." + os.path.basename(path) + ".", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(existing + records, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
