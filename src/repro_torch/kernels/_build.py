"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``csrc/build/<name>-<hash>.so`` (the directory is git-ignored) the
first time a kernel of it is used; the hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds and a stale library is never loaded.  ``build`` starts
one ``nvcc`` per missing library, all at once, and waits for them.
Nothing here runs at import time: the CPU path and the tests never
touch ``nvcc``.  ``load`` holds one lock over its check, build and
load, so threads that first use a library at once (a serving flusher
beside a refresh thread) build and load it once.

The flags hold the exactness contract: no ``--use_fast_math``, so adds
stay plain IEEE adds and ``inf`` stays ``inf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("fw_next", "minplus_twoside", "fw_dist", "minplus",
           "minplus_twoside_argmin", "label_merge", "gather_minplus")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def lib_path(name: str) -> Path:
    """Where ``name``'s library lands for the current source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    per source, all started together.  Returns seconds per source built
    (the compiler's ``-Xptxas=-v`` report goes to ``<lib>.log``).
    Raises ``RuntimeError`` with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        # named by process and thread: two threads of one process share
        # a pid, and each nvcc needs an output file of its own
        tmp = out.with_suffix(
            f".tmp{os.getpid()}-{threading.get_ident()}.so")
        procs[name] = (out, tmp, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    took = {}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use,
    once per process whichever threads ask for it."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
