#!/usr/bin/env python3
"""Pick the k-block width of the blocked witness Floyd-Warshall.

    PYTHONPATH=src python3 scripts/fw_blocked_tune.py [--blocks 32 64]

Needs one NVIDIA card and ``nvcc``.  Builds ``csrc/fw_next.cu`` once per
width (``-DFWB_B=<B>``, otherwise the port's own flags) into the
git-ignored build directory, then at the shapes of the main path times
each width's ``fw_next_blocked`` with CUDA events, after checking dist
and nxt array-equal to the plain version.  Prints one JSON line per
case, the ptxas report of each build, and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = ((1, 4613), (6, 1024), (130, 496), (3, 1024), (36, 128))


def _build(block: int) -> ctypes.CDLL:
    from repro_torch.kernels import _build as b
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = b.BUILD_DIR / f"fw_next-tune-B{block}.so"
    cmd = [b.nvcc(), *b.NVCC_FLAGS, f"-DFWB_B={block}", "-o", str(out),
           str(b.CSRC / "fw_next.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "ptxas" in line:
            print(f"  ptxas B={block}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    vp = ctypes.c_void_p
    lib.fw_next_blocked.argtypes = [vp, vp, vp, vp, ctypes.c_int,
                                    ctypes.c_int, vp]
    lib.fw_next_blocked.restype = ctypes.c_int
    lib.fw_next_blocked_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fw_next_blocked_scratch.restype = ctypes.c_size_t
    return lib


def _run(lib, d):
    import torch
    b, n = d.shape[0], d.shape[1]
    dist = torch.empty_like(d)
    nxt = torch.empty(d.shape, dtype=torch.int32, device=d.device)
    scratch = torch.empty(lib.fw_next_blocked_scratch(b, n),
                          dtype=torch.uint8, device=d.device)
    err = lib.fw_next_blocked(d.data_ptr(), dist.data_ptr(), nxt.data_ptr(),
                              scratch.data_ptr(), b, n,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fw_next_blocked: CUDA error {err}")
    return dist, nxt


def _ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, nargs="+", default=[32, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fw_blocked_tune: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ref
    libs = {blk: _build(blk) for blk in args.blocks}
    for b, n in SHAPES:
        rng = np.random.default_rng(b * 7919 + n)
        x = rng.integers(0, 100, (b, n, n)).astype(np.float32)
        x[rng.random(x.shape) < 0.2] = np.inf
        d = torch.from_numpy(x).cuda()
        want = ref.fw_batch_next_ref(d)
        rec = {"b": b, "n": n}
        reps = 2 if b * n * n > 4_000_000 else 10
        for blk, lib in libs.items():
            got = _run(lib, d)
            rec[f"equal_B{blk}"] = bool(torch.equal(got[0], want[0])
                                        and torch.equal(got[1], want[1]))
            rec[f"ms_B{blk}"] = _ms(lambda: _run(lib, d), reps)
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
