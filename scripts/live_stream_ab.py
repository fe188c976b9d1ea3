#!/usr/bin/env python3
"""Serving beside refresh on one card: the refresh on the engine's own
CUDA stream (the port's design, ``EpochedEngine.apply_updates``) against
the refresh on the default stream the serving thread launches on, in
turns on one engine.

    python3 scripts/live_stream_ab.py [--turns 3] [--rate 4000]

Builds road4000 (dense) with 256 Zipf-pool hub nodes once, then runs
``serve.live_loop`` (3 s of Zipf traffic at ``--rate`` qps, 3 refresh
rounds of 2% of the edges beside it, 64 responses validated against
their epochs' oracles) ``2 * --turns`` times, alternating which stream
the refresh runs on (side, default, default, side, ...).  Prints each
turn's longest serving gap, p50/p99 latency, achieved qps and mean
refresh seconds, and writes them to ``chiprun_out/live_stream_ab.json``
with the card's name and power limit.  Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--rate", type=float, default=4000.0)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("live_stream_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.launch import serve
    args = serve.parse_args([
        "--nodes", "4000", "--live", "--mix", "zipf", "--rate",
        str(opts.rate), "--live-seconds", "3", "--hub-budget", "256",
        "--live-update-batches", "3", "--update-frac", "0.02",
        "--validate", "64", "--device", "cuda"])
    engine, _summary = serve.build_engine(args)
    side = engine._refresh_stream
    order = ["side", "default", "default", "side"] * opts.turns
    turns = []
    for mode in order[:2 * opts.turns]:
        engine._refresh_stream = side if mode == "side" else None
        live = serve.live_loop(engine, args)
        rec = live["serve_live"]
        if rec["oracle_bad"]:
            raise AssertionError(f"{mode}: {rec['oracle_bad']} mismatches")
        turns.append({"stream": mode, **{k: rec[k] for k in (
            "max_serving_gap_ms", "p50_ms", "p95_ms", "p99_ms",
            "achieved_qps", "refresh_mean_s", "refresh_items",
            "epochs_served")}})
        print(f"turn {len(turns)}: {turns[-1]}", flush=True)
    engine._refresh_stream = side
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "live_stream_ab.json").write_text(json.dumps(
        {"card": smi.stdout.strip(), "turns": turns}, indent=1))
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
