#!/usr/bin/env python3
"""Where the time of one training step goes on the card.

    python3 scripts/torch_train_profile.py [--arch granite-moe-1b-a400m]
        [--batch 1] [--seq 4096] [--steps 3]

Builds the arch at its published dims on ``cuda`` (an LM, or wide-deep
with ``--batch`` samples), runs ``--steps`` warm steps of the port's
train step (in place, as ``launch/train.py`` runs it), then
times, each ending in a synchronise: the forward alone (no grad), the
forward + backward (``steps.value_and_grad``) and the AdamW update; and
profiles one whole step with ``torch.profiler``: device time by kernel,
device busy time and the idle share of the step's wall time.
Prints the card's name and power limit, and writes the record to
``chiprun_out/train_profile_<arch>.json``.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _timed(fn) -> tuple:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batches, recsys_batches
    from repro_torch.launch import steps
    from repro_torch.models import recsys, transformer
    from repro_torch.models.common import Shardings
    from repro_torch.optim import adamw_init, adamw_update

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    spec = get_arch(args.arch)
    cfg, sh = spec.model_cfg, Shardings(mesh=None)
    gen = torch.Generator(device=dev).manual_seed(0)
    if spec.family == "lm":
        params = transformer.init_params(cfg, gen, dev)
        data = (torch.from_numpy(b).to(dev) for b in
                lm_batches(args.batch, args.seq, cfg.vocab, seed=0))

        def loss_fn(p, b):
            return transformer.forward_loss(cfg, sh, p, b)
        step = steps.lm_train_step(cfg, sh, n_micro=1)
        per_step, unit = args.batch * args.seq, "tokens"
    elif spec.family == "recsys":
        params = recsys.init_params(cfg, gen, dev)
        data = ({k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                for b in recsys_batches(args.batch, cfg.n_sparse,
                                        cfg.rows_per_field,
                                        cfg.hots_per_field, seed=0))

        def loss_fn(p, b):
            return recsys.forward_loss(cfg, sh, p, b)
        step = steps.recsys_train_step(cfg, sh)
        per_step, unit = args.batch, "samples"
    else:
        raise SystemExit(f"{args.arch}: only lm and recsys archs")
    opt = adamw_init(params)
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(args.steps):
        batch = next(data)
        (params, opt, m), dt = _timed(lambda: step(params, opt, batch))
        step_s.append(dt)
    batch = next(data)
    with torch.no_grad():
        _, fwd_s = _timed(lambda: loss_fn(params, batch))
    (loss, grads), fwd_bwd_s = _timed(
        lambda: steps.value_and_grad(loss_fn, params, batch))
    _, adamw_s = _timed(lambda: adamw_update(params, grads, opt, lr=3e-4,
                                             donate=True))
    del grads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (params, opt, m), prof_step_s = _timed(
            lambda: step(params, opt, next(data)))
    events = prof.key_averages()

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", 0.0) or 0.0)
    # kernel events only (an op's self device time repeats its kernels')
    kernels = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:args.top]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rec = {
        "arch": args.arch, "batch": args.batch, "seq": args.seq,
        "card": smi, "step_s": step_s,
        "median_step_s": float(np.median(step_s[1:] or step_s)),
        f"{unit}_per_s": per_step / float(np.median(step_s[1:] or step_s)),
        "forward_s": fwd_s, "forward_backward_s": fwd_bwd_s,
        "adamw_s": adamw_s, "profiled_step_s": prof_step_s,
        "device_busy_s": busy_s,
        "idle_share": max(0.0, 1.0 - busy_s / prof_step_s),
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        "top_device": [{"name": e.key[:90], "calls": e.count,
                        "device_ms": dev_us(e) / 1e3} for e in top],
    }
    print(json.dumps({k: v for k, v in rec.items() if k != "top_device"}))
    for t in rec["top_device"]:
        print(f"  {t['device_ms']:10.3f} ms  {t['calls']:6d}  {t['name']}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"train_profile_{args.arch}.json").write_text(
        json.dumps(rec, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
