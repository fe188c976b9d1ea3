"""End-to-end training driver: data pipeline, train steps,
checkpoint/restart, straggler monitoring.

Port of ``repro/launch/train.py``, with its flags plus ``--device``
(default ``cuda``; ``--device cpu`` runs on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --steps 50 --reduced --ckpt DIR

--reduced shrinks the arch to a CPU-trainable size (same code path:
layer loop, grad accumulation, AdamW).  Without it the arch trains at
its published dims.  The checkpointed state is ``(params, opt)`` in the
reference's leaf order, so a run of either package resumes the other's
float32 checkpoints (and the port reads bf16 ones by their bits).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_arch
from ..core.device_engine import resolve_device
from ..data import gnn_full_batch, lm_batches, recsys_batches
from ..models import gnn, recsys, transformer
from ..models.common import Shardings
from ..optim import adamw_init
from ..runtime import StragglerMonitor
from .mesh import make_host_mesh
from . import steps


def reduced_lm(cfg: transformer.LMConfig) -> transformer.LMConfig:
    return dataclasses.replace(
        cfg, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, n_experts=min(cfg.n_experts, 4) if cfg.moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0, dtype=torch.float32)


def reduced_gnn(cfg: gnn.GNNConfig) -> gnn.GNNConfig:
    return dataclasses.replace(cfg, n_layers=2, d_hidden=32, d_feat=16,
                               n_out=min(cfg.n_out, 4))


def reduced_recsys(cfg: recsys.RecsysConfig) -> recsys.RecsysConfig:
    return dataclasses.replace(cfg, rows_per_field=1000, n_sparse=8,
                               mlp_dims=(64, 32))


def _on(dev, batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in batch.items()}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    # parsed as the reference parses it; its steps train at their own
    # lr (3e-4), and so do the port's
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    """Run the driver; returns the run's losses, grad norms, step and
    checkpoint-save seconds and final ``(params, opt)`` for callers
    in-process."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    mesh = make_host_mesh(device=dev.type)
    sh = Shardings(mesh=mesh)
    monitor = StragglerMonitor()
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    if spec.family == "lm":
        cfg = reduced_lm(spec.model_cfg) if args.reduced else spec.model_cfg
        params = transformer.init_params(cfg, gen, dev)
        step_fn = steps.lm_train_step(cfg, sh, n_micro=1)
        data = lm_batches(args.batch, args.seq, cfg.vocab, seed=args.seed)
        batches = (torch.from_numpy(b).to(dev) for b in data)
    elif spec.family == "gnn":
        cfg = reduced_gnn(spec.model_cfg) if args.reduced else spec.model_cfg
        params = gnn.init_params(cfg, gen, dev)
        step_fn = steps.gnn_train_step(cfg, sh)
        from ..core.graph import road_like
        g = road_like(512, seed=args.seed)
        batch = _on(dev, gnn_full_batch(g, cfg.d_feat, cfg.n_classes,
                                        seed=args.seed, n_out=cfg.n_out))
        batches = iter(lambda: batch, None)
    else:
        cfg = (reduced_recsys(spec.model_cfg) if args.reduced
               else spec.model_cfg)
        params = recsys.init_params(cfg, gen, dev)
        step_fn = steps.recsys_train_step(cfg, sh)
        data = recsys_batches(args.batch, cfg.n_sparse,
                              cfg.rows_per_field, cfg.hots_per_field,
                              seed=args.seed)
        batches = (_on(dev, b) for b in data)

    opt = adamw_init(params)
    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    start = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        start, (params, opt) = ckpt.restore((params, opt))
        print(f"restored step {start}")

    losses, gnorms, save_s = [], [], []

    def save(step):
        t0 = time.perf_counter()
        ckpt.save(step, (params, opt))
        save_s.append(time.perf_counter() - t0)

    for step in range(start, args.steps):
        batch = next(batches)
        monitor.start()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])          # waits for the device
        monitor.stop()
        losses.append(loss)
        gnorms.append(float(metrics["grad_norm"]))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {gnorms[-1]:.3f}", flush=True)
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    # the reference saves the last step again even when the loop just
    # did; the port skips that second copy of the same state
    if ckpt is not None and ckpt.latest_step() != args.steps:
        save(args.steps)
    print("straggler summary:", monitor.summary())
    if dev.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
        if not math.isfinite(losses[-1]):
            raise FloatingPointError("training diverged")
    return {"start": start, "losses": losses, "grad_norms": gnorms,
            "step_s": list(monitor.times), "save_s": save_s,
            "params": params, "opt": opt}


if __name__ == "__main__":
    main()
