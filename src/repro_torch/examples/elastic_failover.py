"""Fault-tolerance scenario: training survives a simulated node failure
mid-run — checkpoint, shrink the device pool, restore, continue (a copy
of ``examples/elastic_failover.py`` over the port's ``ElasticTrainer``).

    PYTHONPATH=src python -m repro_torch.examples.elastic_failover \\
        [--device cpu]

A tiny float32 LM trains 40 steps with a checkpoint every 10; the
injector fails step 25, the trainer restores step 20 and finishes.
The checkpoints go to a fresh temporary directory (one that already
held a later step would resume there and see no failure).
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import torch

from ..checkpoint import CheckpointManager
from ..core.device_engine import resolve_device
from ..data import lm_batches
from ..launch import steps
from ..models import transformer
from ..models.common import Shardings
from ..optim import adamw_init
from ..runtime import ElasticTrainer, FailureInjector, StragglerMonitor


def main(device: str = "cuda") -> int:
    dev = resolve_device(device)
    cfg = transformer.LMConfig(
        name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, dtype=torch.float32)
    sh = Shardings(mesh=None)
    data = lm_batches(8, 64, cfg.vocab, seed=0)

    def make_mesh(n):
        return None

    def make_step(mesh):
        fn = steps.lm_train_step(cfg, sh, n_micro=1)

        def step(state, batch):
            params, opt = state
            params, opt, metrics = fn(params, opt, batch)
            return (params, opt)
        return step, None

    def init_state(mesh):
        gen = torch.Generator(device=dev).manual_seed(0)
        params = transformer.init_params(cfg, gen, dev)
        return (params, adamw_init(params))

    with tempfile.TemporaryDirectory() as tmp:
        ck = CheckpointManager(tmp, keep=3)
        trainer = ElasticTrainer(ckpt=ck, make_mesh=make_mesh,
                                 make_step=make_step,
                                 init_state=init_state,
                                 checkpoint_every=10, device=dev.type)
        injector = FailureInjector(fail_at_step=25)
        monitor = StragglerMonitor()
        out = trainer.run(40,
                          (torch.from_numpy(b).to(dev) for b in data),
                          injector=injector, monitor=monitor)
    print("run summary:", out)
    print("straggler summary:", monitor.summary())
    assert out["restarts"] == 1 and out["final_step"] == 40, out
    print("elastic failover OK: failed at step 25, resumed from 20, "
          "finished 40")
    return 0


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    return main(device=args.device)


if __name__ == "__main__":
    sys.exit(cli())
