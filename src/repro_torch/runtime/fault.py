"""Fault tolerance: straggler detection, failure injection, elastic
restart (checkpoint -> smaller mesh -> restore -> resume).

Port of ``repro/runtime/fault.py``.  ``SimulatedNodeFailure``,
``FailureInjector`` and ``StragglerMonitor`` are copies (standard
library and numpy only); ``ElasticTrainer`` takes its device count from
the port's mesh kind (the visible cards, or a CPU mesh of a given size
as ``launch.mesh.make_host_mesh`` builds it) and restores through the
port's ``CheckpointManager``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager


# copied from src/repro/runtime/fault.py:22
class SimulatedNodeFailure(RuntimeError):
    pass


# copied from src/repro/runtime/fault.py:26
@dataclasses.dataclass
class FailureInjector:
    fail_at_step: Optional[int] = None
    failed: bool = False

    def check(self, step: int) -> None:
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not self.failed):
            self.failed = True
            raise SimulatedNodeFailure(f"node lost at step {step}")


# copied from src/repro/runtime/fault.py:38
class StragglerMonitor:
    """Tracks per-step wall time; flags outliers > k x running median.

    On a real fleet the flagged ranks feed the backup-task policy
    (re-dispatch the step's shard elsewhere); here the monitor is the
    observability piece and is unit-tested on synthetic timings."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.window = window
        self.times: List[float] = []
        self.flagged: List[int] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        """Record a step duration; True if it is a straggler step."""
        hist = self.times[-self.window:]
        is_straggler = (len(hist) >= 8
                        and dt > self.factor * float(np.median(hist)))
        self.times.append(dt)
        if is_straggler:
            self.flagged.append(len(self.times) - 1)
        return is_straggler

    def summary(self) -> dict:
        arr = np.array(self.times) if self.times else np.zeros(1)
        return {"steps": len(self.times), "median_s": float(np.median(arr)),
                "p99_s": float(np.percentile(arr, 99)),
                "stragglers": len(self.flagged)}


def device_count(device: str = "cuda", cpu_devices: int = 1) -> int:
    """The devices a mesh of kind ``device`` can hold: every visible
    card (raises when there is none), or ``cpu_devices`` repeated CPU
    devices."""
    kind = torch.device(device).type
    if kind == "cpu":
        return cpu_devices
    if kind != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' for a CPU mesh")
    return torch.cuda.device_count()


@dataclasses.dataclass
class ElasticTrainer:
    """Checkpoint/restart loop with elastic re-meshing.

    make_mesh(n_devices) -> mesh; make_step(mesh) -> (step_fn, _) (the
    second item, the reference's state shardings, is not used: restored
    leaves land on the devices of ``init_state(mesh)``'s leaves); the
    trainer catches SimulatedNodeFailure, halves the device pool,
    rebuilds everything and restores the newest checkpoint.  ``device``
    and ``cpu_devices`` give the pool it starts from (``device_count``).
    """
    ckpt: CheckpointManager
    make_mesh: Callable[[int], Any]
    make_step: Callable[[Any], tuple]
    init_state: Callable[[Any], Any]
    checkpoint_every: int = 10
    device: str = "cuda"
    cpu_devices: int = 1

    def _rebuild(self, n_dev: int):
        mesh = self.make_mesh(n_dev)
        step_fn, _ = self.make_step(mesh)
        return step_fn, self.init_state(mesh)

    def run(self, n_steps: int, batches, *,
            injector: Optional[FailureInjector] = None,
            monitor: Optional[StragglerMonitor] = None) -> dict:
        n_dev = device_count(self.device, self.cpu_devices)
        step_fn, state = self._rebuild(n_dev)
        start = 0
        if self.ckpt.latest_step() is not None:
            start, state = self.ckpt.restore(state)
        restarts = 0
        step = start
        while step < n_steps:
            batch = next(batches)
            try:
                if injector is not None:
                    injector.check(step)
                if monitor is not None:
                    monitor.start()
                state = step_fn(state, batch)
                if monitor is not None:
                    monitor.stop()
                step += 1
                if step % self.checkpoint_every == 0:
                    self.ckpt.save(step, state)
            except SimulatedNodeFailure:
                restarts += 1
                n_dev = max(1, n_dev // 2)     # lost a slice: shrink
                step_fn, state = self._rebuild(n_dev)
                if self.ckpt.latest_step() is not None:
                    step, state = self.ckpt.restore(state)
                else:
                    step = 0
        self.ckpt.save(step, state)
        return {"final_step": step, "restarts": restarts,
                "devices": n_dev}
