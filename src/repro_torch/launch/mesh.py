"""Device meshes of the port.

Port of ``repro/launch/mesh.py:make_host_mesh``.  A ``Mesh`` is the
port's counterpart of a JAX mesh on one controller: a tuple of
``torch.device``s laid out row-major over ``shape``, with a name per
axis.  ``core.dist_engine``'s sharded functions split a batch over the
devices along some axes and run each part on its device.  One device may
appear more than once (``make_host_mesh(device="cpu")``, or a mesh of one
card repeated): the shards that share a device run one after another on
it, on its current stream.

``make_production_mesh`` (the 16 x 16 TPU pods of the training
scaffolding) is not ported.  Nothing here touches the card when the
module is imported.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` row-major over ``shape``; ``axis_names`` one per
    axis."""

    devices: tuple
    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(_canonical(d) for d in self.devices))
        object.__setattr__(self, "shape", tuple(int(x) for x in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.shape}")

    def shard_devices(self, axes) -> tuple:
        """The device of each shard of a batch split over ``axes`` (in
        that order, the first slowest), as ``PartitionSpec(axes)`` lays
        it out: shard i runs where the other axes' coordinates are 0 (a
        JAX mesh repeats it along those axes; one copy is enough)."""
        axes = tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of "
                             f"{self.axis_names}")
        grid = np.arange(len(self.devices)).reshape(self.shape)
        index = tuple(slice(None) if a in axes else 0
                      for a in self.axis_names)
        kept = [a for a in self.axis_names if a in axes]
        order = [kept.index(a) for a in axes]
        return tuple(self.devices[i]
                     for i in grid[index].transpose(order).reshape(-1))


def make_host_mesh(shape=None, axes=("data", "model"), *,
                   device="cuda") -> Mesh:
    """Small mesh over the visible devices (tests, smoke runs, the serve
    CLI).  On ``cuda``: cards 0..prod(shape)-1, default every visible
    card as shape (n, 1), or (n,) on one axis; raises when there is no
    card or ``shape`` asks for more cards than exist (as
    ``jax.make_mesh`` raises).  On ``cpu``: the CPU device repeated
    prod(shape) times (default one), the port's counterpart of the
    reference tests' ``--xla_force_host_platform_device_count``."""
    kind = torch.device(device)
    if kind.index is not None or kind.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if kind.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the mesh; "
                               "pass device='cpu' for a CPU mesh")
        n = torch.cuda.device_count()
    else:
        n = 1
    if shape is None:
        shape = (n, 1) if len(axes) == 2 else (n,)
    count = math.prod(shape)
    if kind.type == "cpu":
        return Mesh((kind,) * count, shape, axes)
    if count > n:
        raise RuntimeError(f"mesh shape {tuple(shape)} needs {count} "
                           f"CUDA devices; {n} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(count)),
                shape, axes)
