"""Device meshes of the port, and collectives over them.

Port of ``repro/launch/mesh.py``.  A ``Mesh`` is the port's counterpart
of a JAX mesh on one controller: a tuple of ``torch.device``s laid out
row-major over ``shape``, with a name per axis.  ``core.dist_engine``'s
sharded functions and the sharded GNN forwards (``models/gnn.py``) split
a batch over the devices along some axes and run each part on its
device.  One device may appear more than once (``make_host_mesh(device=
"cpu")``, a mesh of one card repeated, or the ``meta`` production
mesh): the shards that share a device run on it, one after another or
as one batch.

``make_production_mesh`` gives the reference's production shapes,
(16, 16) over ("data", "model") or (2, 16, 16) over ("pod", "data",
"model"), by default on the ``meta`` device repeated: the port's
counterpart of the 512 host devices the reference's dry run forces, on
which a step runs for its shapes and allocates nothing
(``launch/dryrun.py``).

``all_gather`` and ``psum`` are the one-controller counterparts of
``lax.all_gather(tiled=True)`` and ``lax.psum`` over mesh axes:
differentiable, built from ``to()`` and ``cat``/``sum``, and logged, per
device and by kind, into every open ``record_collectives()``.

The reference's ``compat.py`` (shims over JAX versions for
``shard_map`` and ``jax.make_mesh``) has no counterpart: the port's
``Mesh`` is its own, and it runs no ``shard_map``.

Nothing here touches the card when the module is imported.
"""
from __future__ import annotations

import contextlib
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

    @property
    def size(self) -> int:
        """Positions of the mesh (``jax.sharding.Mesh.size``)."""
        return len(self.devices)

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
    ``jax.make_mesh`` raises).  On ``cpu`` (or ``meta``): that device
    repeated prod(shape) times (default one), the port's counterpart of
    the reference tests' ``--xla_force_host_platform_device_count``."""
    kind = torch.device(device)
    if kind.index is not None or kind.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be 'cuda' or 'cpu' (or 'meta'), "
                         f"got {device!r}")
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
    if kind.type != "cuda":
        return Mesh((kind,) * count, shape, axes)
    if count > n:
        raise RuntimeError(f"mesh shape {tuple(shape)} needs {count} "
                           f"CUDA devices; {n} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(count)),
                shape, axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> Mesh:
    """The reference's production mesh: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model") with
    ``multi_pod``.  On ``meta`` (the default) every position is the meta
    device; on ``cuda`` it raises unless 256 (512) cards are visible, as
    ``make_host_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes, device=device)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
#: collective kinds, named as the reference's dry run names HLO ops
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass
class CollectiveLog:
    """Per-device result bytes and calls of each collective kind, the
    counterpart of the reference's ``dryrun.collective_bytes`` over
    partitioned HLO; ``events`` lists each call as (kind, bytes)."""
    bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    events: list = dataclasses.field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] += nbytes
        self.counts[kind] += 1
        self.events.append((kind, nbytes))


#: the logs of the open ``record_collectives`` blocks
_OPEN_LOGS: list = []


@contextlib.contextmanager
def record_collectives():
    """Log every collective called inside the block into a new
    ``CollectiveLog``, which the block gets."""
    log = CollectiveLog()
    _OPEN_LOGS.append(log)
    try:
        yield log
    finally:
        _OPEN_LOGS.remove(log)


def _log(kind: str, nbytes: int) -> None:
    for log in _OPEN_LOGS:
        log.add(kind, int(nbytes))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _distinct(devices) -> list:
    return list(dict.fromkeys(devices))


def _shard_parts(parts, mesh: Mesh, axes) -> tuple:
    """The devices of the shards over ``axes``, checked against
    ``parts`` (one tensor a shard, in shard order)."""
    devices = mesh.shard_devices(axes)
    if len(parts) != len(devices):
        raise ValueError(f"{len(parts)} parts for the {len(devices)} "
                         f"shards of mesh axes {tuple(axes)}")
    return devices


class _AllGather(torch.autograd.Function):
    """Forward: the parts concatenated on each of ``devices``.
    Backward: each part's rows of every device's gradient, moved to the
    part's device and summed (a reduce-scatter, logged)."""

    @staticmethod
    def forward(ctx, devices, *parts):
        from ..core.dist_engine import _gather
        ctx.part_devices = [p.device for p in parts]
        ctx.sizes = [p.shape[0] for p in parts]
        ctx.part_bytes = max(_nbytes(p) for p in parts)
        return tuple(_gather(list(parts), dev, parts[0][:0])
                     for dev in devices)

    @staticmethod
    def backward(ctx, *grads):
        live = [g for g in grads if g is not None]
        _log("reduce-scatter", ctx.part_bytes)
        out, lo = [], 0
        for dev, size in zip(ctx.part_devices, ctx.sizes):
            parts = [g[lo:lo + size].to(dev) for g in live]
            out.append(torch.stack(parts).sum(0) if len(parts) > 1
                       else parts[0])
            lo += size
        return (None, *out)


def all_gather(parts, mesh: Mesh, axes) -> list:
    """``lax.all_gather(x, axes, axis=0, tiled=True)``: ``parts`` holds
    each shard's tensor over mesh ``axes`` in shard order
    (``Mesh.shard_devices``), each on its shard's device; -> one tensor
    a shard, the parts concatenated along dim 0 on that shard's device
    (computed once per distinct device, shared by the shards there).
    Logs the result's bytes (one device's) as "all-gather"."""
    devices = _shard_parts(parts, mesh, axes)
    distinct = _distinct(devices)
    outs = _AllGather.apply(distinct, *parts)
    _log("all-gather", _nbytes(outs[0]))
    by_device = dict(zip(distinct, outs))
    return [by_device[d] for d in devices]


def psum(parts, mesh: Mesh, axes) -> list:
    """``lax.psum(x, axes)``: ``parts`` as in ``all_gather``, alike in
    shape; -> one tensor a shard, the sum of the parts in shard order
    on that shard's device (computed once per distinct device).  Logs
    one part's bytes as "all-reduce"."""
    devices = _shard_parts(parts, mesh, axes)
    by_device = {d: torch.stack([p.to(d) for p in parts]).sum(0)
                 for d in _distinct(devices)}
    _log("all-reduce", _nbytes(parts[0]))
    return [by_device[d] for d in devices]
