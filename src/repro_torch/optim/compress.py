"""Gradient compression: int8 quantized all-reduce (wire-size 4x cut).

Port of ``repro/optim/compress.py``.  Each tensor is quantized to int8
with one float32 absmax scale, summed in int32 (no overflow for <= 2^23
replicas) and dequantized with the replicas' mean.  The error is bounded
by absmax/127 per element per step.
"""
from __future__ import annotations

from typing import Sequence

import torch


def quantize_int8(x: torch.Tensor):
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(shards: Sequence[torch.Tensor]) -> list:
    """Mean over the replicas of one mesh axis with the int8 wire format.

    The reference runs inside ``shard_map`` and reduces over a named
    axis; on the port's one-controller ``Mesh`` the caller hands the
    per-shard tensors of that axis (``Mesh.shard_devices(axes)`` gives
    their devices) and gets each shard's result back on its own device.
    Every replica quantizes with the max scale over the replicas, so the
    dequant is conservative-correct; the int8 values are summed in int32
    and the sum is divided by the replica count."""
    scales = [torch.max(torch.abs(x)) / 127.0 + 1e-12 for x in shards]
    home = shards[0].device
    smax = torch.max(torch.stack([s.to(home) for s in scales]))
    total = None
    for x in shards:
        q = torch.clamp(torch.round(x / smax.to(x.device)), -127,
                        127).to(torch.int8)
        q = q.to(home, torch.int32)
        total = q if total is None else total + q
    mean = total.float() * smax / float(len(shards))
    return [mean.to(x.device) for x in shards]
