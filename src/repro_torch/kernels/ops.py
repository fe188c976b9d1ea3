"""Dispatch between the hand-written CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``, with PyTorch's device model in
place of JAX's backend query.  The tensor decides:

  * a CUDA tensor runs the kernel (``force="ref"`` runs the plain
    version instead, so a caller can hold the two against each other on
    the card);
  * a CPU tensor runs the plain version; ``force="kernel"`` on a CPU
    tensor raises, since a CUDA kernel has no CPU or interpret mode.

No path falls back from the kernel to the plain version: a kernel that
fails to build or launch raises.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from . import ref as _ref
from .floyd_warshall import fw_batch_next_cuda
from .minplus_twoside import minplus_twoside_cuda

Force = Optional[Literal["kernel", "ref"]]


def use_kernel(device: torch.device | str, force: Force = None) -> bool:
    """The dispatch decision for tensors on ``device``."""
    if force not in (None, "kernel", "ref"):
        raise ValueError(f"force must be None, 'kernel' or 'ref': "
                         f"{force!r}")
    if force == "ref":
        return False
    if torch.device(device).type == "cuda":
        return True
    if force == "kernel":
        raise ValueError(f"force='kernel' needs CUDA tensors; got "
                         f"{device} (the CUDA kernels have no CPU mode)")
    return False


def fw_batch_next(d: torch.Tensor, *, force: Force = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Witness-carrying batched APSP over [b, n, n] -> (dist, nxt);
    nxt[b, i, j] = first hop of a shortest i -> j path (-1: unreachable
    or diagonal)."""
    if use_kernel(d.device, force):
        return fw_batch_next_cuda(d)
    return _ref.fw_batch_next_ref(d)


def fw_next(d: torch.Tensor, *, force: Force = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Witness-carrying APSP for a single [n, n] matrix (a batch of one)."""
    dist, nxt = fw_batch_next(d[None], force=force)
    return dist[0], nxt[0]


def minplus_twoside(rows: torch.Tensor, d: torch.Tensor,
                    rowt: torch.Tensor, *, force: Force = None
                    ) -> torch.Tensor:
    """Fused two-sided contraction: out[q] = min_{x,y} rows[q,x]
    + d[x,y] + rowt[q,y], never forming the [q, x, y] cube."""
    if use_kernel(rows.device, force):
        return minplus_twoside_cuda(rows, d, rowt)
    return _ref.minplus_twoside_ref(rows, d, rowt)
