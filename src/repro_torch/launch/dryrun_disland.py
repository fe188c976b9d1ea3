"""Dry run of the paper's own workload, DISLAND batched serving, on the
production meshes: the port's counterpart of
``repro/launch/dryrun_disland.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_disland

Index dimensions model a ~262k-node road graph (c=2), as the
reference's: 256 fragments of <=1024 nodes, 128 boundary slots, ~8k
SUPER nodes, piece buckets per ``device_engine``'s caps; the port's
fields the reference lacks (the hierarchy's, the resident rows', the
hub labels') sit at their empty (dummy) sizes, as a dense index holds
them.  The index is replicated and the query batch of 2^17 split over
every mesh position (the zero-collective serving layout), so one
shard's program is ``serve_step`` on 131,072 / n_chips queries: it runs
once on ``meta`` under the op analysis, through the card's route of the
kernel dispatch (``kernels/ops.py``), which allocates each kernel's
outputs and workspace and launches nothing.

Each mesh's record: ``fit_gb`` (the replicated index plus the shard's
peak live bytes, which a shard holds on its device), ``flops_dev``
(matmul FLOPs: the serve step has none), ``collective_bytes_dev`` (0)
and the reference's roofline terms, its analytic memory term at this
card's HBM rate (``dryrun.HBM_BW``).  Records land in
``experiments/dryrun_torch/disland-serve__bonus.json``.
"""
from __future__ import annotations

import json
import os
import time

import torch

from ..core.device_engine import FIELD_DTYPES, DeviceIndex, serve_step
from . import opanalysis
from .dryrun import CARD, HBM_BW, LINK_BW_ASSUMED, PEAK_FLOPS
from .mesh import make_production_mesh

#: the reference's query batch (2^17), split over every mesh position
Q_TOTAL = 131_072
#: shapes of the fields a dense index holds at a dummy size
_DUMMY = {"d2": (1, 1), "d2_next": (1, 1), "res_rows": (1, 1, 1),
          "res_of_frag": (1,), "topgrp_of_frag": (1,), "hub_rows": (1, 1),
          "hub_of_agent": (1,)}


def index_struct(n=262_144, k=256, maxf=1024, mb=128, s_super=8192,
                 pieces=(20_000, 2_000, 200, 16, 1),
                 device="meta") -> DeviceIndex:
    """A ``DeviceIndex`` of ``meta`` tensors at the reference's
    dimensions (``src/repro/launch/dryrun_disland.py:27``)."""
    caps = (8, 32, 128, 512, 2048)
    flat = sum(p * c * c for p, c in zip(pieces, caps))
    shapes = {
        "agent_of": (n,), "dist_to_agent": (n,), "frag_of": (n,),
        "pos_in_frag": (n,), "piece_gid": (n,), "pos_in_piece": (n,),
        "piece_base": (n,), "piece_stride": (n,),
        "frag_apsp": (k, maxf, maxf), "frag_next": (k, maxf, maxf),
        "brow": (k, maxf, mb), "bpos": (k, mb), "bvalid": (k, mb),
        "bnd_super": (k, mb), "d_super": (s_super + 1, s_super + 1),
        "super_next": (s_super + 1, s_super + 1), "piece_flat": (flat,),
        "piece_next": (flat,), **_DUMMY}
    return DeviceIndex(**{
        name: torch.empty(shapes[name], dtype=dtype, device=device)
        for name, dtype in FIELD_DTYPES.items()})


def index_bytes(dix: DeviceIndex) -> int:
    return sum(getattr(dix, name).numel() * getattr(dix, name).element_size()
               for name in FIELD_DTYPES)


def run(mesh_kind: str, dix: DeviceIndex | None = None) -> dict:
    """One mesh's record (``mesh_kind`` "single" or "multipod")."""
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
    dix = index_struct() if dix is None else dix
    q = Q_TOTAL // mesh.size
    s = torch.empty((q,), dtype=torch.int32, device=dix.device)
    t0 = time.perf_counter()
    ana = opanalysis.analyze(serve_step, dix, s, s)
    dt = time.perf_counter() - t0
    fit = (index_bytes(dix) + ana.peak_live_bytes) / 1e9
    return {
        "mesh": mesh_kind, "n_chips": mesh.size, "q_per_shard": q,
        "lower_s": dt, "fit_gb": fit,
        "index_gb": index_bytes(dix) / 1e9,
        "shard_peak_gb": ana.peak_live_bytes / 1e9,
        "flops_dev": ana.flops,
        "collective_bytes_dev": ana.collective_bytes,
        "n_ops": ana.n_ops,
        "roofline": {
            "card": CARD,
            "compute_s": ana.flops / PEAK_FLOPS,
            # serve traffic per query: two boundary rows + two scattered
            # SUPER rows, plus D_super streamed once per 128-query tile
            # by the fused combine kernel (the reference's model)
            "memory_s": (q * (128 * 4 * 2 + 8_193 * 4 * 2
                              + 8_193 ** 2 * 4 / 128)) / HBM_BW,
            "collective_s": ana.collective_bytes / LINK_BW_ASSUMED,
        },
    }


def main(out_dir: str = "experiments/dryrun_torch") -> dict:
    out = {}
    dix = index_struct()
    for mesh_kind in ("single", "multipod"):
        rec = run(mesh_kind, dix)
        print(f"[OK] disland-serve x q{Q_TOTAL} x {mesh_kind} "
              f"fit={rec['fit_gb']:.2f}GB run={rec['lower_s']:.1f}s "
              f"coll={rec['collective_bytes_dev'] / 1e6:.1f}MB/dev",
              flush=True)
        out[mesh_kind] = rec
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "disland-serve__bonus.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
