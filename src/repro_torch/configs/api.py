# Copied from src/repro/configs/api.py; keep the two in step.
"""Architecture registry: one ArchSpec per assigned architecture.

Every spec carries the exact published dimensions plus per-arch launch
knobs (microbatching granularity, attention chunking) that the cell
builder (launch/cells.py) consumes.  Shapes are the assignment's own
shape sets; sharded leading dims are padded to multiples of 512 so both
the 256-chip and 512-chip meshes divide them (JAX requires divisible
shardings; padding is recorded per cell).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

PAD_TO = 512  # lcm of both production mesh sizes


def pad_up(x: int, mult: int = PAD_TO) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                  # train | prefill | decode | serve | retrieval
    dims: Dict[str, int]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                # lm | gnn | recsys
    model_cfg: Any
    shapes: Tuple[ShapeCell, ...]
    # launch knobs
    seqs_per_micro: int = 4    # LM grad-accum granularity (per device)
    opt_state_dtype: str = "float32"  # "bfloat16" halves AdamW moments
    serialize_opt_update: bool = False  # chain leaf updates (mem peak)
    grad_accum_dtype: str = "float32"  # bf16 halves the accum tree (104B)
    notes: str = ""

    def shape(self, name: str) -> ShapeCell:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name}; "
                       f"have {[s.name for s in self.shapes]}")


# ---- canonical shape sets --------------------------------------------------
def lm_shapes() -> Tuple[ShapeCell, ...]:
    return (
        ShapeCell("train_4k", "train",
                  {"seq_len": 4096, "global_batch": 256}),
        ShapeCell("prefill_32k", "prefill",
                  {"seq_len": 32768, "global_batch": 32}),
        ShapeCell("decode_32k", "decode",
                  {"seq_len": 32768, "global_batch": 128}),
        ShapeCell("long_500k", "decode",
                  {"seq_len": 524288, "global_batch": 1, "shard_seq": 1}),
    )


def gnn_shapes() -> Tuple[ShapeCell, ...]:
    # edge counts are directed (x2 undirected); all padded to 512
    return (
        ShapeCell("full_graph_sm", "train",
                  {"n_nodes": pad_up(2708), "n_edges": pad_up(2 * 10556),
                   "d_feat": 1433, "n_graphs": 1}),
        ShapeCell("minibatch_lg", "train",
                  {"n_nodes": pad_up(1024 * (1 + 15 + 150)),
                   "n_edges": pad_up(1024 * 15 + 1024 * 150),
                   "d_feat": 602, "n_graphs": 1}),
        ShapeCell("ogb_products", "train",
                  {"n_nodes": pad_up(2_449_029),
                   "n_edges": pad_up(2 * 61_859_140),
                   "d_feat": 100, "n_graphs": 1}),
        ShapeCell("molecule", "train",
                  {"n_nodes": pad_up(128 * 30), "n_edges": pad_up(2 * 64 * 128),
                   "d_feat": 32, "n_graphs": 128}),
    )


def recsys_shapes() -> Tuple[ShapeCell, ...]:
    return (
        ShapeCell("train_batch", "train", {"batch": 65536}),
        ShapeCell("serve_p99", "serve", {"batch": 512}),
        ShapeCell("serve_bulk", "serve", {"batch": 262144}),
        ShapeCell("retrieval_cand", "retrieval",
                  {"batch": 1, "n_candidates": pad_up(1_000_000)}),
    )
