# Copied from src/repro/launch/traffic.py; keep the two in step.
"""Analytic per-device HBM traffic model (roofline memory-term numerator).

The reference's model, arithmetic unchanged: bytes each device of the
production mesh moves per step, from the configuration and the shape
alone.  ``launch/dryrun.py`` uses it for the roofline's memory term;
the port's op analysis (``launch/opanalysis.py``) counts the bytes of
an unfused eager step, which overstates what a fused step moves, so it
is reported beside the model as a diagnostic.

All numbers are per device per step.
"""
from __future__ import annotations

from ..configs.api import ArchSpec, ShapeCell
from ..models import gnn, recsys, transformer


def analytic_bytes(spec: ArchSpec, cell: ShapeCell, n_chips: int,
                   tp: int = 16, dp: int | None = None) -> float:
    if dp is None:
        dp = n_chips // tp
    if spec.family == "lm":
        return _lm(spec, cell, n_chips, tp, dp)
    if spec.family == "gnn":
        return _gnn(spec.model_cfg, cell, n_chips)
    return _recsys(spec.model_cfg, cell, n_chips, tp, dp)


def _lm(spec: ArchSpec, cell: ShapeCell, n_chips, tp, dp) -> float:
    cfg: transformer.LMConfig = spec.model_cfg
    d = cell.dims
    b, t = d["global_batch"], d["seq_len"]
    p_total = cfg.n_params() * 2                      # bf16
    p_gathered = p_total / tp                         # per-device working set
    kv_token = 2 * cfg.n_kv_heads * cfg.head_dim * 2  # k+v bytes/token/layer
    if cell.kind == "train":
        n_micro = max(1, (b // dp) // spec.seqs_per_micro)
        tokens_dev = b * t / dp / max(n_micro, 1)     # per micro
        # weights: fwd + bwd + remat refwd re-read the gathered shard
        w = 3.0 * n_micro * p_gathered
        # activations: ~12 intermediate tensors of [tokens, d] per layer
        act = (3.0 * n_micro * cfg.n_layers * tokens_dev
               * cfg.d_model * 2 * 12)
        # attention score tiles (f32, write+read in fwd, x3 with bwd)
        h_local = cfg.n_heads / (tp if cfg.n_heads % tp == 0 else 1)
        seqs_local = tokens_dev / t
        att = 3.0 * n_micro * cfg.n_layers * seqs_local * h_local \
            * t * t * 4 * 2
        # optimizer: grads f32 + m/v read+write + params read+write
        opt = (p_total / (dp * tp)) * (4 + 4 * 4 + 2 * 2)
        return w + act + att + opt
    if cell.kind == "prefill":
        tokens_dev = b * t / (dp if b % dp == 0 and b >= dp else 1)
        w = p_gathered
        act = cfg.n_layers * tokens_dev * cfg.d_model * 2 * 12
        cache_w = cfg.n_layers * tokens_dev * kv_token / tp
        return w + act + cache_w
    # decode: read the whole local cache slice + weights once
    shard_seq = bool(d.get("shard_seq", 0)) or not (b % dp == 0
                                                    and b >= dp)
    cache_total = cfg.n_layers * b * t * kv_token
    cache_dev = cache_total / n_chips if shard_seq \
        else cache_total / (dp * tp)
    w = p_gathered
    return w + cache_dev + b / dp * cfg.d_model * 2 * cfg.n_layers * 12


def _gnn(cfg: gnn.GNNConfig, cell: ShapeCell, n_chips) -> float:
    d = cell.dims
    n, e = d["n_nodes"], d["n_edges"]
    h = cfg.d_hidden
    dt = 2 if cfg.arch in ("graphcast", "dimenet") else 4
    if cfg.arch == "graphcast":
        # per layer: halo all_gather write+read of [N, h] + edge state
        # read/write + gathers [E/P, 3h] + node mlp, x3 for train bwd
        per_layer = (2 * n * h * dt + 4 * (e / n_chips) * h * dt
                     + 2 * (e / n_chips) * 3 * h * dt
                     + 4 * (n / n_chips) * h * dt)
        return 3.0 * cfg.n_layers * per_layer
    if cfg.arch == "dimenet":
        t3 = 2 * e
        per_layer = ((e / n_chips) * h * dt * 6
                     + (t3 / n_chips) * h * dt * 3)
        return 3.0 * cfg.n_layers * per_layer + 2 * n * cfg.d_feat * dt
    # graphsage / gat: replicated-node SPMD path
    per_layer = (2 * n * h * dt + 4 * (e / n_chips) * h * dt)
    return 3.0 * cfg.n_layers * per_layer


def _recsys(cfg: recsys.RecsysConfig, cell: ShapeCell, n_chips, tp,
            dp) -> float:
    d = cell.dims
    b = d["batch"]
    if cell.kind == "retrieval":
        return (d["n_candidates"] / n_chips * cfg.mlp_dims[-1] * 4
                + sum(a * 4 for a in cfg.mlp_dims))
    per_dev_rows = b * cfg.n_sparse * cfg.hots_per_field / \
        (dp if cell.kind == "train" else n_chips)
    lookup = per_dev_rows * cfg.embed_dim * 4 * 2     # gather + combine
    d_in = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    dims = (d_in,) + cfg.mlp_dims + (1,)
    w_bytes = sum(a * bb for a, bb in zip(dims[:-1], dims[1:])) * 4
    act = per_dev_rows / cfg.hots_per_field * d_in * 4
    mult = 3.0 if cell.kind == "train" else 1.0
    table_update = (cfg.n_sparse * cfg.rows_per_field * cfg.embed_dim
                    * 4 / tp) if cell.kind == "train" else 0.0
    # sparse AdamW touches only gathered rows; dense tables modelled as
    # row-sparse update traffic
    table_update = min(table_update, lookup * 6)
    return mult * (lookup + w_bytes + act) + table_update
