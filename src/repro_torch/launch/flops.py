# Copied from src/repro/launch/flops.py; keep the two in step.
"""MODEL_FLOPS estimators (roofline §: the 'useful compute' numerator).

LM uses the standard 6*N*D (train) / 2*N*D (inference) parameter-flops
convention with N = active params; GNN/recsys count the dominant matmul
terms explicitly.  These are *model* flops: the ratio against the
matmul FLOPs a step really dispatches (``launch/opanalysis.py``)
surfaces dispatch, recompute and padding waste.
"""
from __future__ import annotations

from ..configs.api import ArchSpec, ShapeCell
from ..models import gnn, recsys, transformer


def model_flops(spec: ArchSpec, cell: ShapeCell) -> float:
    if spec.family == "lm":
        return _lm(spec.model_cfg, cell)
    if spec.family == "gnn":
        return _gnn(spec.model_cfg, cell)
    return _recsys(spec.model_cfg, cell)


def _lm(cfg: transformer.LMConfig, cell: ShapeCell) -> float:
    n_act = cfg.n_active_params()
    d = cell.dims
    if cell.kind == "train":
        tokens = d["seq_len"] * d["global_batch"]
        return 6.0 * n_act * tokens
    if cell.kind == "prefill":
        tokens = d["seq_len"] * d["global_batch"]
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * d["global_batch"]


def _gnn(cfg: gnn.GNNConfig, cell: ShapeCell) -> float:
    d = cell.dims
    n, e, df = d["n_nodes"], d["n_edges"], d["d_feat"]
    h = cfg.d_hidden
    t3 = 2 * e
    if cfg.arch == "graphcast":
        enc = 2.0 * (n * df * h + n * h * h + e * 4 * h + e * h * h)
        per_layer = 2.0 * (e * (3 * h) * h + e * h * h
                           + n * (2 * h) * h + n * h * h)
        dec = 2.0 * n * (h * h + h * cfg.n_out)
        fwd = enc + cfg.n_layers * per_layer + dec
    elif cfg.arch == "dimenet":
        embed = 2.0 * e * (df + cfg.n_radial) * h + 2.0 * e * h * h
        nsr = cfg.n_spherical * cfg.n_radial
        per_layer = 2.0 * (e * h * h                 # proj_kj
                           + t3 * nsr * cfg.n_bilinear
                           + t3 * cfg.n_bilinear * h * h  # bilinear einsum
                           + e * 2 * h * h)          # msg mlp
        out = 2.0 * n * (h * h + h * cfg.n_out)
        fwd = embed + cfg.n_layers * per_layer + out
    elif cfg.arch == "graphsage":
        d_in = df
        fwd = 0.0
        for _ in range(cfg.n_layers):
            fwd += 2.0 * n * (2 * d_in) * h
            d_in = h
        fwd += 2.0 * n * h * cfg.n_classes
    else:  # gat
        d_in = df
        fwd = 0.0
        for _ in range(cfg.n_layers):
            fwd += 2.0 * n * d_in * cfg.n_heads * cfg.d_hidden
            fwd += 4.0 * e * cfg.n_heads * cfg.d_hidden
            d_in = cfg.n_heads * cfg.d_hidden
        fwd += 2.0 * n * d_in * cfg.n_classes
    return 3.0 * fwd if cell.kind == "train" else fwd


def _recsys(cfg: recsys.RecsysConfig, cell: ShapeCell) -> float:
    d = cell.dims
    b = d["batch"]
    d_in = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    dims = (d_in,) + cfg.mlp_dims + (1,)
    mlp = sum(2.0 * a * bb for a, bb in zip(dims[:-1], dims[1:]))
    fwd = b * mlp
    if cell.kind == "retrieval":
        fwd = mlp + 2.0 * d["n_candidates"] * cfg.mlp_dims[-1]
    return 3.0 * fwd if cell.kind == "train" else fwd
