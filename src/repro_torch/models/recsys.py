"""Wide & Deep recommender (Cheng et al. 2016) with huge sparse tables.

Port of ``repro/models/recsys.py``.  The EmbeddingBag is built as the
reference builds it, ``index_select`` + a segment sum (``index_add``),
so its gradient is a dense tensor the size of the table: the
reference's AdamW (weight decay included) moves every row of the
40,000,000-row table every step, and a sparse gradient
(``nn.EmbeddingBag(sparse=True)``) would change those numbers.

Shapes:
  train_batch / serve_p99 / serve_bulk : [B, F, H] multi-hot ids
  retrieval_cand: one user against n_candidates item vectors (dot + top-k)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .common import Shardings
from .common import top_k as _top_k


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_sparse: int = 40            # categorical fields
    n_dense: int = 13
    embed_dim: int = 32
    rows_per_field: int = 1_000_000
    hots_per_field: int = 2       # multi-hot width H
    mlp_dims: Tuple[int, ...] = (1024, 512, 256)
    interaction: str = "concat"
    dtype: Any = torch.float32


def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device=None) -> Dict:
    """The reference's shapes, scales and dtypes, drawn from
    ``generator`` on ``device`` (default: the generator's)."""
    device = generator.device if device is None else torch.device(device)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(cfg.dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    d_in = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    mlp = {}
    dims = (d_in,) + cfg.mlp_dims + (1,)
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        mlp[f"w{i}"] = normal((a, b), a ** -0.5)
        mlp[f"b{i}"] = zeros((b,))
    rows = cfg.n_sparse * cfg.rows_per_field
    return {
        # one big [F * rows, dim] table (fields offset into it)
        "table": normal((rows, cfg.embed_dim), 0.01),
        # wide: one scalar weight per table row + dense weights
        "wide_table": zeros((rows,)),
        "wide_dense": zeros((cfg.n_dense,)),
        "mlp": mlp,
        "bias": zeros(()),
    }


def param_specs(cfg: RecsysConfig, sh: Shardings) -> Dict:
    P_ = sh.spec
    mlp = {k: P_(None, None) if k.startswith("w") else P_(None)
           for k in init_mlp_keys(cfg)}
    return {
        "table": P_(sh.tp, None),       # row-sharded on 'model'
        "wide_table": P_(sh.tp),
        "wide_dense": P_(None),
        "mlp": mlp,
        "bias": P_(),
    }


def init_mlp_keys(cfg: RecsysConfig):
    dims = (cfg.n_dense + cfg.n_sparse * cfg.embed_dim,) + cfg.mlp_dims \
        + (1,)
    out = []
    for i in range(len(dims) - 1):
        out += [f"w{i}", f"b{i}"]
    return out


# ---------------------------------------------------------------------------
def _segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    return out.index_add(0, seg, values)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  combiner: str = "mean") -> torch.Tensor:
    """EmbeddingBag from ``index_select`` + a segment sum.

    ids [B, F, H] (global row ids); returns [B, F, dim]."""
    b, f, h = ids.shape
    flat = ids.reshape(-1).long()
    emb = torch.index_select(table, 0, flat)            # [B*F*H, dim]
    if weights is not None:
        emb = emb * weights.reshape(-1, 1)
    seg = torch.arange(b * f, device=ids.device).repeat_interleave(h)
    out = _segment_sum(emb, seg, b * f)
    if combiner == "mean":
        out = out / h
    return out.reshape(b, f, -1)


def embedding_bag_ragged(table: torch.Tensor, ids: torch.Tensor,
                         offsets: torch.Tensor, n_bags: int,
                         combiner: str = "sum") -> torch.Tensor:
    """Ragged EmbeddingBag (torch.nn.EmbeddingBag semantics):
    ids [nnz], offsets [n_bags] (start of each bag)."""
    emb = torch.index_select(table, 0, ids.long())
    pos = torch.arange(ids.shape[0], device=ids.device,
                       dtype=offsets.dtype)
    seg = torch.searchsorted(offsets, pos, right=True) - 1
    out = _segment_sum(emb, seg, n_bags)
    if combiner == "mean":
        cnt = _segment_sum(torch.ones(ids.shape[0], dtype=out.dtype,
                                      device=ids.device), seg, n_bags)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def _field_ids(cfg: RecsysConfig, ids: torch.Tensor) -> torch.Tensor:
    offs = (torch.arange(cfg.n_sparse, dtype=ids.dtype, device=ids.device)
            * cfg.rows_per_field)[None, :, None]
    return ids + offs


def _mlp_layers(params: Dict) -> int:
    return len([k for k in params["mlp"] if k.startswith("w")])


def forward_logits(cfg: RecsysConfig, sh: Shardings, params: Dict,
                   batch: Dict) -> torch.Tensor:
    """batch: sparse_ids [B, F, H] (field-local), dense [B, n_dense]."""
    ids = batch["sparse_ids"]
    b = ids.shape[0]
    gids = _field_ids(cfg, ids)
    emb = embedding_bag(params["table"], gids)       # [B, F, dim]
    dense = batch["dense"].to(cfg.dtype)
    x = torch.cat([dense, emb.reshape(b, -1)], dim=-1)
    n = _mlp_layers(params)
    for i in range(n):
        x = x @ params["mlp"][f"w{i}"] + params["mlp"][f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    deep = x[:, 0]
    # wide: sum of per-row weights + linear dense
    wide_sp = torch.index_select(params["wide_table"], 0,
                                 gids.reshape(-1).long()
                                 ).reshape(b, -1).sum(-1)
    wide = wide_sp + dense @ params["wide_dense"]
    return deep + wide + params["bias"]


def forward_loss(cfg: RecsysConfig, sh: Shardings, params: Dict,
                 batch: Dict) -> torch.Tensor:
    logits = forward_logits(cfg, sh, params, batch).float()
    y = batch["labels"].float()
    # sigmoid BCE, in the stable form
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def retrieval_scores(cfg: RecsysConfig, sh: Shardings, params: Dict,
                     batch: Dict, top_k: int = 100
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query against n_candidates: batched dot + top-k.

    The query tower reuses the deep MLP up to its penultimate layer; the
    candidate matrix [n_cand, d_last] is an input.  Top-k keeps
    ``lax.top_k``'s order (``common.top_k``)."""
    ids = batch["sparse_ids"]                      # [1, F, H]
    emb = embedding_bag(params["table"], _field_ids(cfg, ids))
    q = torch.cat([batch["dense"].to(cfg.dtype), emb.reshape(1, -1)], -1)
    n = _mlp_layers(params)
    for i in range(n - 1):                         # stop before logit layer
        q = q @ params["mlp"][f"w{i}"] + params["mlp"][f"b{i}"]
        q = torch.relu(q)
    cand = batch["candidates"]                     # [n_cand, d_last]
    scores = (cand @ q[0]).float()                 # [n_cand]
    return _top_k(scores, top_k)
