"""GNN architectures: graphcast, dimenet, graphsage, gat.

Port of ``repro/models/gnn.py`` (the unsharded forwards).  One unified
representation drives all four shapes: every batch is a (possibly
block-diagonal) flat graph

    node_feat [N, df], edge_src [E], edge_dst [E], loss targets + mask

Message passing is gather -> compute -> segment sum (``index_add``);
dimenet adds triplet gathers (edge->edge angular messages); gat adds a
segment softmax over incoming edges (``scatter_reduce("amax")`` from
-inf for the segment max, as ``jax.ops.segment_max`` leaves an empty
segment at -inf).

The reference's two ``shard_map`` forwards (graphcast and dimenet with
``cfg.sharded`` on a mesh) come with ``launch/cells.py`` in a later
slice (``ROADMAP.md`` queue 1); ``forward_loss`` refuses that case.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Shardings


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str                  # graphcast | dimenet | graphsage | gat
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int = 64
    n_heads: int = 8           # gat
    aggregator: str = "sum"
    d_edge: int = 4            # graphcast edge features
    n_radial: int = 6          # dimenet bases
    n_spherical: int = 7
    n_bilinear: int = 8
    n_out: int = 1
    dtype: Any = torch.float32
    # the reference's shard_map message passing (not ported yet)
    sharded: bool = False

    def flat_axes(self, sh: Shardings):
        if sh.mesh is None:
            return None
        return tuple(sh.mesh.axis_names)


# ---------------------------------------------------------------------------
def _normal(gen, shape, scale, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def _mlp_init(gen, dims, dtype, device):
    ws = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ws[f"w{i}"] = _normal(gen, (a, b), a ** -0.5, dtype, device)
        ws[f"b{i}"] = torch.zeros((b,), dtype=dtype, device=device)
    return ws


def _mlp(ws, x, act=torch.relu, final_act=False):
    n = len([k for k in ws if k.startswith("w")])
    for i in range(n):
        x = x @ ws[f"w{i}"] + ws[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def _stack(layers):
    """List of per-layer dicts -> one dict of stacked [L, ...] leaves."""
    if isinstance(layers[0], dict):
        return {k: _stack([lw[k] for lw in layers]) for k in layers[0]}
    return torch.stack(layers)


def _unstack(stacked, n: int) -> list:
    """Stacked [L, ...] dict -> per-layer dicts of views (one ``unbind``
    a leaf)."""
    if isinstance(stacked, dict):
        parts = {k: _unstack(v, n) for k, v in stacked.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return torch.unbind(stacked, 0)


def _take(x, ids):
    """x[ids] as an ``index_select``, whose backward is an ``index_add``
    (advanced indexing's is a sorted accumulate, far slower on the
    card)."""
    return torch.index_select(x, 0, ids)


def _segment_sum(values, ids, n):
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    return out.index_add(0, ids.long(), values)


def _segment_mean(values, ids, n):
    s = _segment_sum(values, ids, n)
    cnt = _segment_sum(torch.ones((values.shape[0], 1), dtype=values.dtype,
                                  device=values.device), ids, n)
    return s / torch.clamp(cnt, min=1.0)


def _segment_max(values, ids, n):
    out = values.new_full((n,) + tuple(values.shape[1:]), float("-inf"))
    index = ids.long().reshape((-1,) + (1,) * (values.dim() - 1))
    return out.scatter_reduce(0, index.expand_as(values), values, "amax",
                              include_self=False)


def _scan(layer, carry, stacked, n_layers):
    """The reference's ``lax.scan(jax.checkpoint(layer), ...)``: each
    layer recomputed in the backward pass."""
    for lw in _unstack(stacked, n_layers):
        if torch.is_grad_enabled():
            carry = checkpoint(layer, carry, lw, use_reentrant=False)
        else:
            carry = layer(carry, lw)
    return carry


# ---------------------------------------------------------------------------
# graphcast: encoder - interaction-network processor - decoder
# ---------------------------------------------------------------------------
def init_graphcast(cfg: GNNConfig, gen, device) -> Dict:
    d = cfg.d_hidden
    layers = [{"edge_mlp": _mlp_init(gen, (3 * d, d, d), cfg.dtype, device),
               "node_mlp": _mlp_init(gen, (2 * d, d, d), cfg.dtype, device)}
              for _ in range(cfg.n_layers)]
    return {
        "enc_node": _mlp_init(gen, (cfg.d_feat, d, d), cfg.dtype, device),
        "enc_edge": _mlp_init(gen, (cfg.d_edge, d, d), cfg.dtype, device),
        "layers": _stack(layers),
        "dec": _mlp_init(gen, (d, d, cfg.n_out), cfg.dtype, device),
    }


def forward_graphcast(cfg: GNNConfig, sh: Shardings, params: Dict,
                      batch: Dict) -> torch.Tensor:
    x, src, dst = batch["node_feat"], batch["edge_src"], batch["edge_dst"]
    src, dst = src.long(), dst.long()
    n = x.shape[0]
    h = _mlp(params["enc_node"], x.to(cfg.dtype))
    e = _mlp(params["enc_edge"], batch["edge_feat"].to(cfg.dtype))

    def layer(carry, lw):
        h, e = carry
        msg_in = torch.cat([e, _take(h, src), _take(h, dst)], dim=-1)
        e2 = e + _mlp(lw["edge_mlp"], msg_in)
        agg = _segment_sum(e2, dst, n)
        h2 = h + _mlp(lw["node_mlp"], torch.cat([h, agg], dim=-1))
        return h2, e2

    h, e = _scan(layer, (h, e), params["layers"], cfg.n_layers)
    pred = _mlp(params["dec"], h)                     # [N, n_out]
    mask = batch["loss_mask"].float()
    err = (pred.float() - batch["target"].float()) ** 2
    return torch.sum(err.mean(-1) * mask) / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# dimenet: directional message passing with radial/spherical bases
# ---------------------------------------------------------------------------
def init_dimenet(cfg: GNNConfig, gen, device) -> Dict:
    d = cfg.d_hidden
    nsr = cfg.n_spherical * cfg.n_radial
    layers = [{
        "msg_mlp": _mlp_init(gen, (d, d, d), cfg.dtype, device),
        "proj_kj": _mlp_init(gen, (d, d), cfg.dtype, device),
        "sbf_w": _normal(gen, (nsr, cfg.n_bilinear), nsr ** -0.5,
                         cfg.dtype, device),
        "bilinear": _normal(gen, (cfg.n_bilinear, d, d), d ** -0.5,
                            cfg.dtype, device),
    } for _ in range(cfg.n_layers)]
    return {
        "embed": _mlp_init(gen, (cfg.d_feat + cfg.n_radial, d, d),
                           cfg.dtype, device),
        "rbf_w": _normal(gen, (cfg.n_radial, d), cfg.n_radial ** -0.5,
                         cfg.dtype, device),
        "layers": _stack(layers),
        "out": _mlp_init(gen, (d, d, cfg.n_out), cfg.dtype, device),
    }


def _rbf(dist, n_radial):
    """Bessel-style radial basis: sin(n pi d / c) / d."""
    d = torch.clamp(dist, min=1e-3)[:, None]
    n = torch.arange(1, n_radial + 1, dtype=torch.float32,
                     device=dist.device)
    c = 5.0
    return torch.sin(n * math.pi * d / c) / d


def _sbf(angle, n_spherical, n_radial):
    """cos(l * angle) x radial grid: simplified spherical basis."""
    l = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    a = torch.cos(angle[:, None] * l)             # [T, n_sph]
    n = torch.arange(1, n_radial + 1, dtype=torch.float32,
                     device=angle.device)
    r = torch.sin(n * math.pi * 0.5)              # fixed radial weight
    return (a[:, :, None] * r[None, None, :]).reshape(angle.shape[0], -1)


def forward_dimenet(cfg: GNNConfig, sh: Shardings, params: Dict,
                    batch: Dict) -> torch.Tensor:
    x, src, dst = batch["node_feat"], batch["edge_src"], batch["edge_dst"]
    src, dst = src.long(), dst.long()
    dist = batch["edge_dist"]
    t_kj, t_ji = batch["tri_edge_kj"].long(), batch["tri_edge_ji"].long()
    angle = batch["tri_angle"]
    n, e_cnt = x.shape[0], src.shape[0]
    rbf = _rbf(dist, cfg.n_radial).to(cfg.dtype)           # [E, nr]
    sbf = _sbf(angle, cfg.n_spherical,
               cfg.n_radial).to(cfg.dtype)                 # [T, ns*nr]
    m = _mlp(params["embed"], torch.cat([_take(x.to(cfg.dtype), src), rbf],
                                        -1))
    rbf_g = rbf @ params["rbf_w"]                          # [E, d]

    def layer(m, lw):
        mk = _take(_mlp(lw["proj_kj"], m), t_kj)           # [T, d]
        w = sbf @ lw["sbf_w"]                              # [T, nb]
        tri = torch.einsum("tb,bdf,td->tf", w, lw["bilinear"], mk)
        agg = _segment_sum(tri, t_ji, e_cnt)
        return m + _mlp(lw["msg_mlp"], m * rbf_g + agg)

    m = _scan(layer, m, params["layers"], cfg.n_layers)
    node_e = _segment_sum(m, dst, n)
    pred = _mlp(params["out"], node_e)                     # [N, n_out]
    # graph-level energy: sum nodes per graph
    n_graphs = batch["target_g"].shape[0]
    energy = _segment_sum(pred[:, 0], batch["graph_id"], n_graphs)
    err = (energy.float() - batch["target_g"].float()) ** 2
    return torch.mean(err)


# ---------------------------------------------------------------------------
# graphsage: concat(self, mean-neighbour) -> linear
# ---------------------------------------------------------------------------
def init_graphsage(cfg: GNNConfig, gen, device) -> Dict:
    d = cfg.d_hidden
    layers = []
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        layers.append(_mlp_init(gen, (2 * d_in, d), cfg.dtype, device))
        d_in = d
    return {
        "layers": layers,   # ragged dims: keep as list
        "cls": _mlp_init(gen, (d, cfg.n_classes), cfg.dtype, device),
    }


def forward_graphsage(cfg: GNNConfig, sh: Shardings, params: Dict,
                      batch: Dict) -> torch.Tensor:
    h = batch["node_feat"].to(cfg.dtype)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    n = h.shape[0]
    for lw in params["layers"]:
        agg = _segment_mean(_take(h, src), dst, n)
        h = torch.relu(_mlp(lw, torch.cat([h, agg], -1)))
        h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                            min=1e-6)
    logits = _mlp(params["cls"], h)
    return _masked_ce(logits, batch["labels"], batch["loss_mask"])


# ---------------------------------------------------------------------------
# gat: segment-softmax edge attention
# ---------------------------------------------------------------------------
def init_gat(cfg: GNNConfig, gen, device) -> Dict:
    h_, d = cfg.n_heads, cfg.d_hidden
    layers = []
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        layers.append({
            "w": _normal(gen, (d_in, h_, d), d_in ** -0.5, cfg.dtype,
                         device),
            "a_src": _normal(gen, (h_, d), d ** -0.5, cfg.dtype, device),
            "a_dst": _normal(gen, (h_, d), d ** -0.5, cfg.dtype, device),
        })
        d_in = h_ * d
    return {"layers": layers,
            "cls": _mlp_init(gen, (d_in, cfg.n_classes), cfg.dtype, device)}


def gat_attention(lw: Dict, h: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor, n: int):
    """-> (z [N, H, F], alpha [E, H]): one GAT layer's projections and
    its segment softmax over the incoming edges of each node."""
    z = torch.einsum("nd,dhf->nhf", h, lw["w"])            # [N, H, F]
    logit_s = torch.einsum("nhf,hf->nh", z, lw["a_src"])
    logit_d = torch.einsum("nhf,hf->nh", z, lw["a_dst"])
    e_logit = F.leaky_relu(_take(logit_s, src) + _take(logit_d, dst),
                           negative_slope=0.2)             # [E, H]
    e_max = _segment_max(e_logit, dst, n)
    e_exp = torch.exp(e_logit - _take(e_max, dst))
    e_den = _segment_sum(e_exp, dst, n)
    return z, e_exp / torch.clamp(_take(e_den, dst), min=1e-9)


def forward_gat(cfg: GNNConfig, sh: Shardings, params: Dict,
                batch: Dict) -> torch.Tensor:
    h = batch["node_feat"].to(cfg.dtype)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    n = h.shape[0]
    for lw in params["layers"]:
        z, alpha = gat_attention(lw, h, src, dst, n)
        msg = _take(z, src) * alpha[..., None]
        h2 = _segment_sum(msg, dst, n)                     # [N, H, F]
        h = F.elu(h2.reshape(n, -1))
    logits = _mlp(params["cls"], h)
    return _masked_ce(logits, batch["labels"], batch["loss_mask"])


# ---------------------------------------------------------------------------
def _masked_ce(logits, labels, mask):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    ce = lse - gold
    m = mask.float()
    return torch.sum(ce * m) / torch.clamp(m.sum(), min=1.0)


INIT = {"graphcast": init_graphcast, "dimenet": init_dimenet,
        "graphsage": init_graphsage, "gat": init_gat}
FORWARD = {"graphcast": forward_graphcast, "dimenet": forward_dimenet,
           "graphsage": forward_graphsage, "gat": forward_gat}
SHARDED_ARCHS = ("graphcast", "dimenet")


def init_params(cfg: GNNConfig, generator: torch.Generator,
                device=None) -> Dict:
    """The reference's shapes, scales and dtypes, drawn from
    ``generator`` on ``device`` (default: the generator's)."""
    device = generator.device if device is None else torch.device(device)
    return INIT[cfg.arch](cfg, generator, device)


def forward_loss(cfg: GNNConfig, sh: Shardings, params: Dict,
                 batch: Dict) -> torch.Tensor:
    if (cfg.sharded and sh.mesh is not None
            and cfg.arch in SHARDED_ARCHS):
        raise NotImplementedError(
            f"the sharded {cfg.arch} forward (the reference's shard_map "
            "path) is not ported yet; see ROADMAP.md queue 1")
    return FORWARD[cfg.arch](cfg, sh, params, batch)
