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

With ``cfg.sharded`` on a mesh, ``forward_loss`` routes graphcast and
dimenet to the reference's ``shard_map`` forwards with owner-computes
edge partitioning (``forward_graphcast_sharded``,
``forward_dimenet_sharded``): the batch arrays are split over every
mesh axis, one halo ``all_gather`` crosses shards per layer and one
``psum`` at the end (``launch/mesh.py``).  On one controller the shards
that share a device run there as one batch: their node and edge rows
side by side, each shard's shard-local ids offset to its rows, so every
shard computes exactly what it would alone and the per-device program
is the same however many shards share the device (all 256 of the
``meta`` production mesh, four on a card repeated four times, one on
each of several cards).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..checkpoint.manager import tree_map
from ..launch.mesh import all_gather, psum
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
    # sharded (shard_map) message passing: node/edge arrays stay sharded;
    # per-layer all_gather(h) replaces the replicated gathers
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


# ---------------------------------------------------------------------------
# shard_map message passing (src/repro/models/gnn.py:319-473)
# ---------------------------------------------------------------------------
def _ckpt(fn, *args):
    """``jax.checkpoint(fn)(*args)``: recomputed in the backward pass
    when autograd records, a plain call otherwise."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


@dataclasses.dataclass
class _Group:
    """The shards of the flattened mesh that share one device, by id in
    shard order (a shard's rank in the group is its position)."""
    device: torch.device
    shards: list

    @property
    def size(self) -> int:
        return len(self.shards)

    def rows(self, x: torch.Tensor, n_shards: int) -> torch.Tensor:
        """The group's shards' slices of ``x`` (split in ``n_shards``
        along dim 0), side by side, on the group's device: a view when
        they are consecutive."""
        per = x.shape[0] // n_shards
        lo, hi = self.shards[0], self.shards[-1] + 1
        if hi - lo == self.size:
            part = x[lo * per:hi * per]
        else:
            part = torch.cat([x[i * per:(i + 1) * per] for i in self.shards])
        return part.to(self.device)

    def offsets(self, per_shard: int, stride: int) -> torch.Tensor:
        """[size * per_shard] int64: rank * stride for each of the
        group's rows (``per_shard`` rows a shard)."""
        return (torch.arange(self.size, device=self.device)
                .repeat_interleave(per_shard) * stride)


def _groups(mesh, axes) -> tuple[list, int]:
    """-> (the groups of shards over ``axes`` by device, in order of
    first appearance; the shard count)."""
    devices = mesh.shard_devices(axes)
    by_dev: dict = {}
    for i, dev in enumerate(devices):
        by_dev.setdefault(dev, []).append(i)
    return [_Group(d, ids) for d, ids in by_dev.items()], len(devices)


def _check_split(batch: Dict, keys, n_shards: int) -> None:
    for k in keys:
        if batch[k].shape[0] % n_shards:
            raise ValueError(f"sharded forward: {k} has {batch[k].shape[0]} "
                             f"rows, not a multiple of the {n_shards} "
                             f"shards")


def _per_shard(groups, values, n_shards: int) -> list:
    """Each group's [size, ...] tensor -> one tensor a shard, in shard
    order (views)."""
    out = [None] * n_shards
    for g, v in zip(groups, values):
        for i, part in zip(g.shards, torch.unbind(v, 0)):
            out[i] = part
    return out


def _replicas(groups, params: Dict) -> list:
    """The replicated parameters on each group's device (``to``: the
    gradient flows back to ``params``)."""
    return [tree_map(lambda w: w.to(g.device), params) for g in groups]


def _gather_h(hs, groups, n_shards: int, mesh, axes) -> list:
    """The tiled all_gather of the groups' node rows: one [N, d] copy on
    each group's device."""
    parts = _per_shard(groups, [h.reshape(g.size, -1, h.shape[-1])
                                for g, h in zip(groups, hs)], n_shards)
    full = all_gather(parts, mesh, axes)
    return [full[g.shards[0]] for g in groups]


def forward_graphcast_sharded(cfg: GNNConfig, sh: Shardings, params: Dict,
                              batch: Dict) -> torch.Tensor:
    """Graphcast with owner-computes edge partitioning.

    Input contract (the reference's): each shard owns N/P nodes and
    their *incoming* edges; ``edge_dst`` is shard-local, ``edge_src`` is
    global.  Per layer the only collective is one tiled all_gather of
    the node state for the src halo; aggregation is a local segment sum.
    Edge work runs in ``n_chunks`` checkpointed chunks (4 when the
    shard's edge count, the global count // mesh.size, divides by 4),
    layers in checkpointed blocks of 4 (each layer checkpointed too);
    the loss is the psum of (sse, cnt)."""
    axes = cfg.flat_axes(sh)
    mesh = sh.mesh
    groups, P = _groups(mesh, axes)
    _check_split(batch, ("node_feat", "edge_src", "edge_dst", "edge_feat",
                         "target", "loss_mask"), P)
    nl = batch["node_feat"].shape[0] // P
    e_local = batch["edge_src"].shape[0] // mesh.size
    n_chunks = 4 if e_local % 4 == 0 else 1
    ws = _replicas(groups, params)
    srcs, dsts, hs, es = [], [], [], []
    for g, w in zip(groups, ws):
        srcs.append(g.rows(batch["edge_src"], P).long())
        dsts.append(g.rows(batch["edge_dst"], P).long()
                    + g.offsets(e_local, nl))
        hs.append(_mlp(w["enc_node"],
                       g.rows(batch["node_feat"], P).to(cfg.dtype)))
        es.append(_mlp(w["enc_edge"],
                       g.rows(batch["edge_feat"], P).to(cfg.dtype)))

    def chunk(agg, h_full, h, lw, s_, d_, e_):
        msg = torch.cat([e_, _take(h_full, s_), _take(h, d_)], -1)
        e2_ = e_ + _mlp(lw["edge_mlp"], msg)
        return agg + _segment_sum(e2_, d_, agg.shape[0]), e2_

    G = len(groups)

    # the carries go to checkpoint as tensor arguments, never inside a
    # list: checkpoint keeps a non-tensor argument by reference, so a
    # list would hold every layer's carry alive through the backward pass
    def layer(li, *carry):
        hs, es = carry[:G], carry[G:]
        fulls = _gather_h(hs, groups, P, mesh, axes)
        h2s, e2s = [], []
        for g, w, h_full, h, e, src, dst in zip(groups, ws, fulls, hs, es,
                                                srcs, dsts):
            lw = {k: {n: x[li] for n, x in v.items()}
                  for k, v in w["layers"].items()}
            d = h.shape[-1]
            # chunk c of the group: chunk c of each of its shards
            pick = [x.reshape(g.size, n_chunks, -1, *x.shape[1:])
                    for x in (src, dst, e)]
            # (h * 0) is the reference's carry (a shard_map typing rule);
            # its value, NaN where h is, is kept
            agg = (h * 0).to(e.dtype)
            outs = []
            for c in range(n_chunks):
                s_, d_, e_ = (x[:, c].reshape(-1, *x.shape[3:])
                              for x in pick)
                agg, e2_ = _ckpt(chunk, agg, h_full, h, lw, s_, d_, e_)
                outs.append(e2_.reshape(g.size, -1, d))
            e2s.append(torch.stack(outs, 1).reshape(-1, d))
            h2s.append(h + _mlp(lw["node_mlp"], torch.cat([h, agg], -1)))
        return (*h2s, *e2s)

    def block(first, count, *carry):
        for li in range(first, first + count):
            carry = _ckpt(layer, li, *carry)
        return carry

    L = cfg.n_layers
    blk = 4 if L % 4 == 0 else 1
    carry = (*hs, *es)
    for first in range(0, L, blk):
        carry = _ckpt(block, first, blk, *carry)
    hs = carry[:G]
    parts = []
    for g, w, h in zip(groups, ws, hs):
        pred = _mlp(w["dec"], h)
        mask = g.rows(batch["loss_mask"], P).float()
        err = (pred.float() - g.rows(batch["target"], P).float()) ** 2
        sse = (err.mean(-1) * mask).reshape(g.size, nl).sum(1)
        parts.append(torch.stack([sse, mask.reshape(g.size, nl).sum(1)], 1))
    tot = psum(_per_shard(groups, parts, P), mesh, axes)[0]
    return tot[0] / torch.clamp(tot[1], min=1.0)


def forward_dimenet_sharded(cfg: GNNConfig, sh: Shardings, params: Dict,
                            batch: Dict) -> torch.Tensor:
    """DimeNet with partition-local triplets + owner-computes edges.

    Triplet indices reference edges *within the local shard* and
    ``edge_dst`` is shard-local, so the directional message stack and
    the edge->node reduction are collective-free; only the src halo (one
    all_gather of the raw features) and the final energy psum cross
    shards (the reference's contract)."""
    axes = cfg.flat_axes(sh)
    mesh = sh.mesh
    groups, P = _groups(mesh, axes)
    _check_split(batch, ("node_feat", "edge_src", "edge_dst", "edge_dist",
                         "tri_edge_kj", "tri_edge_ji", "tri_angle",
                         "graph_id"), P)
    nl = batch["node_feat"].shape[0] // P
    el = batch["edge_src"].shape[0] // P
    tl = batch["tri_edge_kj"].shape[0] // P
    n_graphs = batch["target_g"].shape[0]
    ws = _replicas(groups, params)
    xs = [g.rows(batch["node_feat"], P).to(cfg.dtype) for g in groups]
    x_full = _gather_h(xs, groups, P, mesh, axes)

    def layer(m, lw, sbf, rbf_g, t_kj, t_ji):
        mk = _take(_mlp(lw["proj_kj"], m), t_kj)           # local gather
        w = sbf @ lw["sbf_w"]
        tri = torch.einsum("tb,bdf,td->tf", w, lw["bilinear"], mk)
        agg = _segment_sum(tri, t_ji, m.shape[0])
        return m + _mlp(lw["msg_mlp"], m * rbf_g + agg)

    parts = []
    for g, w, xf in zip(groups, ws, x_full):
        src = g.rows(batch["edge_src"], P).long()
        dst = g.rows(batch["edge_dst"], P).long() + g.offsets(el, nl)
        t_kj = g.rows(batch["tri_edge_kj"], P).long() + g.offsets(tl, el)
        t_ji = g.rows(batch["tri_edge_ji"], P).long() + g.offsets(tl, el)
        rbf = _rbf(g.rows(batch["edge_dist"], P), cfg.n_radial).to(cfg.dtype)
        sbf = _sbf(g.rows(batch["tri_angle"], P), cfg.n_spherical,
                   cfg.n_radial).to(cfg.dtype)
        m = _mlp(w["embed"], torch.cat([_take(xf, src), rbf], -1))
        rbf_g = rbf @ w["rbf_w"]
        for lw in _unstack(w["layers"], cfg.n_layers):
            m = _ckpt(layer, m, lw, sbf, rbf_g, t_kj, t_ji)
        node_e = _segment_sum(m, dst, g.size * nl)         # local dst
        pred = _mlp(w["out"], node_e)
        gid = g.rows(batch["graph_id"], P).long() + g.offsets(nl, n_graphs)
        parts.append(_segment_sum(pred[:, 0], gid, g.size * n_graphs)
                     .reshape(g.size, n_graphs))
    energy = psum(_per_shard(groups, parts, P), mesh, axes)[0]
    err = (energy.float()
           - batch["target_g"].to(energy.device).float()) ** 2
    return torch.mean(err)


INIT = {"graphcast": init_graphcast, "dimenet": init_dimenet,
        "graphsage": init_graphsage, "gat": init_gat}
FORWARD = {"graphcast": forward_graphcast, "dimenet": forward_dimenet,
           "graphsage": forward_graphsage, "gat": forward_gat}
FORWARD_SHARDED = {"graphcast": forward_graphcast_sharded,
                   "dimenet": forward_dimenet_sharded}


def init_params(cfg: GNNConfig, generator: torch.Generator,
                device=None) -> Dict:
    """The reference's shapes, scales and dtypes, drawn from
    ``generator`` on ``device`` (default: the generator's)."""
    device = generator.device if device is None else torch.device(device)
    return INIT[cfg.arch](cfg, generator, device)


def forward_loss(cfg: GNNConfig, sh: Shardings, params: Dict,
                 batch: Dict) -> torch.Tensor:
    if (cfg.sharded and sh.mesh is not None
            and cfg.arch in FORWARD_SHARDED):
        return FORWARD_SHARDED[cfg.arch](cfg, sh, params, batch)
    return FORWARD[cfg.arch](cfg, sh, params, batch)
