"""Cell assembly: (arch x shape x mesh) -> a step and its arguments,
allocating nothing.

Port of ``repro/launch/cells.py``.  A ``CellBundle`` carries the step
callable, its arguments as ``meta`` tensors (the counterpart of the
reference's ``ShapeDtypeStruct``s and ``jax.eval_shape``: parameters
come from each family's ``init_params`` on ``meta``) and the
reference's shardings as the port's ``NamedSharding`` trees, with
``donate_argnums``, ``model_flops`` and ``notes`` as the reference sets
them.  ``launch/dryrun.py`` runs ``fn(*args)`` once on ``meta`` under
the op analysis.  graphcast and dimenet cells take the sharded
(``shard_map``) forwards in bf16, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..configs import get_arch
from ..configs.api import ArchSpec, ShapeCell
from ..models import gnn, recsys, transformer
from ..models.common import NamedSharding, Shardings
from ..optim import AdamWState, adamw_init
from . import flops, steps

META = torch.device("meta")


@dataclasses.dataclass
class CellBundle:
    arch_id: str
    shape_name: str
    kind: str
    fn: Any
    args: Tuple
    in_shardings: Tuple
    donate_argnums: Tuple[int, ...]
    model_flops: float
    notes: str = ""


def _sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor: the port's ``ShapeDtypeStruct``."""
    return torch.empty(shape, dtype=dtype, device=META)


def _named(sh: Shardings, spec_tree):
    """Partition specs (tuple leaves of a dict tree) -> NamedShardings."""
    if isinstance(spec_tree, dict):
        return {k: _named(sh, v) for k, v in spec_tree.items()}
    return NamedSharding(sh.mesh, spec_tree)


def _replicated_like(sh: Shardings, tree):
    if isinstance(tree, dict):
        return {k: _replicated_like(sh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replicated_like(sh, v) for v in tree)
    return NamedSharding(sh.mesh, sh.spec())


def _params_struct(family, cfg):
    return family.init_params(cfg, torch.Generator(), device=META)


def _opt_sharding(sh: Shardings, m, v) -> AdamWState:
    return AdamWState(m=m, v=v, step=NamedSharding(sh.mesh, sh.spec()))


def build_cell(arch_id: str, shape_name: str, mesh) -> CellBundle:
    spec = get_arch(arch_id)
    cell = spec.shape(shape_name)
    sh = Shardings(mesh=mesh)
    if spec.family == "lm":
        return _build_lm(spec, cell, sh)
    if spec.family == "gnn":
        return _build_gnn(spec, cell, sh)
    return _build_recsys(spec, cell, sh)


# ---------------------------------------------------------------------------
def _dp_size(sh: Shardings) -> int:
    out = 1
    for a in (sh.dp or ()):
        out *= sh.axis_size(a)
    return out


def _flat_axes(sh: Shardings):
    return tuple(sh.mesh.axis_names)


def _build_lm(spec: ArchSpec, cell: ShapeCell, sh: Shardings) -> CellBundle:
    cfg: transformer.LMConfig = spec.model_cfg
    d = cell.dims
    b, t = d["global_batch"], d["seq_len"]
    pstruct = _params_struct(transformer, cfg)
    pshard = _named(sh, transformer.param_specs(cfg, sh))
    mf = flops.model_flops(spec, cell)
    dp = _dp_size(sh)
    batch_shardable = b % dp == 0 and b >= dp

    if cell.kind == "train":
        n_micro = max(1, (b // dp) // spec.seqs_per_micro)
        fn = steps.lm_train_step(
            cfg, sh, n_micro, serialize_update=spec.serialize_opt_update,
            accum_dtype=getattr(torch, spec.grad_accum_dtype))
        ostruct = adamw_init(pstruct, getattr(torch, spec.opt_state_dtype))
        # m/v shardings: FSDP-sharded even under ZeRO-1 (params may
        # replicate over data while opt state stays sharded); step repl.
        oshard_specs = _named(sh, transformer.param_specs(
            cfg, sh, for_opt_state=True))
        oshard = _opt_sharding(sh, oshard_specs, oshard_specs)
        tokens = _sds((b, t), torch.int32)
        tshard = NamedSharding(sh.mesh, sh.spec(sh.dp, None))
        return CellBundle(spec.arch_id, cell.name, cell.kind, fn,
                          (pstruct, ostruct, tokens),
                          (pshard, oshard, tshard),
                          donate_argnums=(0, 1), model_flops=mf,
                          notes=f"n_micro={n_micro}")

    if cell.kind == "prefill":
        fn = steps.lm_prefill_step(cfg, sh)
        tokens = _sds((b, t), torch.int32)
        tshard = NamedSharding(
            sh.mesh, sh.spec(sh.dp if batch_shardable else None, None))
        return CellBundle(spec.arch_id, cell.name, cell.kind, fn,
                          (pstruct, tokens), (pshard, tshard),
                          donate_argnums=(), model_flops=mf)

    # decode
    fn = steps.lm_decode_step(cfg, sh)
    shard_seq = bool(d.get("shard_seq", 0)) or not batch_shardable
    cspec = transformer.cache_specs(cfg, sh, b, t, shard_seq=shard_seq)
    cstruct = {k: _sds(*v[0]) for k, v in cspec.items()}
    cshard = {k: NamedSharding(sh.mesh, v[1]) for k, v in cspec.items()}
    token = _sds((b,), torch.int32)
    tokshard = NamedSharding(
        sh.mesh, sh.spec(sh.dp if batch_shardable else None))
    return CellBundle(spec.arch_id, cell.name, cell.kind, fn,
                      (pstruct, cstruct, token),
                      (pshard, cshard, tokshard),
                      donate_argnums=(1,), model_flops=mf,
                      notes=f"shard_seq={shard_seq}")


# ---------------------------------------------------------------------------
_GNN_KEYS = {
    "graphcast": ("node_feat", "edge_src", "edge_dst", "edge_feat",
                  "target", "loss_mask"),
    "dimenet": ("node_feat", "edge_src", "edge_dst", "edge_dist",
                "tri_edge_kj", "tri_edge_ji", "tri_angle", "graph_id",
                "target_g"),
    "graphsage": ("node_feat", "edge_src", "edge_dst", "labels",
                  "loss_mask"),
    "gat": ("node_feat", "edge_src", "edge_dst", "labels", "loss_mask"),
}


def gnn_cell_config(spec: ArchSpec, cell: ShapeCell) -> gnn.GNNConfig:
    """The cell's model config: the shape's d_feat; graphcast and dimenet
    take the sharded halo path on device meshes, in bf16 (the all_gather
    working set halves)."""
    base: gnn.GNNConfig = spec.model_cfg
    sharded = base.arch in ("graphcast", "dimenet")
    return dataclasses.replace(
        base, d_feat=cell.dims["d_feat"], sharded=sharded,
        dtype=torch.bfloat16 if sharded else base.dtype)


def _build_gnn(spec: ArchSpec, cell: ShapeCell, sh: Shardings) -> CellBundle:
    cfg = gnn_cell_config(spec, cell)
    d = cell.dims
    n, e, g_ = d["n_nodes"], d["n_edges"], d["n_graphs"]
    t3 = 2 * e
    flat = _flat_axes(sh)
    f32, i32 = torch.float32, torch.int32
    full = {
        "node_feat": (((n, cfg.d_feat), f32), (flat, None)),
        "edge_src": (((e,), i32), (flat,)),
        "edge_dst": (((e,), i32), (flat,)),
        "edge_feat": (((e, cfg.d_edge), f32), (flat, None)),
        "edge_dist": (((e,), f32), (flat,)),
        "labels": (((n,), i32), (flat,)),
        "loss_mask": (((n,), f32), (flat,)),
        "target": (((n, cfg.n_out), f32), (flat, None)),
        "graph_id": (((n,), i32), (flat,)),
        "target_g": (((g_,), f32), (None,)),
        "tri_edge_kj": (((t3,), i32), (flat,)),
        "tri_edge_ji": (((t3,), i32), (flat,)),
        "tri_angle": (((t3,), f32), (flat,)),
    }
    keys = _GNN_KEYS[cfg.arch]
    bstruct = {k: _sds(*full[k][0]) for k in keys}
    bshard = {k: NamedSharding(sh.mesh, sh.spec(*full[k][1]))
              for k in keys}
    pstruct = _params_struct(gnn, cfg)
    pshard = _replicated_like(sh, pstruct)
    ostruct = adamw_init(pstruct)
    oshard = _opt_sharding(sh, _replicated_like(sh, pstruct),
                           _replicated_like(sh, pstruct))
    fn = steps.gnn_train_step(cfg, sh)
    return CellBundle(spec.arch_id, cell.name, cell.kind, fn,
                      (pstruct, ostruct, bstruct),
                      (pshard, oshard, bshard),
                      donate_argnums=(0, 1),
                      model_flops=flops.model_flops(spec, cell),
                      notes=f"padded n={n} e={e}")


# ---------------------------------------------------------------------------
def _build_recsys(spec: ArchSpec, cell: ShapeCell,
                  sh: Shardings) -> CellBundle:
    cfg: recsys.RecsysConfig = spec.model_cfg
    d = cell.dims
    b = d["batch"]
    flat = _flat_axes(sh)
    pstruct = _params_struct(recsys, cfg)
    pshard = _named(sh, recsys.param_specs(cfg, sh))
    mf = flops.model_flops(spec, cell)
    if cell.kind == "retrieval":
        fn = steps.recsys_retrieval_step(cfg, sh)
        bstruct = {
            "sparse_ids": _sds((1, cfg.n_sparse, cfg.hots_per_field),
                               torch.int32),
            "dense": _sds((1, cfg.n_dense), torch.float32),
            "candidates": _sds((d["n_candidates"], cfg.mlp_dims[-1]),
                               torch.float32),
        }
        bshard = {
            "sparse_ids": NamedSharding(sh.mesh, sh.spec()),
            "dense": NamedSharding(sh.mesh, sh.spec()),
            "candidates": NamedSharding(sh.mesh, sh.spec(flat, None)),
        }
        return CellBundle(spec.arch_id, cell.name, cell.kind, fn,
                          (pstruct, bstruct), (pshard, bshard),
                          donate_argnums=(), model_flops=mf)
    batch_axes = sh.dp if cell.kind == "train" else flat
    bstruct = {
        "sparse_ids": _sds((b, cfg.n_sparse, cfg.hots_per_field),
                           torch.int32),
        "dense": _sds((b, cfg.n_dense), torch.float32),
    }
    bshard = {
        "sparse_ids": NamedSharding(sh.mesh, sh.spec(batch_axes, None,
                                                     None)),
        "dense": NamedSharding(sh.mesh, sh.spec(batch_axes, None)),
    }
    if cell.kind == "train":
        bstruct["labels"] = _sds((b,), torch.int32)
        bshard["labels"] = NamedSharding(sh.mesh, sh.spec(batch_axes))
        ostruct = adamw_init(pstruct)
        oshard = _opt_sharding(sh, pshard, _named(
            sh, recsys.param_specs(cfg, sh)))
        fn = steps.recsys_train_step(cfg, sh)
        return CellBundle(spec.arch_id, cell.name, cell.kind, fn,
                          (pstruct, ostruct, bstruct),
                          (pshard, oshard, bshard), donate_argnums=(0, 1),
                          model_flops=mf)
    fn = steps.recsys_serve_step(cfg, sh)
    return CellBundle(spec.arch_id, cell.name, cell.kind, fn,
                      (pstruct, bstruct), (pshard, bshard),
                      donate_argnums=(), model_flops=mf)
