"""The port's op analysis, dry runs and the kernels' ``meta`` route, on
the CPU.

``opanalysis.analyze`` counts a Python loop of L matmuls as L x 2mkn
FLOPs, leaves views out of ``bytes``, counts a cast in ``copy_bytes``,
counts a storage once however many views share it, and logs the mesh
collectives.  The matmul FLOPs it counts on ``meta`` for the reduced
granite-8b prefill and the reduced wide-deep serve step equal
``repro.launch.hloanalysis.analyze`` of the jitted reference step on the
CPU (rtol 1e-9); for the reduced train steps the ratio of the two
(recompute and the optimizer differ) is printed and held within [0.5,
2].  Every ``kernels.ops`` function's ``meta`` route gives the plain
version's output shapes and dtypes.  ``dryrun.run_cell`` on one cell of
each family gives an ``ok`` record with the documented keys and skips a
cell whose record exists; ``dryrun_disland.run`` serves one shard on
``meta``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import hloanalysis
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import recsys as jrecsys
from repro.models import transformer as jtransformer
from repro.models.common import Shardings as JShardings
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, dryrun_disland, steps, train
from repro_torch.launch.mesh import all_gather, make_host_mesh, psum
from repro_torch.launch.opanalysis import analyze
from repro_torch.models import recsys, transformer
from repro_torch.models.common import Shardings
from repro_torch.optim import adamw_init

torch.set_num_threads(1)
META = torch.device("meta")
SH, JSH = Shardings(None), JShardings(None)


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---- the op analysis ----------------------------------------------------------
@pytest.mark.parametrize("layers", [1, 3, 8])
def test_loop_of_matmuls_counts_every_iteration(layers):
    m, k = 48, 40

    def f(x, w):
        for _ in range(layers):
            x = x @ w
        return x
    ana = analyze(f, _m(m, k), _m(k, k))
    assert ana.flops == layers * 2 * m * k * k
    assert ana.unknown_trips == 0


def test_views_move_no_bytes_and_a_cast_is_a_copy():
    x = _m(64, 32)
    assert analyze(lambda t: (t.view(-1), t.t(), t[1:], t.reshape(32, 64)),
                   x).bytes == 0
    assert analyze(lambda t: t + 1.0, x).bytes == 2 * 64 * 32 * 4
    ana = analyze(lambda t: t.to(torch.bfloat16), x)
    assert ana.copy_bytes == 64 * 32 * 2
    assert analyze(lambda t: t * 2.0, x).copy_bytes == 0


def test_peak_counts_a_storage_once_and_frees_it():
    x = _m(1000)

    def f(t):
        y = t * 2.0                       # 4,000 bytes
        views = [y[1:], y.view(10, 100), y.t() if y.dim() == 2 else y]
        del y, views
        z = t * 3.0                       # reuses the freed room
        return z.sum()
    ana = analyze(f, x)
    assert ana.peak_live_bytes == 4000 + 4     # z, then the sum beside it


def test_mesh_collectives_are_logged():
    mesh = make_host_mesh((4,), ("d",), device="meta")
    parts = [_m(8, 16) for _ in range(4)]

    def f(ps):
        full = all_gather(ps, mesh, ("d",))
        return psum([p.sum(0) for p in ps], mesh, ("d",)), full
    ana = analyze(f, parts)
    assert ana.collectives == {"all-gather": 32 * 16 * 4,
                               "all-reduce": 16 * 4}
    assert ana.collective_counts == {"all-gather": 1, "all-reduce": 1}


# ---- matmul FLOPs against the reference's HLO count ---------------------------
def _jax_flops(fn, *args) -> float:
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    return hloanalysis.analyze(hlo).flops


def _lm_cfgs():
    spec = get_arch("granite-8b")
    cfg = dataclasses.replace(train.reduced_lm(spec.model_cfg),
                              attn_chunk=32)
    jspec = jtrain.get_arch("granite-8b")
    jcfg = dataclasses.replace(jtrain.reduced_lm(jspec.model_cfg),
                               attn_chunk=32)
    return cfg, jcfg


def _recsys_cfgs():
    cfg = train.reduced_recsys(get_arch("wide-deep").model_cfg)
    jcfg = jtrain.reduced_recsys(jtrain.get_arch("wide-deep").model_cfg)
    return cfg, jcfg


def _sds(tree):
    return jax.eval_shape(lambda: tree)


def _lm_prefill_flops():
    cfg, jcfg = _lm_cfgs()
    b, t = 2, 128
    params = transformer.init_params(cfg, torch.Generator(), META)
    got = analyze(steps.lm_prefill_step(cfg, SH), params,
                  _m(b, t, dtype=torch.int32)).flops
    jp = jax.eval_shape(lambda: jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0)))
    want = _jax_flops(jsteps.lm_prefill_step(jcfg, JSH), jp,
                      jax.ShapeDtypeStruct((b, t), jnp.int32))
    return got, want


def _recsys_batch(cfg, b, meta: bool):
    shapes = {"sparse_ids": ((b, cfg.n_sparse, cfg.hots_per_field), "int32"),
              "dense": ((b, cfg.n_dense), "float32")}
    if meta:
        return {k: _m(*s, dtype=getattr(torch, d))
                for k, (s, d) in shapes.items()}
    return {k: jax.ShapeDtypeStruct(s, jnp.dtype(d))
            for k, (s, d) in shapes.items()}


def _recsys_serve_flops():
    cfg, jcfg = _recsys_cfgs()
    params = recsys.init_params(cfg, torch.Generator(), META)
    got = analyze(steps.recsys_serve_step(cfg, SH), params,
                  _recsys_batch(cfg, 64, True)).flops
    jp = jax.eval_shape(lambda: jrecsys.init_params(
        jcfg, jax.random.PRNGKey(0)))
    want = _jax_flops(jsteps.recsys_serve_step(jcfg, JSH), jp,
                      _recsys_batch(jcfg, 64, False))
    return got, want


@pytest.mark.parametrize("step", ["granite-8b prefill", "wide-deep serve"])
def test_forward_matmul_flops_equal_the_hlo_count(step):
    got, want = (_lm_prefill_flops() if step == "granite-8b prefill"
                 else _recsys_serve_flops())
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-9)


def _lm_train_flops():
    cfg, jcfg = _lm_cfgs()
    b, t = 2, 128
    params = transformer.init_params(cfg, torch.Generator(), META)
    got = analyze(steps.lm_train_step(cfg, SH, 1), params,
                  adamw_init(params), _m(b, t, dtype=torch.int32)).flops
    jp = jax.eval_shape(lambda: jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0)))
    want = _jax_flops(jsteps.lm_train_step(jcfg, JSH, 1), jp,
                      jax.eval_shape(jadamw_init, jp),
                      jax.ShapeDtypeStruct((b, t), jnp.int32))
    return got, want


def _recsys_train_flops():
    cfg, jcfg = _recsys_cfgs()
    params = recsys.init_params(cfg, torch.Generator(), META)
    batch = dict(_recsys_batch(cfg, 64, True),
                 labels=_m(64, dtype=torch.int32))
    got = analyze(steps.recsys_train_step(cfg, SH), params,
                  adamw_init(params), batch).flops
    jp = jax.eval_shape(lambda: jrecsys.init_params(
        jcfg, jax.random.PRNGKey(0)))
    jbatch = dict(_recsys_batch(jcfg, 64, False),
                  labels=jax.ShapeDtypeStruct((64,), jnp.int32))
    want = _jax_flops(jsteps.recsys_train_step(jcfg, JSH), jp,
                      jax.eval_shape(jadamw_init, jp), jbatch)
    return got, want


@pytest.mark.parametrize("step", ["granite-8b train", "wide-deep train"])
def test_train_matmul_flops_against_the_hlo_count(step):
    got, want = (_lm_train_flops() if step == "granite-8b train"
                 else _recsys_train_flops())
    print(f"{step}: port {got:.6e} / reference HLO {want:.6e} = "
          f"{got / want:.6f}")
    assert 0.5 <= got / want <= 2.0


# ---- the kernels' meta route ---------------------------------------------------
def _ops_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.rand(s, generator=g)

    def ids(hi, *s):
        return torch.randint(0, hi, s, generator=g, dtype=torch.int32)
    q, D, t = r(10, 20), r(20, 30), r(10, 30)
    zeros = torch.zeros(300, dtype=torch.int64)
    return {
        "fw_batch_next reg": (ops.fw_batch_next, (r(3, 40, 40),), {}),
        "fw_batch_next blocked": (ops.fw_batch_next, (r(2, 100, 100),), {}),
        "fw_next": (ops.fw_next, (r(40, 40),), {}),
        "fw_batch": (ops.fw_batch, (r(3, 40, 40),), {}),
        "fw_apsp": (ops.fw_apsp, (r(100, 100),), {}),
        "minplus_twoside": (ops.minplus_twoside, (q, D, t), {}),
        "minplus_twoside_argmin": (ops.minplus_twoside_argmin, (q, D, t),
                                   {}),
        "minplus_twoside_grouped warp": (
            ops.minplus_twoside_grouped,
            (r(10, 5), zeros[:10], ids(20, 1, 5), D, r(10, 7), zeros[:10],
             ids(30, 1, 7)), {}),
        "minplus_twoside_grouped tiles": (
            ops.minplus_twoside_grouped,
            (r(300, 100), zeros, ids(20, 1, 100), D, r(300, 100), zeros,
             ids(30, 1, 100)), {}),
        "label_merge": (ops.label_merge, (q, q), {}),
        "label_merge_rows": (ops.label_merge_rows,
                             (t, ids(10, 7), ids(10, 7)), {}),
        "minplus": (ops.minplus, (q, D), {}),
        "minplus gemv": (ops.minplus, (r(1, 20), D), {}),
        "minplus_accum": (ops.minplus_accum, (t, q, D), {}),
        "minplus_accum_into": (ops.minplus_accum_into, (r(10, 30), q, D),
                               {"skip_rows": (2, 4)}),
    }


@pytest.mark.parametrize("case", list(_ops_cases()))
def test_meta_route_gives_the_plain_versions_outputs(case):
    fn, args, kw = _ops_cases()[case]
    want = fn(*args, force="ref", **kw)
    meta = [a.to(META) for a in args]
    got = fn(*meta, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g_, w in zip(got, want):
        assert (g_.device.type, tuple(g_.shape), g_.dtype) == (
            "meta", tuple(w.shape), w.dtype)
    # force="ref" on meta runs the plain version
    ref = fn(*meta, force="ref", **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert [tuple(x.shape) for x in ref] == [tuple(x.shape) for x in want]


def test_meta_panels_launch_nothing():
    c = torch.empty(8, 8, device=META)
    assert ops.minplus_accum_panels((c, c[:, :4], c[:4]),
                                    (c, c[:, :4], c[:4])) is None


# ---- dry runs ------------------------------------------------------------------
_KEYS = {"arch", "shape", "mesh", "n_chips", "ok", "lower_s", "memory",
         "analysis", "model_flops", "notes", "roofline"}


@pytest.mark.parametrize("arch,shape", [
    ("granite-moe-1b-a400m", "decode_32k"), ("dimenet", "molecule"),
    ("gat-cora", "full_graph_sm"), ("wide-deep", "serve_p99")])
def test_run_cell_records_and_resumes(arch, shape, tmp_path):
    rec = dryrun.run_cell(arch, shape, "single", str(tmp_path))
    assert rec["ok"], rec.get("traceback")
    assert set(rec) == _KEYS
    assert rec["n_chips"] == 256
    assert {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes_global", "temp_scope"} == set(rec["memory"])
    assert {"compute_s", "memory_s", "collective_s", "dominant",
            "model_vs_hlo_flops", "step_time_bound_s", "roofline_fraction",
            "card"} == set(rec["roofline"])
    assert rec["analysis"]["dot_flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    if arch == "dimenet":                 # the sharded halo path
        assert rec["analysis"]["collective_bytes"]["all-gather"] > 0
    path = tmp_path / f"{arch}__{shape}__single.json"
    on_disk = json.loads(path.read_text())
    on_disk["marker"] = 1
    path.write_text(json.dumps(on_disk))
    assert dryrun.run_cell(arch, shape, "single",
                           str(tmp_path))["marker"] == 1


def test_argument_bytes_follow_the_shardings(tmp_path):
    """wide-deep serve_p99: the [40M, 32] f32 table splits over 'model'
    (16), every other leaf is replicated or split over all 256."""
    rec = dryrun.run_cell("wide-deep", "serve_p99", "single", str(tmp_path))
    cfg = get_arch("wide-deep").model_cfg
    rows = cfg.n_sparse * cfg.rows_per_field
    d_in = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    dims = (d_in,) + cfg.mlp_dims + (1,)
    mlp = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    b = 512
    want = (rows * cfg.embed_dim * 4 // 16 + rows * 4 // 16
            + cfg.n_dense * 4 + mlp * 4 + 4
            + -(-b // 256) * (cfg.n_sparse * cfg.hots_per_field * 4
                              + cfg.n_dense * 4))
    assert rec["memory"]["argument_size_in_bytes"] == want


def test_main_runs_a_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "graphsage-reddit", "--shape", "molecule",
                        "--mesh", "both", "--out", str(tmp_path)]) == 0
    assert "done: 2/2 cells OK" in capsys.readouterr().out


def test_disland_serve_dry_run():
    rec = dryrun_disland.run("single")
    assert rec["q_per_shard"] == 131_072 // 256
    assert rec["flops_dev"] == 0 and rec["collective_bytes_dev"] == 0
    assert rec["fit_gb"] > rec["index_gb"] > 2.5
    assert 0 < rec["shard_peak_gb"] < rec["index_gb"]
