"""The port's training path against the reference package, on the CPU.

``tests/test_arch_smoke.py`` runs on the port (a train step of every
arch at reduced dims, prefill and decode of every LM arch; its
``test_all_cells_build_on_tiny_mesh`` waits for ``launch/cells.py``).
The data pipelines make the reference's arrays from the same seeds.
The train steps follow the reference's over 3 steps, on loss and grad
norm, with ``n_micro`` 1 and 2 (the LM), and for a GNN and the
recommender.  A reduced float32 ``repro.launch.train`` run of 2 steps
with ``--ckpt`` is resumed by ``repro_torch.launch.train --device cpu``
to 4 steps, with the reference's own resumed losses; the port's CLI
runs end to end and resumes itself.
"""
import dataclasses
import gc
import re
import shutil
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.graph import road_like as jroad_like
from repro.data import pipelines as jpipelines
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models import gnn as jgnn
from repro.models import recsys as jrecsys
from repro.models import transformer as jtransformer
from repro.optim import adamw_init as jadamw_init
from repro_torch import convert
from repro_torch.checkpoint.manager import tree_leaves
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.graph import road_like
from repro_torch.data import pipelines
from repro_torch.launch import steps, train
from repro_torch.models import gnn, recsys, transformer
from repro_torch.models.common import Shardings
from repro_torch.optim import AdamWState, adamw_init

torch.set_num_threads(1)

SH = Shardings(mesh=None)
JSH = jcommon.Shardings(mesh=None)


# ---- tests/test_arch_smoke.py, on the port ----------------------------------
def _reduced_lm(cfg):
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=128, dtype=torch.float32, attn_chunk=16,
        n_experts=4 if cfg.moe else 0, top_k=min(cfg.top_k, 2),
        gather_fsdp_in_body=False, seq_shard_activations=False)


def _reduced_gnn(cfg):
    return dataclasses.replace(cfg, n_layers=2, d_hidden=16, d_feat=8,
                               n_out=2, n_classes=5, sharded=False)


def _reduced_recsys(cfg):
    return dataclasses.replace(cfg, n_sparse=6, rows_per_field=100,
                               mlp_dims=(32, 16))


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("arch_id", list_archs())
def test_arch_smoke_train_step(arch_id):
    spec = get_arch(arch_id)
    gen = torch.Generator().manual_seed(0)
    if spec.family == "lm":
        cfg = _reduced_lm(spec.model_cfg)
        params = transformer.init_params(cfg, gen)
        step = steps.lm_train_step(cfg, SH, n_micro=2)
        tokens = torch.randint(0, cfg.vocab, (4, 32), generator=gen)
        p2, o2, metrics = step(params, adamw_init(params), tokens)
        assert np.isfinite(float(metrics["loss"]))
        assert _finite(p2)
        for a, b in zip(tree_leaves(params), tree_leaves(p2)):
            assert a.shape == b.shape
    elif spec.family == "gnn":
        cfg = _reduced_gnn(spec.model_cfg)
        params = gnn.init_params(cfg, gen)
        batch = {k: _t(v) for k, v in pipelines.gnn_molecule_batch(
            4, 10, 16, cfg.d_feat, seed=1).items()}
        batch["labels"] = batch["labels"] % cfg.n_classes
        batch["target"] = batch["target"][:, :1].repeat(1, cfg.n_out)
        step = steps.gnn_train_step(cfg, SH)
        p2, o2, metrics = step(params, adamw_init(params), batch)
        assert np.isfinite(float(metrics["loss"]))
        assert _finite(p2)
    else:
        cfg = _reduced_recsys(spec.model_cfg)
        params = recsys.init_params(cfg, gen)
        rng = np.random.default_rng(0)
        batch = {
            "sparse_ids": _t(rng.integers(
                0, cfg.rows_per_field,
                (8, cfg.n_sparse, cfg.hots_per_field)).astype(np.int32)),
            "dense": _t(rng.normal(size=(8, cfg.n_dense)).astype(np.float32)),
            "labels": _t(rng.integers(0, 2, 8).astype(np.int32)),
        }
        step = steps.recsys_train_step(cfg, SH)
        p2, o2, metrics = step(params, adamw_init(params), batch)
        assert np.isfinite(float(metrics["loss"]))
        assert _finite(p2)


@pytest.mark.parametrize("arch_id", [a for a in list_archs()
                                     if get_arch(a).family == "lm"])
def test_lm_smoke_prefill_decode(arch_id):
    cfg = _reduced_lm(get_arch(arch_id).model_cfg)
    gen = torch.Generator().manual_seed(1)
    params = transformer.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    logits, cache = transformer.prefill(cfg, SH, params, toks)
    assert logits.shape == (2, cfg.vocab_padded)
    assert torch.isfinite(logits).all()
    pad = (0, 0, 0, 0, 0, 4)
    cache = {"k": torch.nn.functional.pad(cache["k"], pad),
             "v": torch.nn.functional.pad(cache["v"], pad),
             "len": cache["len"]}
    logits2, cache = transformer.decode_step(cfg, SH, params, cache,
                                             toks[:, 0])
    assert logits2.shape == (2, cfg.vocab_padded)
    assert torch.isfinite(logits2).all()
    assert int(cache["len"]) == 13


def test_configs_match_the_reference():
    assert list_archs() == sorted(jget_arch(a).arch_id for a in list_archs())
    for a in list_archs():
        mine, ref = get_arch(a), jget_arch(a)
        assert (mine.family, mine.seqs_per_micro, mine.opt_state_dtype,
                mine.serialize_opt_update, mine.grad_accum_dtype) == (
            ref.family, ref.seqs_per_micro, ref.opt_state_dtype,
            ref.serialize_opt_update, ref.grad_accum_dtype)
        assert [dataclasses.asdict(s) for s in mine.shapes] == \
            [dataclasses.asdict(s) for s in ref.shapes]
        mc, rc = (dataclasses.asdict(mine.model_cfg),
                  dataclasses.asdict(ref.model_cfg))
        assert str(mc.pop("dtype")).split(".")[-1] == \
            np.dtype(rc.pop("dtype")).name
        assert mc == rc
        if mine.family == "lm":
            assert mine.model_cfg.n_params() == ref.model_cfg.n_params()
    assert get_arch("granite-moe-1b-a400m").model_cfg.n_params() \
        == 1_334_887_424


# ---- data pipelines ----------------------------------------------------------
def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def test_pipelines_make_the_reference_arrays():
    for x, y in zip(pipelines.lm_batches(2, 8, 100, seed=3),
                    jpipelines.lm_batches(2, 8, 100, seed=3)):
        np.testing.assert_array_equal(x, y)
        break
    ra = pipelines.recsys_batches(4, 3, 50, 2, seed=5)
    rb = jpipelines.recsys_batches(4, 3, 50, 2, seed=5)
    for _ in range(2):
        _same(next(ra), next(rb))
    _same(pipelines.gnn_molecule_batch(3, 8, 12, 4, seed=7),
          jpipelines.gnn_molecule_batch(3, 8, 12, 4, seed=7))
    _same(pipelines.gnn_full_batch(road_like(300, seed=2), 6, 5, seed=1,
                                   n_out=3),
          jpipelines.gnn_full_batch(jroad_like(300, seed=2), 6, 5, seed=1,
                                    n_out=3))
    g, jg = road_like(800, seed=13), jroad_like(800, seed=13)
    s = pipelines.NeighborSampler(g, fanouts=(5, 3), d_feat=8, n_classes=4)
    js = jpipelines.NeighborSampler(jg, fanouts=(5, 3), d_feat=8,
                                    n_classes=4)
    seeds = np.random.default_rng(0).integers(0, g.n, 16)
    for _ in range(2):
        _same(s.sample(seeds), js.sample(seeds))


def test_neighbor_sampler_produces_valid_subgraph():
    g = road_like(800, seed=13)
    samp = pipelines.NeighborSampler(g, fanouts=(5, 3), d_feat=8,
                                     n_classes=4)
    batch = samp.sample(np.random.default_rng(0).integers(0, g.n, 16))
    n = batch["node_feat"].shape[0]
    assert batch["edge_src"].max() < n
    assert batch["edge_dst"].max() < n
    assert batch["loss_mask"].sum() == 16
    assert batch["labels"].shape == (n,)


def test_grid_queries_bucketed():
    from repro_torch.data import grid_distance_queries
    g = road_like(2000, seed=14)
    qs = grid_distance_queries(g, n_per_set=20, n_sets=6, seed=0)
    assert set(qs) == set(range(1, 7))
    for i, pairs in qs.items():
        assert pairs.shape[1] == 2


def test_generators_deterministic():
    a = next(pipelines.lm_batches(2, 8, 100, seed=3))
    b = next(pipelines.lm_batches(2, 8, 100, seed=3))
    np.testing.assert_array_equal(a, b)
    ra = next(pipelines.recsys_batches(4, 3, 50, 2, seed=5))
    rb = next(pipelines.recsys_batches(4, 3, 50, 2, seed=5))
    np.testing.assert_array_equal(ra["sparse_ids"], rb["sparse_ids"])
    m = pipelines.gnn_molecule_batch(3, 8, 12, 4, seed=7)
    assert m["node_feat"].shape == (24, 4)


# ---- train steps against the reference ---------------------------------------
def _port_state(pj):
    p = convert.tree_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    return p, adamw_init(p)


def _run_both(jstep, tstep, pj, batches):
    """3 steps of each package from the same parameters: (loss, grad
    norm) per step, reference then port."""
    jp, jo = pj, jadamw_init(pj)
    tp, to = _port_state(pj)
    out = []
    for jb, tb in batches:
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        out.append(((float(jm["loss"]), float(jm["grad_norm"])),
                    (float(tm["loss"]), float(tm["grad_norm"]))))
    assert isinstance(to, AdamWState) and int(to.step) == len(batches)
    return out


def _check(out):
    for (jl, jg), (tl, tg) in out:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-4)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_lm_train_step_follows_reference(n_micro, moe):
    kw = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab=200, attn_chunk=8, moe=moe,
              n_experts=4 if moe else 0, top_k=2 if moe else 0)
    cfgj = jtransformer.LMConfig(**kw, dtype=jnp.float32)
    cfgt = transformer.LMConfig(**kw, dtype=torch.float32)
    pj = jtransformer.init_params(cfgj, jax.random.PRNGKey(30))
    data = jpipelines.lm_batches(4, 16, 200, seed=30)
    batches = [(jnp.asarray(b), _t(b)) for b, _ in zip(data, range(3))]
    jstep = jax.jit(jsteps.lm_train_step(cfgj, JSH, n_micro=n_micro))
    tstep = steps.lm_train_step(cfgt, SH, n_micro=n_micro)
    _check(_run_both(jstep, tstep, pj, batches))


def test_gnn_and_recsys_train_steps_follow_reference():
    kw = dict(name="g", arch="gat", n_layers=2, d_hidden=8, d_feat=6,
              n_classes=4, n_heads=2)
    cfgj, cfgt = jgnn.GNNConfig(**kw), gnn.GNNConfig(**kw)
    b = pipelines.gnn_full_batch(road_like(150, seed=3), 6, 4, seed=3)
    pj = jgnn.init_params(cfgj, jax.random.PRNGKey(31))
    batch = ({k: jnp.asarray(v) for k, v in b.items()},
             {k: _t(v) for k, v in b.items()})
    _check(_run_both(jax.jit(jsteps.gnn_train_step(cfgj, JSH)),
                     steps.gnn_train_step(cfgt, SH), pj, [batch] * 3))
    kw = dict(name="r", n_sparse=4, rows_per_field=50, embed_dim=4,
              mlp_dims=(16, 8))
    cfgj, cfgt = jrecsys.RecsysConfig(**kw), recsys.RecsysConfig(**kw)
    pj = jrecsys.init_params(cfgj, jax.random.PRNGKey(32))
    data = pipelines.recsys_batches(16, 4, 50, 2, seed=32)
    batches = [({k: jnp.asarray(v) for k, v in d.items()},
                {k: _t(v) for k, v in d.items()})
               for d, _ in zip(data, range(3))]
    _check(_run_both(jax.jit(jsteps.recsys_train_step(cfgj, JSH)),
                     steps.recsys_train_step(cfgt, SH), pj, batches))


def test_train_step_updates_in_place():
    """A step reuses its inputs' buffers, as the reference driver's
    donated jit step does: same tensors back, new values in them."""
    cfg = _reduced_lm(get_arch("granite-8b").model_cfg)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(5))
    opt = adamw_init(params)
    before = (params["embed"].clone(), opt.m["embed"].clone())
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(6))
    p2, o2, _ = steps.lm_train_step(cfg, SH, n_micro=1)(params, opt, tokens)
    assert all(a is b for a, b in zip(tree_leaves((p2, o2)),
                                      tree_leaves((params, opt))))
    assert not torch.equal(before[0], p2["embed"])
    assert not torch.equal(before[1], o2.m["embed"])
    assert int(o2.step) == 1


def test_a_finished_run_frees_its_state():
    """With the cyclic garbage collector off, a run's parameters and
    moments go as soon as the caller drops them: no reference cycle
    holds a tree's leaves (on the card that is GBs held into the next
    run)."""
    gc.collect()
    gc.disable()
    try:
        res = train.main(["--arch", "wide-deep", "--reduced", "--steps", "2",
                          "--device", "cpu"])
        alive = [weakref.ref(res["params"]["table"]),
                 weakref.ref(res["opt"].m["table"])]
        del res
        assert [w() is None for w in alive] == [True, True]
    finally:
        gc.enable()


def test_constrain_tree_is_identity():
    tree = {"a": torch.ones(2)}
    assert steps.constrain_tree(tree, {"a": (None,)}, SH) is tree


# ---- the CLI -----------------------------------------------------------------
def _ref_main(monkeypatch, capsys, argv) -> str:
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()
    return capsys.readouterr().out


def test_port_resumes_a_reference_run(tmp_path, monkeypatch, capsys):
    """repro.launch.train writes a float32 checkpoint at step 2; the
    reference and the port each resume a copy of it to step 4."""
    args = ["--arch", "granite-moe-1b-a400m", "--reduced", "--batch", "2",
            "--seq", "16", "--ckpt-every", "100"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _ref_main(monkeypatch, capsys, args + ["--steps", "2", "--ckpt",
                                           str(ref_dir)])
    shutil.copytree(ref_dir, port_dir)
    out = _ref_main(monkeypatch, capsys, args + ["--steps", "4", "--ckpt",
                                                 str(ref_dir)])
    assert "restored step 2" in out
    first, last = map(float, re.search(r"loss: first=(\S+) last=(\S+)",
                                       out).groups())
    res = train.main(args + ["--steps", "4", "--ckpt", str(port_dir),
                             "--device", "cpu"])
    assert "restored step 2" in capsys.readouterr().out
    assert res["start"] == 2 and len(res["losses"]) == 2
    # the reference prints 4 decimals
    np.testing.assert_allclose(res["losses"], [first, last], atol=1e-4)
    # both wrote step 4; the port's state has the reference's layout
    jcfg = jtrain.reduced_lm(jget_arch("granite-moe-1b-a400m").model_cfg)
    jp = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    from repro.checkpoint import CheckpointManager as JCheckpointManager
    step, (rp, ro) = JCheckpointManager(str(port_dir)).restore(
        (jp, jadamw_init(jp)))
    assert step == 4 and int(ro.step) == 4
    for a, b in zip(jax.tree_util.tree_leaves(rp),
                    tree_leaves(res["params"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_port_cli_runs_and_resumes_itself(tmp_path, capsys):
    args = ["--arch", "wide-deep", "--reduced", "--batch", "16",
            "--ckpt", str(tmp_path), "--ckpt-every", "2", "--device", "cpu"]
    first = train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "straggler summary:" in out
    assert re.search(r"loss: first=\S+ last=\S+", out)
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()) \
        == [2, 3]
    again = train.main(args + ["--steps", "5"])
    assert "restored step 3" in capsys.readouterr().out
    assert again["start"] == 3 and len(again["losses"]) == 2
    assert all(np.isfinite(first["losses"] + again["losses"]))
    if not torch.cuda.is_available():       # the default device is cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "wide-deep", "--reduced", "--steps", "1"])
