"""Sharded serving and build of the port against the reference package.

``serve_sharded`` and ``serve_jit`` on CPU meshes (4, 2), (8,) and
(1, 1), at batch sizes 0, 1, 30, 33 and 64, are array-equal to the
port's ``serve_step`` and to the reference's ``serve_step`` on the
whole batch, and within 1e-3 of the reference's ``DislandEngine``, on
``road_like(900, seed=31)`` (the reference's multi-device test graph,
dense), on ``road_like(1400, seed=23)`` at 3 levels, and on the dense
index the reference built, carried across by
``convert.device_index_from_numpy``.  The reference's own
``serve_sharded`` is not a reference here: it does not run under the
pinned JAX (``shard_map`` rejects its ``fori_loop`` carry).

``fw_fragments_sharded`` equals the port's ``frag_apsp`` and the
reference's ``ops.fw_batch``; ``super_apsp_sharded`` equals the dense
``d_super[:S, :S]`` (or the blocked APSP of the overlay on the
hierarchical index) and the reference's ``sssp.apsp_from_sources``.
The port's Bellman-Ford equals Dijkstra, its padding edges are inert,
source chunking and the fixpoint test's stride change nothing, and a
``max_iters`` cut equals the reference's.  ``make_host_mesh`` raises on
``cuda`` without a card; the serve CLI's ``--mode fused|sharded`` runs
and answers as the planner does; its four planner-only flags are
refused in the other modes.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_engine as jde
from repro.core import graph as jgraph
from repro.core import sssp as jsssp
from repro.core.engine import DislandEngine as JDislandEngine
from repro.core.supergraph import build_index as jbuild_index
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra, sssp
from repro_torch.core.dist_engine import (fw_fragments_sharded,
                                          serve_jit, serve_sharded,
                                          super_apsp_sharded)
from repro_torch.core.graph import road_like
from repro_torch.core.supergraph import build_index
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve

torch.set_num_threads(1)

MESHES = {"4x2": ((4, 2), ("data", "model")), "8": ((8,), ("data",)),
          "1x1": ((1, 1), ("data", "model"))}
SIZES = (0, 1, 30, 33, 64)
#: (graph, seed, hierarchy levels, index built by the reference)
WORLDS = {"dense": (900, 31, 1, False), "levels3": (1400, 23, 3, False),
          "jax_built": (900, 31, 1, True)}


def _pairs(g, plan, seed=0):
    """64 pairs, shuffled: random ones, s == t, same-DRA and
    same-fragment pairs, so every shard sees a mix of cases."""
    rng = np.random.default_rng(seed)
    s, t = list(rng.integers(0, g.n, 42)), list(rng.integers(0, g.n, 42))
    s += [3, 11]
    t += [3, 11]
    for gid in range(10):
        m = plan.piece_members[gid]
        s.append(m[0])
        t.append(m[-1])
    frag = plan.frag_of[plan.agent_of]
    for f in range(10):
        nodes = np.nonzero(frag == f)[0]
        s.append(nodes[0])
        t.append(nodes[-1])
    perm = rng.permutation(len(s))
    return np.asarray(s, np.int64)[perm], np.asarray(t, np.int64)[perm]


@functools.cache
def _build(name):
    n, seed, lv, jax_built = WORLDS[name]
    g = road_like(n, seed=seed)
    ix = build_index(g)
    dix, plan = tde.build_device_index_with_plan(ix, device="cpu",
                                                 hierarchy_levels=lv)
    jix = jbuild_index(jgraph.road_like(n, seed=seed))
    jdix = jde.build_device_index(jix, hierarchy_levels=lv)
    if jax_built:
        fields = {name: np.asarray(getattr(jdix, name))
                  for name in tde.FIELD_DTYPES}
        fields.update({name: [np.asarray(x) for x in getattr(jdix, name)]
                       for name in tde.TUPLE_FIELD_DTYPES})
        fields.update({name: getattr(jdix, name, None)
                       for name in convert.SIDECARS})
        dix = convert.device_index_from_numpy(fields, "cpu")
    assert dix.hierarchy_levels == lv
    s, t = _pairs(g, plan)
    return {
        "g": g, "dix": dix, "plan": plan, "jdix": jdix, "s": s, "t": t,
        "port": tde.serve_step(dix, torch.from_numpy(s),
                               torch.from_numpy(t)).numpy(),
        "jax": np.asarray(jde.serve_step(jdix, jnp.asarray(s, jnp.int32),
                                         jnp.asarray(t, jnp.int32))),
        "engine": JDislandEngine(jix).query_many(np.stack([s, t], 1))}


@pytest.fixture(scope="module", params=list(WORLDS))
def world(request):
    return _build(request.param)


def _mesh(name):
    shape, axes = MESHES[name]
    return tmesh.make_host_mesh(shape, axes, device="cpu")


@pytest.mark.parametrize("fn", ["serve_sharded", "serve_jit"])
@pytest.mark.parametrize("q", SIZES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_serve_matches_serve_step(world, mesh_name, q, fn):
    mesh = _mesh(mesh_name)
    s, t = world["s"][:q], world["t"][:q]
    if fn == "serve_sharded":
        out = serve_sharded(mesh, world["dix"], s, t)
    else:
        out = serve_jit(mesh, world["dix"])(torch.from_numpy(s),
                                            torch.from_numpy(t))
    assert out.dtype == torch.float32 and out.device == mesh.devices[0]
    got = out.numpy()
    assert got.shape == (q,)
    np.testing.assert_array_equal(got, world["port"][:q])
    np.testing.assert_array_equal(got, world["jax"][:q])
    want = world["engine"][:q]
    fin = np.isfinite(want)
    assert (np.isinf(got) == ~fin).all()
    assert np.abs(got[fin] - want[fin]).max(initial=0.0) < 1e-3
    oracle = np.array([dijkstra.pair(world["g"], int(a), int(b))
                       for a, b in zip(s[:8], t[:8])], np.float32)
    np.testing.assert_array_equal(got[:8], oracle)


def test_sharded_serve_over_one_axis_of_two(world):
    """A batch split over "data" alone on the (4, 2) mesh (4 shards,
    the "model" axis replicated) answers as the whole batch does."""
    mesh = _mesh("4x2")
    assert len(mesh.shard_devices(("data",))) == 4
    got = serve_sharded(mesh, world["dix"], world["s"], world["t"],
                        batch_axes=("data",)).numpy()
    np.testing.assert_array_equal(got, world["port"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fw_fragments_sharded_matches_tables(world, mesh_name):
    adj = world["plan"].frag_adj
    got = fw_fragments_sharded(_mesh(mesh_name), adj)
    np.testing.assert_array_equal(got.numpy(), world["dix"].frag_apsp.numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.fw_batch(jnp.asarray(adj))))


def _directed(plan):
    """The SUPER slots in both directions (each is stored once)."""
    return (np.concatenate([plan.sup_src, plan.sup_dst]),
            np.concatenate([plan.sup_dst, plan.sup_src]),
            np.concatenate([plan.sup_w, plan.sup_w]))


def test_super_apsp_sharded_matches_tables(world):
    plan, dix = world["plan"], world["dix"]
    src, dst, w = _directed(plan)
    S = plan.S
    got = super_apsp_sharded(_mesh("4x2"), src, dst, w, S)
    assert got.shape == (S, S)
    if dix.hierarchy_levels == 1:
        np.testing.assert_array_equal(got.numpy(),
                                      dix.d_super[:S, :S].numpy())
    want = ops.fw_apsp(torch.from_numpy(tde.super_overlay(plan)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jgot = jsssp.apsp_from_sources(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
        jnp.arange(S, dtype=jnp.int32), n=S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_super_apsp_sharded_on_every_mesh(mesh_name):
    world = _build("dense")
    plan = world["plan"]
    got = super_apsp_sharded(_mesh(mesh_name), *_directed(plan), plan.S)
    np.testing.assert_array_equal(
        got.numpy(), world["dix"].d_super[:plan.S, :plan.S].numpy())


# ---- Bellman-Ford (mirrors tests/test_substrate.py:153-175) ---------------
def _road_edges(g):
    return (torch.from_numpy(np.concatenate([g.edge_u, g.edge_v])),
            torch.from_numpy(np.concatenate([g.edge_v, g.edge_u])),
            torch.from_numpy(np.concatenate([g.edge_w, g.edge_w])
                             .astype(np.float32)))


def test_bellman_ford_matches_dijkstra():
    g = road_like(600, seed=11)
    src, dst, w = _road_edges(g)
    sources = [0, 5, 17]
    got = sssp.apsp_from_sources(src, dst, w, torch.tensor(sources),
                                 n=g.n).numpy()
    for i, s in enumerate(sources):
        np.testing.assert_array_equal(got[i],
                                      dijkstra.sssp(g, s).astype(np.float32))
    jgot = jsssp.apsp_from_sources(
        jnp.asarray(src.numpy(), jnp.int32), jnp.asarray(dst.numpy(),
                                                         jnp.int32),
        jnp.asarray(w.numpy()), jnp.asarray(sources, jnp.int32), n=g.n)
    np.testing.assert_array_equal(got, np.asarray(jgot))


def test_bellman_ford_padding_edges_are_inert():
    src = torch.tensor([0, 1, 0], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0], dtype=torch.int32)
    w = torch.tensor([1.0, 2.0, float("inf")])
    out = sssp.bellman_ford(src, dst, w, sssp.sources_init(
        torch.tensor([0], dtype=torch.int32), 3), n=3)
    np.testing.assert_array_equal(out.numpy()[0], [0.0, 1.0, 3.0])


@pytest.mark.parametrize("rows", [1, 2, 7, 64])
def test_source_chunking_changes_nothing(monkeypatch, rows):
    g = road_like(500, seed=3)
    src, dst, w = _road_edges(g)
    sources = torch.arange(0, g.n, 37)
    whole = sssp.apsp_from_sources(src, dst, w, sources, n=g.n)
    monkeypatch.setattr(sssp, "CHUNK_BYTES",
                        rows * sssp._CELL_BYTES * src.numel())
    chunked = sssp.apsp_from_sources(src, dst, w, sources, n=g.n)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("max_iters", [1, 3, 5, 9])
def test_bellman_ford_max_iters_matches_reference(max_iters):
    """A cut short of the fixpoint stops after exactly ``max_iters``
    sweeps, whatever the fixpoint test's stride."""
    g = road_like(300, seed=5)
    src, dst, w = _road_edges(g)
    init = sssp.sources_init(torch.tensor([0, 9, 40]), g.n)
    got = sssp.bellman_ford(src, dst, w, init, n=g.n, max_iters=max_iters)
    want = jsssp.bellman_ford(
        jnp.asarray(src.numpy(), jnp.int32), jnp.asarray(dst.numpy(),
                                                         jnp.int32),
        jnp.asarray(w.numpy()), jnp.asarray(init.numpy()), n=g.n,
        max_iters=max_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bellman_ford_empty_sources():
    out = sssp.apsp_from_sources(torch.tensor([0]), torch.tensor([1]),
                                 torch.tensor([1.0]),
                                 torch.zeros(0, dtype=torch.long), n=2)
    assert out.shape == (0, 2)


# ---- meshes ---------------------------------------------------------------
def test_make_host_mesh_raises_on_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_host_mesh((1,), ("data",), device="cuda")


def test_make_host_mesh_raises_for_more_cards_than_exist(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tmesh.make_host_mesh()
    assert mesh.shape == (2, 1)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tmesh.make_host_mesh(axes=("data",)).shape == (2,)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        tmesh.make_host_mesh((4, 1))


def test_cpu_mesh_repeats_the_cpu():
    assert tmesh.make_host_mesh(device="cpu").shape == (1, 1)
    assert tmesh.make_host_mesh(axes=("d",), device="cpu").shape == (1,)
    mesh = tmesh.make_host_mesh((4, 2), device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tmesh.make_host_mesh(device="cuda:1")


def test_shard_devices_follow_the_partition_spec():
    """Shard i of a batch split over ``axes`` runs on the device whose
    coordinates along ``axes`` (the first slowest) are i and 0 along the
    other axes, as ``PartitionSpec(axes)`` lays a JAX mesh out."""
    mesh = tmesh.Mesh(tuple(torch.device("cuda", i) for i in range(8)),
                      (4, 2), ("data", "model"))

    def idx(axes):
        return [d.index for d in mesh.shard_devices(axes)]
    assert idx(("data", "model")) == list(range(8))
    assert idx(("data",)) == [0, 2, 4, 6]
    assert idx(("model",)) == [0, 1]
    assert idx(("model", "data")) == [0, 2, 4, 6, 1, 3, 5, 7]
    for bad in (("pod",), ("data", "data")):
        with pytest.raises(ValueError, match="not distinct axes"):
            mesh.shard_devices(bad)
    with pytest.raises(ValueError, match="8 devices"):
        tmesh.Mesh(mesh.devices, (4, 4), ("data", "model"))
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.Mesh(mesh.devices, (8,), ("data", "model"))


# ---- the serve CLI --------------------------------------------------------
_CLI = ["--device", "cpu", "--nodes", "900", "--batches", "2",
        "--batch-size", "48", "--validate", "16"]


def test_serve_modes_answer_alike():
    """``--mode fused`` and ``--mode sharded`` (and its alias) validate
    with 0 mismatches, and their front ends (``serve_step``, and
    ``serve_jit`` over the CPU mesh) answer a batch as the planner's
    does."""
    g, dix, plan, summary = serve.build(serve.parse_args(_CLI))
    rng = np.random.default_rng(4)
    s, t = rng.integers(0, g.n, 96), rng.integers(0, g.n, 96)
    res, answers = {}, {}
    for mode in (["--mode", "planner"], ["--mode", "fused"],
                 ["--mode", "sharded"], ["--sharded"]):
        args = serve.parse_args(_CLI + mode)
        out = serve.serve(args, g, dix, summary, plan)
        assert serve.failures(out) == 0 and out["mismatches"] == 0
        assert out["mode"] == args.mode
        res[" ".join(mode)] = out
        answers[" ".join(mode)] = serve._front_end(args, g, dix)[0](s, t)
    want = answers["--mode planner"]
    assert want.shape == (96,)
    for got in answers.values():
        np.testing.assert_array_equal(got, want)
    assert res["--mode planner"]["buckets"]
    assert res["--mode fused"]["buckets"] is None


@pytest.mark.parametrize("mode", ["fused", "sharded"])
def test_serve_cli_mode_exits_zero(mode):
    assert serve.main(_CLI + ["--batches", "1", "--mode", mode]) == 0


@pytest.mark.parametrize("mode", [["--mode", "fused"], ["--mode", "sharded"],
                                  ["--sharded"]])
@pytest.mark.parametrize("flag", [["--paths"], ["--live"],
                                  ["--update-batches", "1"],
                                  ["--check-build-parity"]])
def test_planner_only_flags_are_refused(mode, flag, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.parse_args(_CLI + mode + flag)
    assert exc.value.code == 2
    assert f"{flag[0]} requires --mode planner" in capsys.readouterr().err
