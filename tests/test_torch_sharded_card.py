"""Sharded serving and build on the card.

No JAX here (the card's machine has none).  ``serve_sharded`` and
``serve_jit`` on a one-card mesh and on ``cuda:0`` repeated four times
equal ``serve_step`` on the whole batch, ragged and empty batches
included, dense and at 3 levels; an index built on the CPU, served on
the one-card mesh (its replica copied to the card) and on a mesh of the
CPU and the card, equals ``serve_step`` on the CPU index;
``fw_fragments_sharded`` at n = 100,
200 and 300 (kernel 3's register route, and its batched blocked route
above n = 128) equals the plain version ``ops.fw_batch(...,
force="ref")`` and counts each route's launches where it launches; ``super_apsp_sharded`` (the
Bellman-Ford sweeps on the card) equals the dense ``d_super``.  Skips
without a card; on one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharded_card.py
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import device_engine as tde
from repro_torch.core.dist_engine import (_replicas, fw_fragments_sharded,
                                          serve_jit, serve_sharded,
                                          super_apsp_sharded)
from repro_torch.core.graph import road_like
from repro_torch.core.supergraph import build_index
from repro_torch.kernels import floyd_warshall, ops
from repro_torch.launch.mesh import Mesh, make_host_mesh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@functools.cache
def _built(n, seed, lv, device="cuda"):
    g = road_like(n, seed=seed)
    return g, *tde.build_device_index_with_plan(
        build_index(g), device=device, hierarchy_levels=lv)


def _meshes(dev):
    return {"one_card": make_host_mesh((1,), ("data",)),
            "cuda0_x4": Mesh((dev,) * 4, (4,), ("data",))}


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_name", ["one_card", "cuda0_x4"])
@pytest.mark.parametrize("n,seed,lv", [(900, 31, 1), (1400, 23, 3)])
def test_sharded_serve_on_card_equals_serve_step(cuda_device, mesh_name, n,
                                                 seed, lv):
    g, dix, _plan = _built(n, seed, lv)
    mesh = _meshes(cuda_device)[mesh_name]
    rng = np.random.default_rng(3)
    s, t = rng.integers(0, g.n, 1000), rng.integers(0, g.n, 1000)
    want = tde.serve_step(dix, torch.from_numpy(s).cuda(),
                          torch.from_numpy(t).cuda())
    step = serve_jit(mesh, dix)
    for q in (1000, 999, 3, 0):
        got = serve_sharded(mesh, dix, s[:q], t[:q])
        assert got.device == cuda_device
        assert torch.equal(got, want[:q])
        assert torch.equal(step(s[:q], t[:q]), want[:q])


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed,lv", [(900, 31, 1), (1400, 23, 3)])
def test_sharded_serve_copies_a_cpu_index_to_the_card(cuda_device, n, seed,
                                                      lv):
    g, dix, _plan = _built(n, seed, lv, "cpu")
    cpu = torch.device("cpu")
    one = make_host_mesh((1,), ("data",))
    mixed = Mesh((cpu, cuda_device), (2,), ("data",))
    reps = _replicas(dix, mixed.devices)
    assert reps[cpu] is dix
    assert reps[cuda_device].device == cuda_device
    assert all(tde.index_fields_equal(
        reps[cuda_device], dix,
        [*convert.FIELD_DTYPES, *convert.TUPLE_FIELD_DTYPES]).values())
    rng = np.random.default_rng(5)
    s, t = rng.integers(0, g.n, 333), rng.integers(0, g.n, 333)
    want = tde.serve_step(dix, torch.from_numpy(s), torch.from_numpy(t))
    for mesh in (one, mixed):
        step = serve_jit(mesh, dix)
        for q in (333, 1, 0):
            for got in (serve_sharded(mesh, dix, s[:q], t[:q]),
                        step(s[:q], t[:q])):
                assert got.device == mesh.devices[0]
                assert torch.equal(got.cpu(), want[:q])
    # the card's index served on the CPU and the card: a CPU replica
    _g, dix_card, _p = _built(n, seed, lv)
    assert _replicas(dix_card, mixed.devices)[cpu].device == cpu
    assert torch.equal(serve_sharded(mixed, dix_card, s, t), want)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_name", ["one_card", "cuda0_x4"])
@pytest.mark.parametrize("n,variant", [(100, "reg"), (200, "blocked"),
                                       (300, "blocked")])
def test_fw_fragments_sharded_on_card(cuda_device, mesh_name, n, variant):
    rng = np.random.default_rng(n)
    adj = rng.integers(1, 50, (9, n, n)).astype(np.float32)
    adj[rng.random(adj.shape) < 0.8] = np.inf
    adj[4] = np.inf
    mesh = _meshes(cuda_device)[mesh_name]
    counters = (floyd_warshall.fw_batch_cuda,
                floyd_warshall.fw_dist_blocked_cuda)
    before = [c.launches for c in counters]
    got = fw_fragments_sharded(mesh, adj)
    launched = [c.launches - b for c, b in zip(counters, before)]
    want = ops.fw_batch(torch.from_numpy(adj).cuda(), force="ref")
    assert got.device == cuda_device
    assert torch.equal(got, want)
    shards = len(mesh.devices)
    # the blocked route: one call a shard, its phase 1 one fw_dist_reg
    # launch a k-block
    kb = -(-n // floyd_warshall.DIST_BLOCK)
    assert launched == ([shards * kb, shards] if variant == "blocked"
                        else [shards, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_name", ["one_card", "cuda0_x4"])
def test_super_apsp_sharded_on_card(cuda_device, mesh_name):
    _g, dix, plan = _built(900, 31, 1)
    src = np.concatenate([plan.sup_src, plan.sup_dst])
    dst = np.concatenate([plan.sup_dst, plan.sup_src])
    w = np.concatenate([plan.sup_w, plan.sup_w])
    got = super_apsp_sharded(_meshes(cuda_device)[mesh_name], src, dst, w,
                             plan.S)
    assert got.device == cuda_device
    assert torch.equal(got, dix.d_super[:plan.S, :plan.S])
