"""The port's device build and serve path against the reference package.

On ``road_like(900)`` (S ~ 200, dense overlay) every DeviceIndex field,
the witness tables included, is array-equal to
``repro.core.device_engine.build_device_index(ix, hierarchy_levels=1)``,
and every served distance (``serve_step`` and the planner, in both
``_combine_mid`` layouts) is ``==`` the reference's ``serve_step`` and
the Dijkstra oracle.  The port also serves from a reference-built index
carried across with ``convert.device_index_from_numpy``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_engine as jde
from repro.core import dijkstra as jdijkstra
from repro.core.graph import road_like as jroad_like
from repro.core.supergraph import build_index as jbuild_index
from repro_torch import convert
from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.graph import road_like
from repro_torch.core.supergraph import build_index

# tiny tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

CPU = torch.device("cpu")
LAYOUTS = ("gather", "scatter")


@pytest.fixture(scope="module")
def world():
    jg = jroad_like(900, seed=0)
    jdix = jde.build_device_index(jbuild_index(jg), hierarchy_levels=1)
    g = road_like(900, seed=0)
    dix, plan = tde.build_device_index_with_plan(
        build_index(g), device="cpu", hierarchy_levels=1)
    return g, dix, plan, jdix


def _pairs(g, plan, seed=0):
    """Random pairs plus explicit s == t, same-DRA, same-piece,
    same-fragment and cross-fragment pairs."""
    rng = np.random.default_rng(seed)
    s = list(rng.integers(0, g.n, 150))
    t = list(rng.integers(0, g.n, 150))
    s += [0, 5, g.n - 1]
    t += [0, 5, g.n - 1]
    agent = plan.agent_of
    frag = plan.frag_of[agent]
    for gid in range(min(plan.n_pieces, 12)):
        m = plan.piece_members[gid]
        s.append(m[0])
        t.append(m[-1])                         # same DRA, same piece
    inner = np.nonzero(agent != np.arange(g.n))[0]
    for v in inner[:10]:
        s.append(v)
        t.append(agent[v])                      # node -> its own agent
    for f in range(min(plan.k, 8)):
        nodes = np.nonzero(frag == f)[0]
        s.append(nodes[0])
        t.append(nodes[-1])                     # same fragment
        other = np.nonzero(frag == (f + 1) % plan.k)[0]
        s.append(nodes[0])
        t.append(other[-1])                     # cross fragment
    return np.asarray(s, np.int64), np.asarray(t, np.int64)


def _oracle(g, s, t):
    return np.array([dijkstra.pair(g, int(a), int(b))
                     for a, b in zip(s, t)], np.float32)


def test_every_dense_field_matches_reference(world):
    _g, dix, _plan, jdix = world
    for name, dtype in tde.FIELD_DTYPES.items():
        got = getattr(dix, name)
        want = np.asarray(getattr(jdix, name))
        assert got.dtype == dtype, name
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(dix.host_ov_slot, jdix.host_ov_slot)
    assert dix.device == CPU


def test_pairs_cover_every_case(world):
    g, dix, plan, _ = world
    s, t = _pairs(g, plan)
    buckets = QueryPlanner(dix).plan(s, t)
    assert all(v.size for v in buckets.values()), buckets
    covered = np.sort(np.concatenate(list(buckets.values())))
    np.testing.assert_array_equal(covered, np.arange(s.size))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_serve_step_matches_reference_and_dijkstra(world, layout):
    g, dix, plan, jdix = world
    s, t = _pairs(g, plan)
    want = np.asarray(jde.serve_step(jdix, jnp.asarray(s, jnp.int32),
                                     jnp.asarray(t, jnp.int32)))
    got = tde.serve_step(dix, torch.from_numpy(s), torch.from_numpy(t),
                         layout=layout).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(g, s, t))
    assert (got[s == t] == 0).all()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_planner_matches_serve_step(world, layout):
    g, dix, plan, jdix = world
    s, t = _pairs(g, plan, seed=1)
    planner = QueryPlanner(dix, layout=layout)
    got = planner.query(s, t)
    want = np.asarray(jde.serve_step(jdix, jnp.asarray(s, jnp.int32),
                                     jnp.asarray(t, jnp.int32)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(g, s, t))
    assert sum(planner.last_counts.values()) == s.size


def test_port_serves_from_reference_built_index(world):
    g, _dix, plan, jdix = world
    fields = {name: np.asarray(getattr(jdix, name))
              for name in tde.FIELD_DTYPES}
    dix = convert.device_index_from_numpy(fields, "cpu")
    s, t = _pairs(g, plan, seed=2)
    for layout in LAYOUTS:
        got = QueryPlanner(dix, layout=layout).query(s, t)
        np.testing.assert_array_equal(got, _oracle(g, s, t))
    back = convert.device_index_to_numpy(dix)
    for name, arr in fields.items():
        np.testing.assert_array_equal(back[name], arr)
        assert back[name].dtype == arr.dtype


def test_convert_rejects_wrong_dtype_missing_field_and_hierarchy(world):
    _g, dix, _plan, _ = world
    fields = convert.device_index_to_numpy(dix)
    bad = dict(fields, agent_of=fields["agent_of"].astype(np.int64))
    with pytest.raises(TypeError, match="agent_of"):
        convert.device_index_from_numpy(bad, "cpu")
    missing = {k: v for k, v in fields.items() if k != "brow"}
    with pytest.raises(KeyError, match="brow"):
        convert.device_index_from_numpy(missing, "cpu")
    with pytest.raises(ValueError, match="hierarchical"):
        convert.device_index_from_numpy(
            dict(fields, sf_of=(np.zeros(3, np.int32),)), "cpu")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_agent_outside_every_fragment_serves_inf(world, layout):
    """An agent with frag_of == -1: the reference wraps the -1 in its
    gathers and masks after; the port clamps before and must agree
    (+inf), with no out-of-range gather."""
    g, dix, plan, jdix = world
    s = np.array([3, 10, 400], np.int64)
    t = np.array([700, 600, 20], np.int64)
    u = int(plan.agent_of[s[0]])
    frag_of = dix.frag_of.clone()
    frag_of[u] = -1
    pdix = dataclasses.replace(dix, frag_of=frag_of)
    jfrag = np.asarray(jdix.frag_of).copy()
    jfrag[u] = -1
    pj = dataclasses.replace(jdix, frag_of=jnp.asarray(jfrag))
    for with_local in (True, False):
        got = tde.serve_cross(pdix, torch.from_numpy(s), torch.from_numpy(t),
                              with_local=with_local, layout=layout).numpy()
        want = np.asarray(jde.serve_cross(
            pj, jnp.asarray(s, jnp.int32), jnp.asarray(t, jnp.int32),
            with_local=with_local))
        np.testing.assert_array_equal(got, want)
        assert np.isinf(got[0])
        np.testing.assert_array_equal(got[1:], _oracle(g, s[1:], t[1:]))


def test_planner_pads_buckets_with_zero_filler(world):
    """Each bucket runs at its pow2 size (floor 16) with (0, 0) filler
    queries after the real ones, as the reference planner pads."""
    g, dix, plan, _ = world
    s, t = _pairs(g, plan, seed=3)
    s, t = s[:37], t[:37]
    planner = QueryPlanner(dix)
    seen = {}
    for case, fn in list(planner._fns.items()):
        def rec(d, sp, tp, _fn=fn, _case=case):
            seen[_case] = (sp.clone(), tp.clone())
            return _fn(d, sp, tp)
        planner._fns[case] = rec
    got = planner.query(s, t)
    np.testing.assert_array_equal(got, _oracle(g, s, t))
    for case, (sp, tp) in seen.items():
        n = planner.last_counts[case]
        assert sp.numel() == max(16, 1 << (n - 1).bit_length())
        assert sp.dtype == torch.int64
        assert not sp[n:].any() and not tp[n:].any()
    assert planner.bucket_sizes(1024) == [16, 32, 64, 128, 256, 512, 1024]
    planner.warmup(40)


def test_same_piece_index_masked_before_gather(world):
    """Pairs in different pieces must not gather piece_flat at their
    (meaningless) piece offset: the index is zeroed before the gather,
    so answers equal the via-agent distance and nothing reads out of
    range even when the offsets point past the table."""
    g, dix, plan, _ = world
    hot = np.nonzero(plan.piece_gid >= 0)[0]
    a, b = next((a, b) for a in hot for b in hot
                if plan.agent_of[a] == plan.agent_of[b]
                and plan.piece_gid[a] != plan.piece_gid[b])
    far = dataclasses.replace(
        dix, piece_base=torch.where(dix.piece_gid == plan.piece_gid[b],
                                    dix.piece_flat.numel() * 4,
                                    dix.piece_base))
    s = torch.tensor([a, a], dtype=torch.int64)
    t = torch.tensor([b, a], dtype=torch.int64)
    got = tde.serve_same_dra(far, s, t).numpy()
    np.testing.assert_array_equal(got, _oracle(g, s.numpy(), t.numpy()))


def test_build_refuses_hierarchy_and_hub_tier():
    ix = build_index(road_like(400, seed=1))
    with pytest.raises(NotImplementedError, match="hierarchy"):
        tde.build_device_index(ix, device="cpu", hierarchy_levels=2)
    with pytest.raises(NotImplementedError, match="hub"):
        tde.build_device_index_with_plan(ix, device="cpu",
                                         hub_nodes=np.arange(4))
    with pytest.raises(ValueError, match="layout"):
        dix = tde.build_device_index(ix, device="cpu")
        z = torch.zeros(16, dtype=torch.int64)
        tde.serve_cross(dix, z, z + 1, with_local=True, layout="dense")


def test_entry_points_refuse_missing_cuda():
    """Without a card, asking for cuda (the default) raises; there is no
    quiet fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tde.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.device_index_from_numpy({}, "cuda")
    assert tde.resolve_device("cpu") == CPU


def test_reference_oracle_agrees_with_port_oracle(world):
    g, _dix, plan, _ = world
    s, t = _pairs(g, plan, seed=4)
    jg = jroad_like(900, seed=0)
    want = [jdijkstra.pair(jg, int(a), int(b)) for a, b in zip(s, t)]
    np.testing.assert_array_equal(_oracle(g, s, t),
                                  np.asarray(want, np.float32))


def test_fw_bucket_all_inf_blocks_and_nan_guard(monkeypatch):
    """All-+inf padding blocks close to +inf (never NaN); a FW that did
    produce NaN fails the build loudly instead of serving it."""
    adjs = [np.full((8, 8), np.inf, np.float32) for _ in range(3)]
    adjs[1][0, 1] = adjs[1][1, 0] = 5.0
    dist, nxt = tde._fw_bucket(adjs, CPU)
    assert not np.isnan(dist).any()
    assert dist[1, 0, 1] == 5 and nxt[1, 0, 1] == 1
    assert np.isinf(dist[0][~np.eye(8, dtype=bool)]).all()
    assert (nxt[0] == -1).all()

    def nan_fw(d, *, force=None):
        return torch.full_like(d, float("nan")), torch.zeros_like(
            d, dtype=torch.int32)
    monkeypatch.setattr(tde.ops, "fw_batch_next", nan_fw)
    with pytest.raises(FloatingPointError, match="NaN"):
        tde._fw_bucket(adjs, CPU)
