"""Kernel 5 at few rows and kernel 1 at small n, against the reference.

Kernel 5 (``minplus``) takes a GEMV-shaped route on the card for a few
rows of A (one-to-all's vector x matrix product): N cut into strips, K
into k-slices whose partials one block each computes and the cluster of
a strip folds.  ``ref.minplus_gemv_ref`` models that schedule in plain
torch; here it is held array-equal to ``ref.minplus_ref`` and to the
reference's ``ops.minplus`` (its jnp oracle and its Pallas kernel in
interpret mode) on ragged shapes, negative entries, all-+inf rows and
k-slices of one row or none.  ``minplus.route`` and
``floyd_warshall.route`` name the entry each shape takes.  Kernel 1's
small-n register variant runs the reference's serial recurrence, so
``ops.fw_batch_next`` on the CPU is held against the reference at the
main paths' piece-bucket shapes (batches cut to at most 64) and ragged
n, tie-heavy and all-+inf included.  One-to-all (the path that launches
kernel 5) is checked on a disconnected graph.  Integer-valued inputs
keep every sum exact, so every comparison is exact.

The ``cuda`` tests hold the kernels to their plain versions on the card
at the same cases and at the full bucket shapes:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_small_kernels.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra
from repro_torch.core.graph import Graph, road_like
from repro_torch.core.supergraph import build_index
from repro_torch.kernels import floyd_warshall, minplus, ops, ref

# tiny tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def J():
    """The reference package's kernel layer (jnp oracles, Pallas)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    return SimpleNamespace(jnp=jnp, ops=jops)


def _ints(shape, rng, *, lo=0, hi=100, inf_frac=0.2):
    x = rng.integers(lo, hi, size=shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


def _mp_input(m, k, n):
    """A [m, k], B [k, n]: integers from [-50, 50) with ~20% +inf, A's
    last row and B's first column all +inf."""
    rng = np.random.default_rng(m * 7919 + k * 31 + n)
    a = _ints((m, k), rng, lo=-50, hi=50)
    b = _ints((k, n), rng, lo=-50, hi=50)
    if m > 1:
        a[-1] = np.inf
    b[:, 0] = np.inf
    return a, b


MP_M = [1, 2, 8, 9, 33]
# (k, n): one row; 8 k-slices of one row each; fewer rows than k-slices
# (empty ones) and N past one 128-wide strip; ragged both; k-slices of
# 38 rows and N odd (scalar loads of B)
MP_KN = [(1, 1), (8, 37), (5, 130), (67, 33), (300, 129)]


@pytest.mark.parametrize("k,n", MP_KN)
@pytest.mark.parametrize("m", MP_M)
def test_gemv_schedule_matches_reference(J, m, k, n):
    """The k-split GEMV schedule (partials per k-slice and strip, then
    the fold) == minplus_ref == the reference's minplus (jnp and
    Pallas), at the strip the route picks and at both built widths."""
    a, b = _mp_input(m, k, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = ref.minplus_ref(ta, tb)
    for jforce in ("ref", "pallas"):
        np.testing.assert_array_equal(want.numpy(), np.asarray(
            J.ops.minplus(J.jnp.asarray(a), J.jnp.asarray(b), force=jforce)))
    entry, sw = minplus.route(m, k, n)
    for strip in {sw or minplus.GEMV_STRIPS[0], *minplus.GEMV_STRIPS}:
        got = ref.minplus_gemv_ref(ta, tb, strip=strip,
                                   slices=minplus.GEMV_SLICES)
        assert torch.equal(got, want)
    assert torch.equal(ops.minplus(ta, tb), want)
    if m > 1:
        assert torch.isinf(want[-1]).all()


@pytest.mark.parametrize("m,k,n,want", [
    (1, 1712, 1712, ("minplus_gemv", 32)),
    (1, 480, 480, ("minplus_gemv", 32)),
    (1, 4614, 4614, ("minplus_gemv", 128)),
    (8, 1712, 1712, ("minplus_gemv", 32)),
    (8, 3, 4096, ("minplus_gemv", 32)),
    (2, 3, 4097, ("minplus_gemv", 128)),
    (9, 1712, 1712, ("minplus_tiles", 0)),
    (33, 77, 129, ("minplus_tiles", 0)),
    (1792, 128, 1792, ("minplus_tiles", 0)),
])
def test_minplus_route(m, k, n, want):
    """The GEMV entry takes at most GEMV_MAX_M rows, in the widest strip
    that still gives GEMV_BLOCKS blocks (2 per SM); more rows take the
    tiles."""
    assert minplus.route(m, k, n) == want
    entry, sw = want
    if entry == "minplus_gemv":
        assert -(-n // sw) * minplus.GEMV_SLICES >= minplus.GEMV_BLOCKS \
            or sw == minplus.GEMV_STRIPS[0]


@pytest.mark.parametrize("n,want", [
    (1, ("fw_next_reg", 8)), (8, ("fw_next_reg", 8)),
    (9, ("fw_next_reg", 32)), (16, ("fw_next_reg", 32)),
    (17, ("fw_next_reg", 32)), (32, ("fw_next_reg", 32)),
    (33, ("fw_next_reg", 64)), (64, ("fw_next_reg", 64)),
    (65, ("fw_next_blocked", 65)), (128, ("fw_next_blocked", 128)),
    (496, ("fw_next_blocked", 496)),
])
def test_fw_route(n, want):
    assert floyd_warshall.route(n) == want


def _fw_input(b, n, kind):
    """[b, n, n]: integers with ~20% +inf ("ragged"), values from {0, 1,
    2} with 60% +inf ("ties": many tied paths, so the first hops depend
    on the pivot order), or "ragged" with every other matrix all +inf
    ("inf")."""
    rng = np.random.default_rng(b * 1000 + n)
    if kind == "ties":
        return _ints((b, n, n), rng, hi=3, inf_frac=0.6)
    d = _ints((b, n, n), rng)
    if kind == "inf":
        d[::2] = np.inf
    return d


# the main paths' piece buckets ([407, 8, 8] and [6, 32, 32] at
# road4000, [6211, 8, 8] and [75, 32, 32] at road64k), b cut to <= 64;
# then ragged n
FW_CASES = [(64, 8, "ragged"), (6, 32, "ragged"), (64, 8, "ties"),
            (64, 32, "ties"), (1, 1, "ragged"), (9, 5, "ties"),
            (7, 17, "ties"), (5, 33, "inf"), (4, 64, "ties"),
            (3, 64, "ragged"), (6, 8, "inf")]


@pytest.mark.parametrize("b,n,kind", FW_CASES)
@pytest.mark.parametrize("jforce", ["ref", "pallas"])
def test_fw_batch_next_small_matches_reference(J, b, n, kind, jforce):
    d = _fw_input(b, n, kind)
    got = ops.fw_batch_next(torch.from_numpy(d))
    want = J.ops.fw_batch_next(J.jnp.asarray(d), force=jforce)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if kind == "inf":
        assert (got[1][::2] == -1).all()
        assert (got[0][::2].diagonal(dim1=1, dim2=2) == 0).all()


# -- one-to-all on a disconnected graph ---------------------------------

_UNION: dict = {}


def _union_edges():
    """road_like(1400, 23) + road_like(400, 2) + tree_with_blobs(10, 5,
    3), node ids offset: 3 components."""
    from repro_torch.core.graph import tree_with_blobs
    parts = [road_like(1400, seed=23), road_like(400, seed=2),
             tree_with_blobs(10, 5, seed=3)]
    us, vs, ws, off = [], [], [], 0
    for g in parts:
        us.append(g.edge_u.astype(np.int64) + off)
        vs.append(g.edge_v.astype(np.int64) + off)
        ws.append(g.edge_w)
        off += g.n
    return off, np.concatenate(us), np.concatenate(vs), np.concatenate(ws), \
        [p.n for p in parts]


def _union_built(lv):
    if lv not in _UNION:
        from repro.core import device_engine as jde
        from repro.core.graph import Graph as JGraph
        from repro.core.supergraph import build_index as jbuild_index
        n, u, v, w, sizes = _union_edges()
        g = Graph.from_edges(n, u, v, w)
        dix = tde.build_device_index(build_index(g), device="cpu",
                                     hierarchy_levels=lv)
        jdix = jde.build_device_index(
            jbuild_index(JGraph.from_edges(n, u, v, w)), hierarchy_levels=lv)
        _UNION[lv] = (g, dix, jdix, sizes)
    return _UNION[lv]


@pytest.mark.parametrize("part", [0, 1, 2])
@pytest.mark.parametrize("lv", [1, 3])
def test_one_to_all_disconnected_matches_reference_and_dijkstra(lv, part):
    """serve_one_to_all from a source in each component == the
    reference's == Dijkstra: +inf to the other components (the rows of
    kernel 5's A and the closure columns that stay +inf)."""
    from repro.core import device_engine as jde
    g, dix, jdix, sizes = _union_built(lv)
    src = sum(sizes[:part]) + 3
    got = tde.serve_one_to_all(dix, src).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jde.serve_one_to_all(jdix, src)))
    want = dijkstra.sssp(g, src).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    lo, hi = sum(sizes[:part]), sum(sizes[:part + 1])
    assert np.isinf(np.delete(got, np.arange(lo, hi))).all()
    assert np.isfinite(got[lo:hi]).all()


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# the CPU cases, then the one-to-all shapes and the threshold's
# neighbours at full size, then k-slices past one 256-row chunk of A
# (K > 8 x 256: the GEMV's double-buffered A) at m = 1 and 8 with
# float4 loads of B
CARD_MP = [(m, k, n) for m in MP_M for k, n in MP_KN] + [
    (1, 1712, 1712), (2, 1712, 1712), (1, 480, 480), (1, 4614, 4614),
    (8, 1712, 1712), (9, 1712, 1712), (1, 2100, 1712), (8, 2100, 1712)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", CARD_MP)
def test_minplus_routes_match_plain_on_card(cuda_device, m, k, n):
    """ops.minplus (the entry ``minplus.route`` names) == the plain
    version, on contiguous B (float4 loads where N allows) and on B
    offset by one float (scalar loads)."""
    a, b = (torch.from_numpy(x).to(cuda_device) for x in _mp_input(m, k, n))
    want = ops.minplus(a, b, force="ref")
    before = minplus.minplus_cuda.launches
    assert torch.equal(ops.minplus(a, b), want)
    assert minplus.minplus_cuda.launches == before + 1
    shifted = torch.empty(b.numel() + 1, device=cuda_device)[1:].view(k, n)
    shifted.copy_(b)
    assert torch.equal(ops.minplus(a, shifted), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,kind", FW_CASES + [
    (407, 8, "ragged"), (6, 32, "ragged"), (6211, 8, "ragged"),
    (75, 32, "ragged"), (6211, 8, "ties"), (75, 32, "ties"),
    (64, 64, "ties"), (13, 31, "ties"), (11, 16, "inf")])
def test_fw_reg_kernel_matches_plain_on_card(cuda_device, b, n, kind):
    """The register witness FW, dist and nxt array-equal to the serial
    plain version; also on an input offset by one float (the kernels'
    unaligned copies)."""
    d = torch.from_numpy(_fw_input(b, n, kind)).to(cuda_device)
    want = ops.fw_batch_next(d, force="ref")
    before = floyd_warshall.fw_next_reg_cuda.launches
    for g, w in zip(ops.fw_batch_next(d), want):
        assert torch.equal(g, w)
    assert floyd_warshall.fw_next_reg_cuda.launches == before + 1
    shifted = torch.empty(d.numel() + 1, device=cuda_device)[1:].view(
        d.shape)
    shifted.copy_(d)
    for g, w in zip(floyd_warshall.fw_next_reg_cuda(shifted), want):
        assert torch.equal(g, w)
