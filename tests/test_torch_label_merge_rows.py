"""Kernel 7 through the label table's row ids, against the reference.

``ops.label_merge_rows(rows, ids_s, ids_t)`` computes the reference's
``ops.label_merge(rows[ids_s], rows[ids_t])`` without the two [q, W]
gathers; ``serve_hub`` calls it.  The same numpy-seeded, integer-valued
float32 labels (about 10% +inf, an all-+inf sentinel last row, repeated
ids) go through the reference's jnp oracle and its Pallas kernel in
interpret mode and through the port's plain version; the port's
``serve_hub`` on a small labeled index (road_like(1400, 23) at 1 and 3
levels, built once per module) is held to the reference's
``serve_hub`` on the same index converted to JAX arrays, on gated pairs,
(0, 0) pads, unlabeled endpoints and labeled pairs the gate rejects.
Integer labels keep every sum below 2**24, so every comparison is
exact.  The reference is imported through fixtures, so the ``cuda``
tests (the kernel against its plain version) also run on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_label_merge_rows.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import device_engine as tde
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.graph import road_like
from repro_torch.core.supergraph import build_index
from repro_torch.kernels import label_merge, ops, ref

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

N, SEED, N_HUBS = 1400, 23, 256


@pytest.fixture(scope="module")
def J():
    """The reference package: its kernel ops and device engine."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import device_engine as jde
    from repro.kernels import ops as jops
    return SimpleNamespace(jnp=jnp, ops=jops, de=jde)


def _table(h, w, rng, inf_frac=0.1):
    """Label table [h + 1, w]: integers with ~``inf_frac`` +inf and the
    all-+inf sentinel last row, as ``hub_stage`` lays it out."""
    rows = rng.integers(0, 1000, size=(h + 1, w)).astype(np.float32)
    rows[rng.random(rows.shape) < inf_frac] = np.inf
    rows[h] = np.inf
    return rows


def _ids(q, h, rng):
    """int32 row ids [q] over [0, h]: repeats (drawn from at most
    h + 1 rows), the sentinel h, and pads (0, 0) at the end."""
    ids_s = rng.integers(0, h + 1, q).astype(np.int32)
    ids_t = rng.integers(0, h + 1, q).astype(np.int32)
    if q:
        ids_s[0] = h                               # unlabeled endpoint
        ids_t[-(q // 4 or 1):] = ids_s[-(q // 4 or 1):] = 0   # pads
    return ids_s, ids_t


# the reference's Pallas kernel cannot tile an empty batch (its BlockSpec
# slice exceeds a [0, W] operand), so q = 0 is held to its jnp oracle
MERGE_CASES = [(q, w, jforce) for q in (0, 1, 33, 257)
               for w in (1, 3, 299, 480, 513)
               for jforce in (("ref",) if q == 0 else ("ref", "pallas"))]


@pytest.mark.parametrize("q,w,jforce", MERGE_CASES)
def test_label_merge_rows_equals_reference(J, q, w, jforce):
    rng = np.random.default_rng(q * 1000 + w)
    h = 40
    rows = _table(h, w, rng)
    ids_s, ids_t = _ids(q, h, rng)
    want = np.asarray(J.ops.label_merge(J.jnp.asarray(rows[ids_s]),
                                        J.jnp.asarray(rows[ids_t]),
                                        force=jforce))
    args = (torch.from_numpy(rows), torch.from_numpy(ids_s),
            torch.from_numpy(ids_t))
    got = ops.label_merge_rows(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (q,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.label_merge_rows(*args, force="ref").numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), ops.label_merge(args[0][args[1].long()],
                                     args[0][args[2].long()]).numpy())


def test_label_merge_rows_force_kernel_on_cpu_raises():
    """A CUDA kernel has no CPU mode: ``force="kernel"`` on CPU tensors
    raises, the wrapper refuses CPU tensors, and nothing is counted."""
    rows = torch.zeros((3, 5))
    ids = torch.zeros(4, dtype=torch.int32)
    before = (label_merge.label_merge_rows_cuda.launches,
              label_merge.label_merge_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ops.label_merge_rows(rows, ids, ids, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        label_merge.label_merge_rows_cuda(rows, ids, ids)
    assert torch.equal(ops.label_merge_rows(rows, ids, ids),
                       ref.label_merge_rows_ref(rows, ids, ids))
    assert (label_merge.label_merge_rows_cuda.launches,
            label_merge.label_merge_cuda.launches) == before


@pytest.mark.parametrize("q,w,want", [
    (1024, 480, 32), (1024, 1712, 128), (1024, 4661, 128),
    (4096, 4661, 32), (256, 4661, 256), (8, 4661, 256), (256, 1712, 128),
    (8, 480, 32), (37, 299, 32), (8, 1, 32), (8, 513, 64),
    (528, 4661, 256), (529, 4661, 128), (100_000, 4661, 32)])
def test_team_covers_the_row_in_one_wave(q, w, want):
    """The team a query gets (the launch's shape on the card): enough
    threads that one pass of 16 columns a thread covers the row, halved
    while the q teams would not all be resident on an H100 at once (132
    SMs x 4 blocks of 256), a warp at least."""
    t = label_merge.team(q, w)
    assert t == want
    assert t & (t - 1) == 0 and 32 <= t <= label_merge.BLOCK


# ---- serve_hub on a labeled index ------------------------------------------
_BUILT: dict = {}


def _built(lv):
    """(port graph, port index on the CPU) at ``lv`` levels with a
    seeded hub set, built once per test process."""
    if lv not in _BUILT:
        if "world" not in _BUILT:
            g = road_like(N, seed=SEED)
            _BUILT["world"] = (g, build_index(g), np.random.default_rng(
                SEED + 1).choice(g.n, N_HUBS, replace=False))
        g, ix, hubs = _BUILT["world"]
        dix = tde.build_device_index(ix, device="cpu", hierarchy_levels=lv,
                                     hub_nodes=hubs)
        assert dix.hierarchy_levels == lv and dix.hub_rows.shape[0] > 1
        _BUILT[lv] = (g, dix)
    return _BUILT[lv]


def _to_reference(J, dix):
    """The reference's ``DeviceIndex`` of the same tables (every field
    through ``convert.device_index_to_numpy``)."""
    fields = convert.device_index_to_numpy(dix)
    return J.de.DeviceIndex(
        **{k: J.jnp.asarray(fields[k]) for k in tde.FIELD_DTYPES},
        **{k: tuple(J.jnp.asarray(a) for a in fields[k])
           for k in tde.TUPLE_FIELD_DTYPES})


def _hub_pairs(g, dix):
    """(s, t, kinds): gated pairs, (0, 0) pads, pairs with an unlabeled
    endpoint, and labeled pairs the gate rejects."""
    rng = np.random.default_rng(5)
    s, t = rng.integers(0, g.n, 20000), rng.integers(0, g.n, 20000)
    gate = QueryPlanner(dix).hub_mask(s, t)
    agent_of = dix.agent_of.numpy()
    labeled = dix.host_hub_agent[agent_of] >= 0
    both = labeled[s] & labeled[t]
    unl = ~labeled[s] | ~labeled[t]
    rejected = both & ~gate
    kinds = {"gated": (s[gate][:96], t[gate][:96]),
             "pad": (np.zeros(16, np.int64), np.zeros(16, np.int64)),
             "unlabeled": (s[unl][:32], t[unl][:32]),
             "rejected": (s[rejected][:48], t[rejected][:48])}
    for name, (a, _b) in kinds.items():
        assert a.size, f"no {name} pair: fixture too small"
    s = np.concatenate([a for a, _b in kinds.values()])
    t = np.concatenate([b for _a, b in kinds.values()])
    return s, t, {k: a.size for k, (a, _b) in kinds.items()}


@pytest.mark.parametrize("lv", (1, 3))
@pytest.mark.parametrize("jforce", ("ref", "pallas"))
def test_serve_hub_equals_reference(J, lv, jforce):
    g, dix = _built(lv)
    s, t, kinds = _hub_pairs(g, dix)
    got = tde.serve_hub(dix, torch.from_numpy(s), torch.from_numpy(t))
    want = np.asarray(J.de.serve_hub(
        _to_reference(J, dix), J.jnp.asarray(s.astype(np.int32)),
        J.jnp.asarray(t.astype(np.int32)), force=jforce))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the two gathers and the dense merge it replaced, on the same pairs
    us = dix.agent_of[torch.from_numpy(s)].long()
    ut = dix.agent_of[torch.from_numpy(t)].long()
    mid = ops.label_merge(dix.hub_rows[dix.hub_of_agent[us].long()],
                          dix.hub_rows[dix.hub_of_agent[ut].long()])
    d = dix.dist_to_agent[torch.from_numpy(s)] + mid + dix.dist_to_agent[
        torch.from_numpy(t)]
    valid = (dix.frag_of[us] >= 0) & (dix.frag_of[ut] >= 0)
    np.testing.assert_array_equal(
        got.numpy(), torch.where(valid, d, float("inf")).numpy())
    n_gated, n_pad, n_unl = kinds["gated"], kinds["pad"], kinds["unlabeled"]
    assert np.isfinite(got.numpy()[:n_gated]).all()
    unl = got.numpy()[n_gated + n_pad:n_gated + n_pad + n_unl]
    assert np.isinf(unl).all()


# ---- on the card -----------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q,h,w", [(1, 4, 1), (37, 20, 299), (33, 40, 3),
                                   (257, 256, 480), (1024, 2034, 1712),
                                   (300, 2048, 4661), (8, 256, 480)])
def test_label_merge_rows_kernel_matches_plain_on_card(cuda_device, q, h, w):
    rng = np.random.default_rng(q + w)
    rows = torch.from_numpy(_table(h, w, rng)).to(cuda_device)
    ids_s, ids_t = (torch.from_numpy(x).to(cuda_device)
                    for x in _ids(q, h, rng))
    n = label_merge.label_merge_rows_cuda.launches
    got = label_merge.label_merge_rows_cuda(rows, ids_s, ids_t)
    assert label_merge.label_merge_rows_cuda.launches == n + 1
    assert torch.equal(got, ops.label_merge_rows(rows, ids_s, ids_t,
                                                 force="ref"))
    assert torch.equal(ops.label_merge_rows(rows, ids_s, ids_t), got)
    # the dense entry on the gathered rows: same template
    assert torch.equal(ops.label_merge(rows[ids_s.long()],
                                       rows[ids_t.long()]), got)
