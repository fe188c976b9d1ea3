"""The schedules of the redesigned kernels, modelled in plain torch.

``ref.fw_batch_next_blocked_ref`` is the blocked witness Floyd-Warshall
that ``csrc/fw_next.cu:fw_next_blocked`` runs (per k-block: pivot tile
and bands serially with snapshots, then the (min,+) phase 3 with an
argmin carry).  It must be array-equal, in dist and in nxt, to the
serial plain version ``ref.fw_batch_next_ref`` and to the reference
package's ``fw_batch_next_pallas`` (interpret mode, as its own tests run
it on the CPU), on tie-heavy inputs above all: values from {0, 1, 2},
zero-weight edges and 60% +inf, where a different pivot order would pick
another first hop.  The naive blocked schedule, which reads the bands
after the whole block instead of at each step, gives the same distances
and other first hops: the mutation test pins that the snapshots are what
makes the schedule exact.

``ref.minplus_twoside_argmin_split_ref`` models the witness twoside
kernel's split-x partials and its finish; it must equal
``ref.minplus_twoside_argmin_ref`` for every split count, the ones the
wrapper picks included.

Integer-valued inputs keep every sum below 2**24: the tolerance is
exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import minplus_twoside, ref

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)


def _fw_input(kind: str, b: int, n: int, seed: int) -> np.ndarray:
    """[b, n, n]: "ties" values from {0, 1, 2} (zero-weight edges
    included) with 60% +inf; "ragged" integers below 100 with 20% +inf;
    "inf" all +inf but for entry 0 of the batch (a tie-heavy matrix)."""
    rng = np.random.default_rng(seed)
    hi, frac = (100, 0.2) if kind == "ragged" else (3, 0.6)
    d = rng.integers(0, hi, (b, n, n)).astype(np.float32)
    d[rng.random(d.shape) < frac] = np.inf
    if kind == "inf":
        d[1:] = np.inf
    return d


# (kind, b, n, block): n not a multiple of the block, blocks from 4 to
# 32, one block wider than n, b > 1, an all-+inf batch entry
FW_CASES = [("ties", 1, 10, 4), ("ties", 2, 23, 7), ("ties", 3, 37, 16),
            ("ties", 1, 60, 32), ("ties", 2, 45, 4), ("ties", 1, 33, 7),
            ("ragged", 2, 50, 16), ("ragged", 1, 29, 32),
            ("inf", 3, 21, 7), ("inf", 2, 40, 16), ("ties", 1, 12, 32)]


@pytest.mark.parametrize("kind,b,n,block", FW_CASES)
def test_blocked_model_equals_serial_and_reference(kind, b, n, block):
    d = _fw_input(kind, b, n, seed=b * 1000 + n * 10 + block)
    want_d, want_n = ref.fw_batch_next_ref(torch.from_numpy(d))
    got_d, got_n = ref.fw_batch_next_blocked_ref(torch.from_numpy(d), block)
    assert torch.equal(got_d, want_d) and torch.equal(got_n, want_n)
    pal_d, pal_n = jops.fw_batch_next(jnp.asarray(d), force="pallas")
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(pal_d))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(pal_n))
    if kind == "inf":
        assert (got_n[1:].numpy() == -1).all()


def _naive_blocked(d: torch.Tensor, block: int):
    """The textbook blocked schedule: phase 2 reads the closed pivot
    tile and phase 3 the finished bands, not their state at each step."""
    mat, nxt = ref.fw_next_init(d)
    n = d.shape[-1]

    def relax(dst, dstn, a, an, b_):
        cand = a + b_
        better = cand < dst
        return torch.where(better, cand, dst), torch.where(better, an, dstn)

    for s in range(0, n, block):
        e = min(s + block, n)
        mat, nxt = mat.clone(), nxt.clone()
        for k in range(s, e):                      # phase 1
            mat[:, s:e, s:e], nxt[:, s:e, s:e] = relax(
                mat[:, s:e, s:e], nxt[:, s:e, s:e], mat[:, s:e, k:k + 1],
                nxt[:, s:e, k:k + 1], mat[:, k:k + 1, s:e])
        for k in range(s, e):                      # phase 2, closed pivot
            mat[:, s:e, :], nxt[:, s:e, :] = relax(
                mat[:, s:e, :], nxt[:, s:e, :], mat[:, s:e, k:k + 1],
                nxt[:, s:e, k:k + 1], mat[:, k:k + 1, :])
            mat[:, :, s:e], nxt[:, :, s:e] = relax(
                mat[:, :, s:e], nxt[:, :, s:e], mat[:, :, k:k + 1],
                nxt[:, :, k:k + 1], mat[:, k:k + 1, s:e])
        for k in range(s, e):                      # phase 3, final bands
            mat, nxt = relax(mat, nxt, mat[:, :, k:k + 1],
                             nxt[:, :, k:k + 1], mat[:, k:k + 1, :])
    return mat, nxt


@pytest.mark.parametrize("n,block", [(30, 4), (45, 7), (60, 16)])
def test_naive_blocked_schedule_breaks_ties_differently(n, block):
    """Mutation: without snapshots the distances agree but first hops on
    tied paths differ; the snapshot model agrees in both."""
    d = torch.from_numpy(_fw_input("ties", 2, n, seed=n + block))
    want_d, want_n = ref.fw_batch_next_ref(d)
    naive_d, naive_n = _naive_blocked(d, block)
    assert torch.equal(naive_d, want_d)
    assert not torch.equal(naive_n, want_n)
    got_d, got_n = ref.fw_batch_next_blocked_ref(d, block)
    assert torch.equal(got_d, want_d) and torch.equal(got_n, want_n)


def _argmin_input(q, k1, k2, kind, seed):
    rng = np.random.default_rng(seed)
    hi, frac = (3, 0.0) if kind == "ties" else (100, 0.2)
    arrs = []
    for s in ((q, k1), (k1, k2), (q, k2)):
        x = rng.integers(0, hi, s).astype(np.float32)
        x[rng.random(s) < frac] = np.inf
        arrs.append(x)
    if kind == "serve":            # <= 8 finite entries a row, as served
        for x in (arrs[0], arrs[2]):
            keep = np.zeros(x.shape, bool)
            for r in range(x.shape[0]):
                lo = rng.integers(0, max(1, x.shape[1] - 8))
                keep[r, lo:lo + 8] = True
            x[~keep] = np.inf
    if kind == "inf":
        arrs[0][::2] = np.inf
    return [torch.from_numpy(x) for x in arrs]


# (q, k1, k2, kind): ragged tiles in x (32) and y (64)
ARGMIN_CASES = [(33, 130, 201, "ties"), (5, 7, 3, "ties"),
                (16, 480, 100, "ties"), (40, 97, 129, "ragged"),
                (9, 70, 65, "inf"), (24, 300, 150, "serve")]


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("q,k1,k2,kind", ARGMIN_CASES)
def test_argmin_split_model_equals_plain(q, k1, k2, kind, splits):
    args = _argmin_input(q, k1, k2, kind, seed=q * 31 + k1 + splits)
    want = ref.minplus_twoside_argmin_ref(*args)
    got = ref.minplus_twoside_argmin_split_ref(*args, splits=splits)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("q,k1,k2", [(16, 480, 480), (1024, 480, 480),
                                     (16, 4614, 4614), (1024, 4614, 4614),
                                     (1, 40, 3000), (64, 1712, 1712)])
def test_wrapper_split_count(q, k1, k2):
    """The wrapper splits x only while the grid is under two waves, into
    at most one split per x-tile; the model at that count is exact."""
    splits = minplus_twoside.x_splits(q, k1, k2)
    tiles = -(-k2 // 64) * -(-q // 64)
    assert 1 <= splits <= max(1, -(-k1 // 32))
    assert splits == 1 or tiles * splits <= minplus_twoside.TWO_WAVES
    if k1 <= 480 and q <= 16:
        args = _argmin_input(q, k1, k2, "ties", seed=k1)
        got = ref.minplus_twoside_argmin_split_ref(*args, splits=splits)
        for g, w in zip(got, ref.minplus_twoside_argmin_ref(*args)):
            assert torch.equal(g, w)
