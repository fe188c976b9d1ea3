"""Kernel 3 above n = 128: the blocked schedule over a batch of matrices.

``floyd_warshall.fw_batch_cuda`` sends every n above ``DIST_REG_MAX_N``
to ``fw_dist_blocked_cuda``: ``fw_blocked_into`` on the output, every
matrix of the batch at once, in k-blocks of ``DIST_BLOCK`` (phase 1
``fw_dist_reg`` on the pivot tiles, phase 2 ``minplus_accum_panels``,
phase 3 ``minplus_accum_ld``, each one launch over the batch).  On the
CPU the same windows go through the plain versions on views of the
batch, so these tests hold the schedule's index arithmetic:

  * the batched schedule == ``ref.fw_batch_ref`` == the reference
    package's ``ops.fw_batch`` (its CPU dispatch) at (b, n) = (1, 129),
    (2, 200), (3, 300), (2, 496), on road-fragment-like inputs (integer
    weights, ~80% +inf, one all-+inf matrix, n no multiple of the
    k-block), and at k-blocks of 32 and 128 too;
  * at b = 1, unpadded, it equals ``fw_blocked`` (``ops.fw_apsp``'s
    padded matrix);
  * the pointers, strides and sizes the card's launch sites get
    (``_card_launches``) are those of the views the CPU walks;
  * the ``meta`` route of ``ops.fw_batch`` allocates what the card route
    allocates (the output, nothing else);
  * the batched plain versions of the in-place (min,+) entries, and the
    wrappers' alias rule on batches.

The ``cuda`` tests run the kernels on the card (skipped without one):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fw_dist_blocked.py

Integer-valued inputs keep every sum below 2**24: the tolerance is
exact.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import floyd_warshall, minplus, ops, ref

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jops():
    """The reference package's kernel dispatch (jnp on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as reference_ops
    return jnp, reference_ops


def _fragments(b: int, n: int, seed: int, all_inf=(0,)) -> np.ndarray:
    """[b, n, n] float32 shaped like a road fragment batch: matrix i has
    f_i real nodes in its top-left corner (f_i from n / 4 to n), each
    pair joined with probability 0.15 by an integer weight in [1, 100),
    every other cell +inf (~80% of the batch); matrices ``all_inf``
    wholly +inf."""
    rng = np.random.default_rng(seed)
    d = np.full((b, n, n), np.inf, dtype=np.float32)
    for i in range(b):
        f = int(rng.integers(n // 4, n + 1))
        w = rng.integers(1, 100, (f, f)).astype(np.float32)
        w[rng.random((f, f)) >= 0.15] = np.inf
        d[i, :f, :f] = w
    d[list(all_inf)] = np.inf
    return d


BATCH_CASES = [(1, 129), (2, 200), (3, 300), (2, 496)]


@pytest.mark.parametrize("b,n", BATCH_CASES)
def test_batched_blocked_matches_reference(jops, b, n):
    jnp, reference_ops = jops
    d = _fragments(b, n, b * 1000 + n, all_inf=(b - 1,) if b > 1 else ())
    assert np.isinf(d).mean() > 0.6 and n % floyd_warshall.DIST_BLOCK
    x = torch.from_numpy(d.copy())
    got = floyd_warshall.fw_blocked_into(x, block=floyd_warshall.DIST_BLOCK)
    assert got is x
    want = ref.fw_batch_ref(torch.from_numpy(d))
    assert torch.equal(x, want)
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(reference_ops.fw_batch(jnp.asarray(d))))
    if b > 1:
        assert torch.isinf(x[b - 1]).sum() == n * n - n
    assert torch.equal(ops.fw_batch(torch.from_numpy(d)), want)


@pytest.mark.parametrize("b,n,block", [(2, 200, 32), (2, 200, 128),
                                       (3, 150, 128), (4, 70, 32)])
def test_batched_blocked_widths_agree(b, n, block):
    """Every k-block width gives the serial closure, tie-heavy values
    (zero weights) included."""
    rng = np.random.default_rng(b + n + block)
    d = rng.integers(0, 3, (b, n, n)).astype(np.float32)
    d[rng.random(d.shape) < 0.7] = np.inf
    x = torch.from_numpy(d.copy())
    floyd_warshall.fw_blocked_into(x, block=block)
    assert torch.equal(x, ref.fw_batch_ref(torch.from_numpy(d)))


@pytest.mark.parametrize("n,block", [(129, 64), (200, 64), (77, 32),
                                     (300, 128)])
def test_batch_of_one_equals_fw_blocked(n, block):
    """At b = 1 the unpadded batched schedule (the last k-block short,
    the diagonal left as given) equals ``fw_blocked``'s padded matrix
    and the serial ``fw_ref``."""
    d = _fragments(1, n, n, all_inf=())[0]
    d[np.arange(n), np.arange(n)] = 7.0          # zeroed by phase 1
    x = torch.from_numpy(d.copy())[None]
    floyd_warshall.fw_blocked_into(x, block=block)
    padded = floyd_warshall.fw_blocked(torch.from_numpy(d), block=block)
    assert torch.equal(x[0], padded)
    assert torch.equal(padded, ref.fw_ref(torch.from_numpy(d)))


def _record_cpu_views(monkeypatch):
    """Patches ``ops``' three phases to record the views the CPU walk
    hands them (and still run them)."""
    calls = []
    real_fw, real_p2 = ops.fw_batch, ops.minplus_accum_panels
    real_into = ops.minplus_accum_into

    def fw_batch(d, *, out=None, force=None):
        calls.append(("fw", d, out))
        return real_fw(d, out=out, force=force)

    def panels(row, col, *, skip_cols=(0, 0), skip_rows=(0, 0), force=None):
        calls.append(("p2", row, skip_cols, col, skip_rows))
        return real_p2(row, col, skip_cols=skip_cols, skip_rows=skip_rows,
                       force=force)

    def into(c, a, b, *, skip_rows=(0, 0), skip_cols=(0, 0), force=None):
        calls.append(("mp", (c, a, b), skip_rows, skip_cols))
        return real_into(c, a, b, skip_rows=skip_rows, skip_cols=skip_cols,
                         force=force)
    monkeypatch.setattr(ops, "fw_batch", fw_batch)
    monkeypatch.setattr(ops, "minplus_accum_panels", panels)
    monkeypatch.setattr(ops, "minplus_accum_into", into)
    return calls


@pytest.mark.parametrize("shape,block", [((3, 200, 200), 64),
                                         ((1, 129, 129), 64),
                                         ((2, 130, 130), 128),
                                         ((100, 100), 32),
                                         ((2, 496, 496), 64)])
def test_card_windows_are_the_cpu_windows(monkeypatch, shape, block):
    """``_card_launches`` (what the card's launch sites get) computes,
    launch for launch, the addresses, row and batch strides and sizes of
    the views the CPU walk passes to the plain versions; the result is
    the serial closure."""
    calls = _record_cpu_views(monkeypatch)
    n = shape[-1]
    b = shape[0] if len(shape) == 3 else 1
    d = _fragments(b, n, n + block, all_inf=())
    x = torch.from_numpy(d.copy()).reshape(shape)
    card = list(floyd_warshall._card_launches(
        x, floyd_warshall.blocked_steps(n, block)))
    floyd_warshall.fw_blocked_into(x, block=block)
    assert torch.equal(x.reshape(b, n, n), ref.fw_batch_ref(
        torch.from_numpy(d)))
    kb = -(-n // block)
    assert len(card) == len(calls) == 3 * kb
    assert [c[0] for c in card] == [c[0] for c in calls] == ["fw", "p2",
                                                            "mp"] * kb
    for launch, call in zip(card, calls):
        if call[0] == "fw":
            tile, out = call[1], call[2]
            assert out is tile
            assert launch[1:] == (tile.data_ptr(), tile.shape[0],
                                  tile.shape[-1], tile.stride(-2),
                                  tile.stride(0) if b > 1 else 0)
        elif call[0] == "p2":
            _, row, skip_c, col, skip_r = call
            assert launch[1:] == (minplus._job(*row), skip_c,
                                  minplus._job(*col), skip_r)
        else:
            _, views, skip_r, skip_c = call
            assert launch[1:] == (minplus._job(*views), skip_r, skip_c)
    # the last k-block is the short one, its pivot tile at (s, s) of
    # every matrix
    s = block * (kb - 1)
    assert card[-3][1:] == (x.data_ptr() + 4 * (s * n + s), b, n - s, n,
                            n * n if b > 1 else 0)


def test_blocked_steps_clip_the_last_block():
    """The windows of a ragged n: whole k-blocks, then one of n % block
    pivots; a multiple of the block gives whole k-blocks only."""
    steps = list(floyd_warshall.blocked_steps(100, 64))
    assert steps[3:] == [
        ("fw", (64, 64, 36, 36)),
        ("p2", ((64, 0, 36, 100), (64, 64, 36, 36), (64, 0, 36, 100)),
         (64, 100), ((0, 64, 100, 36), (0, 64, 100, 36), (64, 64, 36, 36)),
         (64, 100)),
        ("mp", (0, 0, 100, 100), (0, 64, 100, 36), (64, 0, 36, 100),
         (64, 100), (64, 100))]
    assert [st[1] for st in floyd_warshall.blocked_steps(128, 64)
            if st[0] == "fw"] == [(0, 0, 64, 64), (64, 64, 64, 64)]


class _Allocations(TorchDispatchMode):
    """Records (shape, dtype) of every tensor an op creates (not a view,
    not in place)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and not func._schema.is_mutable:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.made.append((tuple(t.shape), t.dtype))
        return out


@pytest.mark.parametrize("b,n", [(3, 200), (130, 496)])
def test_meta_route_allocates_what_the_card_route_allocates(monkeypatch,
                                                            b, n):
    """The card route above n = 128 allocates its output and nothing
    else (in place, no padding or scratch), which is what ``ops.fw_batch``
    returns on ``meta``; given ``out``, neither allocates.  The card
    route runs here on ``meta`` tensors with the device check and the
    launches patched out."""
    launched = []
    monkeypatch.setattr(floyd_warshall, "_check_rows",
                        lambda d, kernel: (d.shape[0], d.shape[1]))
    monkeypatch.setattr(floyd_warshall, "_blocked_cuda",
                        lambda x, steps, block: launched.append(
                            (tuple(x.shape), len(list(steps)), block)))
    d = torch.empty((b, n, n), device="meta")
    for out in (None, torch.empty_like(d)):
        with _Allocations() as card:
            got = floyd_warshall.fw_batch_cuda(d, out)
        with _Allocations() as meta:
            want = ops.fw_batch(d, out=out)
        assert card.made == meta.made == ([] if out is not None
                                          else [((b, n, n), torch.float32)])
        assert got.shape == want.shape == (b, n, n)
    kb = -(-n // floyd_warshall.DIST_BLOCK)
    assert launched == [((b, n, n), 3 * kb, floyd_warshall.DIST_BLOCK)] * 2


def test_cpu_tensors_refuse_the_kernels_and_count_nothing():
    """A CPU tensor runs the plain version; the kernel wrappers and
    ``force="kernel"`` refuse it (no fallback), and no counter moves."""
    counters = (floyd_warshall.fw_batch_cuda,
                floyd_warshall.fw_dist_blocked_cuda,
                minplus.minplus_accum_panels_cuda,
                minplus.minplus_accum_into_cuda)
    before = [k.launches for k in counters]
    d = torch.from_numpy(_fragments(2, 150, 3))
    assert torch.equal(ops.fw_batch(d), ref.fw_batch_ref(d))
    for call in (lambda: floyd_warshall.fw_batch_cuda(d),
                 lambda: ops.fw_batch(d, force="kernel"),
                 lambda: floyd_warshall.fw_blocked_into(
                     d.clone(), block=64, force="kernel")):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [k.launches for k in counters] == before


def _int_inf(shape, rng, inf_frac=0.2, hi=100):
    x = rng.integers(0, hi, size=shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


def test_batched_plain_models_are_per_matrix():
    """The plain versions of the in-place entries on batches of strided
    views give, matrix for matrix, their 2-D results, skipped rows and
    columns and everything outside the views untouched."""
    rng = np.random.default_rng(8)
    big = torch.from_numpy(_int_inf((3, 40, 50), rng, hi=400))
    a = torch.from_numpy(_int_inf((3, 30, 20), rng))[:, 2:, 3:11]
    b = torch.from_numpy(_int_inf((3, 9, 44), rng))[:, 1:, 4:]
    before = big.clone()
    c = big[:, 5:33, 2:42]
    ref.minplus_accum_into_ref(c, a, b, skip_rows=(3, 9),
                               skip_cols=(10, 12))
    for z in range(3):
        want = before[z].clone()
        ref.minplus_accum_into_ref(want[5:33, 2:42], a[z], b[z],
                                   skip_rows=(3, 9), skip_cols=(10, 12))
        assert torch.equal(big[z], want)
    row, col = before.clone(), before.clone()
    pr, pc = row[:, :8, :8], col[:, :8, :8]
    ref.minplus_accum_panels_ref((row[:, :8], pr, row[:, :8]),
                                 (col[:, :, :8], col[:, :, :8], pc),
                                 skip_cols=(0, 8), skip_rows=(0, 8))
    for z in range(3):
        r2, c2 = before[z].clone(), before[z].clone()
        ref.minplus_accum_panels_ref((r2[:8], r2[:8, :8], r2[:8]),
                                     (c2[:, :8], c2[:, :8], c2[:8, :8]),
                                     skip_cols=(0, 8), skip_rows=(0, 8))
        assert torch.equal(row[z, :8], r2[:8])
        assert torch.equal(col[z, :, :8], c2[:, :8])


def test_batch_alias_rule():
    """The wrappers' alias rule on batches: the schedule's windows of a
    batch pass (each matrix's own band), an operand that reaches into
    another matrix of the batch is refused, as is a batch view whose
    matrices share memory."""
    x = torch.zeros(3, 128, 128)
    s, e = 64, 128
    row, col, piv = x[:, s:e], x[:, :, s:e], x[:, s:e, s:e]
    minplus._check_alias("t", x, col, row, (s, e), (s, e))
    minplus._check_alias("t", row, piv, row, (0, 0), (s, e), "b")
    minplus._check_alias("t", col, col, piv, (s, e), (0, 0), "a")
    flat = x.reshape(-1, 128)
    shifted = flat[128:].reshape(-1)[:2 * 128 * 128].reshape(2, 128, 128)
    with pytest.raises(ValueError, match="across the matrices"):
        minplus._check_alias("t", x[:2], shifted[:, :, s:e],
                             shifted[:, s:e], (s, e), (s, e))
    assert minplus._same_slots(x, col) and not minplus._same_slots(
        x[:2], shifted)
    # a batch job: one Job, strides and sizes of the views
    job = minplus._job(x[:, :, :], col, row)
    assert (job.batch, job.bsc, job.bsa, job.bsb) == (3, 128 * 128,
                                                      128 * 128, 128 * 128)
    assert (job.m, job.n, job.k, job.ldc) == (128, 128, 64, 128)
    one = minplus._job(x[:1], col[:1], row[:1])
    assert (one.batch, one.bsc, one.bsa, one.bsb) == (1, 0, 0, 0)


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", BATCH_CASES + [(130, 496), (5, 64 * 3)])
def test_blocked_route_on_card(cuda_device, b, n):
    """Kernel 3's route above n = 128 on fragment-like batches: fresh,
    into a given output, and in place on strided views; array-equal to
    the plain version, with 3 launches a k-block counted on the three
    kernels and one call on the route."""
    d = torch.from_numpy(_fragments(b, n, b + n, all_inf=(b - 1,))).to(
        cuda_device)
    want = ops.fw_batch(d, force="ref")
    counters = (floyd_warshall.fw_dist_blocked_cuda,
                floyd_warshall.fw_batch_cuda,
                minplus.minplus_accum_panels_cuda,
                minplus.minplus_accum_into_cuda)
    before = [k.launches for k in counters]
    got = ops.fw_batch(d)
    kb = -(-n // floyd_warshall.DIST_BLOCK)
    assert [k.launches - c for k, c in zip(counters, before)] == [
        1, kb, kb, kb]
    assert torch.equal(got, want)
    out = torch.full_like(d, 3.0)
    assert floyd_warshall.fw_batch_cuda(d, out) is out
    assert torch.equal(out, want)
    big = torch.full((b, n + 3, n + 8), 5.0, device=cuda_device)
    tile = big[:, 1:1 + n, 4:4 + n]
    tile.copy_(d)
    floyd_warshall.fw_batch_cuda(tile, tile)
    assert torch.equal(tile, want)
    rest = torch.ones_like(big, dtype=torch.bool)
    rest[:, 1:1 + n, 4:4 + n] = False
    assert bool((big[rest] == 5.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("block", [32, 128])
def test_blocked_widths_on_card(cuda_device, block):
    d = torch.from_numpy(_fragments(6, 300, block)).to(cuda_device)
    x = d.clone()
    floyd_warshall.fw_blocked_into(x, block=block)
    assert torch.equal(x, ops.fw_batch(d, force="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,np_,block,s", [(3, 496, 64, 448),
                                           (2, 300, 128, 128),
                                           (4, 200, 64, 0)])
def test_batched_inplace_entries_on_card(cuda_device, b, np_, block, s):
    """The in-place entries over a batch (the grid's z axis), on views of
    [b, np_, np_] as the schedule passes them: phase 2's panels in one
    launch, phase 3 with its band skipped, against the plain versions
    on a copy; a matrix that is all +inf outside its pivot tile is
    skipped and left as it was."""
    rng = np.random.default_rng(b + np_ + s)
    x = _int_inf((b, np_, np_), rng, inf_frac=0.8)
    e = min(s + block, np_)
    x[0] = np.inf
    x[0, s:e, s:e] = 0.0
    for z in range(b):
        x[z, s:e, s:e] = ref.fw_ref(torch.from_numpy(x[z, s:e, s:e])).numpy()
    got = torch.from_numpy(x).to(cuda_device)
    want = got.clone()
    for mat, f in ((got, None), (want, "ref")):
        piv, row, col = mat[:, s:e, s:e], mat[:, s:e], mat[:, :, s:e]
        ops.minplus_accum_panels((row, piv, row), (col, col, piv),
                                 skip_cols=(s, e), skip_rows=(s, e),
                                 force=f)
        ops.minplus_accum_into(mat, col, row, skip_rows=(s, e),
                               skip_cols=(s, e), force=f)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[0], torch.from_numpy(x[0]).to(cuda_device))
