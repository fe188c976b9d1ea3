"""The distance-only blocked APSP (``ops.fw_apsp``) and its kernels.

``floyd_warshall.fw_blocked`` runs the reference's 3-phase schedule in
place on one padded matrix: phase 1 (``ops.fw_batch``) on the diagonal
tile, phases 2 and 3 (``ops.minplus_accum_panels`` and
``ops.minplus_accum_into``) on views of the matrix that alias each
other and skip the band cells, which phase 2 and 3 leave as they are.
On the CPU the same views go through the plain versions, so these
tests hold the schedule's index arithmetic:
array-equal to the reference package's ``fw_blocked`` (Pallas in
interpret mode, as its own tests run it on the CPU) and to the serial
``fw_ref``, at ragged n, n below the k-block, k-block widths 32, 64
and 128, an all-+inf diagonal block, a disconnected matrix and zero
weights (ties).  ``ref.minplus_accum_into_ref``, the plain model of the
in-place kernel entry, is held against ``minplus_accum_ref`` on strided
views with skipped rows and columns.

The ``cuda`` tests run the kernels on the card (skipped without one):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fw_apsp.py

Integer-valued inputs keep every sum below 2**24: the tolerance is
exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import floyd_warshall, minplus, ops, ref

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jfw():
    """The reference package's blocked FW (and jnp)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import floyd_warshall
    from repro.kernels import ref as jref
    return jnp, floyd_warshall, jref


def _apsp_input(kind: str, n: int, block: int, seed: int) -> np.ndarray:
    """[n, n] float32: "sparse" integers below 100 with 70% +inf; "ties"
    values from {0, 1, 2} (zero weights) with 60% +inf; "diag_inf" the
    sparse kind with the second diagonal block (k-block 1) all +inf;
    "disconnected" two components with no edge between them."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        d = rng.integers(0, 3, (n, n)).astype(np.float32)
        d[rng.random((n, n)) < 0.6] = np.inf
        return d
    d = rng.integers(0, 100, (n, n)).astype(np.float32)
    d[rng.random((n, n)) < 0.7] = np.inf
    if kind == "diag_inf":
        d[block:2 * block, block:2 * block] = np.inf
    elif kind == "disconnected":
        h = n // 2
        d[:h, h:] = np.inf
        d[h:, :h] = np.inf
    return d


APSP_CASES = [
    ("sparse", 100, 32),           # ragged n
    ("sparse", 70, 128),           # n below the k-block
    ("sparse", 150, 64),
    ("sparse", 130, 128),
    ("ties", 97, 32),
    ("ties", 140, 64),
    ("diag_inf", 90, 32),
    ("diag_inf", 150, 64),
    ("disconnected", 101, 32),
    ("disconnected", 77, 64),
]


@pytest.mark.parametrize("kind,n,block", APSP_CASES)
def test_fw_blocked_in_place_matches_reference(jfw, kind, n, block):
    jnp, jfloyd, jref = jfw
    d = _apsp_input(kind, n, block, n * 7 + block)
    got = floyd_warshall.fw_blocked(torch.from_numpy(d), block=block)
    assert got.shape == (n, n) and got.is_contiguous()
    want = np.asarray(jfloyd.fw_blocked(jnp.asarray(d), block=block,
                                        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.fw_ref(torch.from_numpy(d)).numpy())
    np.testing.assert_array_equal(want, np.asarray(jref.fw_ref(
        jnp.asarray(d))))
    if kind == "disconnected":
        h = n // 2
        assert np.isinf(want[:h, h:]).all() and np.isinf(want[h:, :h]).all()


@pytest.mark.parametrize("block", [32, 64, 128])
def test_fw_blocked_widths_agree(block):
    """Every k-block width gives the serial closure (the distances of an
    exact APSP do not depend on the schedule)."""
    d = torch.from_numpy(_apsp_input("ties", 131, block, 5))
    assert torch.equal(floyd_warshall.fw_blocked(d, block=block),
                       ref.fw_ref(d))


def test_fw_blocked_passes_views_to_the_ops(monkeypatch):
    """The schedule calls phase 1 in place on the diagonal tile and the
    in-place products on views of its one padded matrix: phase 2's row
    and column panels (in one call) alias their own B and A, phase 3
    skips the band."""
    calls = []
    real_fw, real_p2 = ops.fw_batch, ops.minplus_accum_panels
    real_into = ops.minplus_accum_into

    def offsets(*views):
        return tuple(v.storage_offset() for v in views)

    def fw_batch(d, *, out=None, force=None):
        calls.append(("fw", d.shape, out is d, d.stride()[1:],
                      d.storage_offset()))
        return real_fw(d, out=out, force=force)

    def panels(row, col, *, skip_cols=(0, 0), skip_rows=(0, 0), force=None):
        calls.append(("p2", [tuple(v.shape) for v in row + col],
                      offsets(*row), offsets(*col), skip_cols, skip_rows))
        return real_p2(row, col, skip_cols=skip_cols, skip_rows=skip_rows,
                       force=force)

    def into(c, a, b, *, skip_rows=(0, 0), skip_cols=(0, 0), force=None):
        calls.append(("mp", [tuple(v.shape) for v in (c, a, b)],
                      offsets(c, a, b), skip_rows, skip_cols))
        return real_into(c, a, b, skip_rows=skip_rows, skip_cols=skip_cols,
                         force=force)

    monkeypatch.setattr(ops, "fw_batch", fw_batch)
    monkeypatch.setattr(ops, "minplus_accum_panels", panels)
    monkeypatch.setattr(ops, "minplus_accum_into", into)
    d = torch.from_numpy(_apsp_input("sparse", 50, 32, 1))
    got = floyd_warshall.fw_blocked(d, block=32)
    assert torch.equal(got, ref.fw_ref(d))
    assert [st[0] for st in floyd_warshall.blocked_steps(64, 32)] == [
        "fw", "p2", "mp"] * 2
    assert len(calls) == 2 * 3
    for kb in range(2):
        s, e = 32 * kb, 32 * kb + 32
        fw, p2, p3 = calls[3 * kb:3 * kb + 3]
        # offsets into the one padded [64, 64] matrix: the row panel is
        # its own B, the column panel its own A
        assert fw == ("fw", (1, 32, 32), True, (64, 1), 65 * s)
        assert p2 == ("p2", [(32, 64), (32, 32), (32, 64), (64, 32),
                             (64, 32), (32, 32)],
                      (64 * s, 65 * s, 64 * s), (s, s, 65 * s), (s, e),
                      (s, e))
        assert p3 == ("mp", [(64, 64), (64, 32), (32, 64)],
                      (0, s, 64 * s), (s, e), (s, e))


def _int_inf(shape, rng, inf_frac=0.2, hi=100):
    x = rng.integers(0, hi, size=shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


@pytest.mark.parametrize("m,k,n,skip_rows,skip_cols", [
    (37, 13, 53, (0, 0), (0, 0)),
    (64, 32, 96, (0, 0), (32, 64)),
    (96, 32, 64, (32, 64), (0, 0)),
    (100, 29, 77, (10, 39), (40, 69)),
])
def test_minplus_accum_into_ref_on_strided_views(m, k, n, skip_rows,
                                                 skip_cols):
    """The in-place plain model writes min(C, A (x) B) into a strided
    view of a larger matrix, leaves the skipped rows and columns and
    everything outside the view as they were."""
    rng = np.random.default_rng(m + k + n)
    big = torch.from_numpy(_int_inf((m + 9, n + 11), rng, hi=400))
    a = torch.from_numpy(_int_inf((m, k + 3), rng))[:, 1:k + 1]
    b = torch.from_numpy(_int_inf((k + 2, n + 5), rng))[2:, 3:n + 3]
    before = big.clone()
    c = big[4:4 + m, 5:5 + n]
    assert c.stride() == (n + 11, 1) and a.stride(0) == k + 3
    out = ref.minplus_accum_into_ref(c, a, b, skip_rows=skip_rows,
                                     skip_cols=skip_cols)
    assert out.data_ptr() == c.data_ptr()
    want = ref.minplus_accum_ref(before[4:4 + m, 5:5 + n], a, b)
    keep = torch.zeros((m, n), dtype=torch.bool)
    keep[skip_rows[0]:skip_rows[1]] = True
    keep[:, skip_cols[0]:skip_cols[1]] = True
    assert torch.equal(c, torch.where(keep, before[4:4 + m, 5:5 + n], want))
    outside = torch.ones_like(big, dtype=torch.bool)
    outside[4:4 + m, 5:5 + n] = False
    assert torch.equal(big[outside], before[outside])


def test_minplus_accum_into_ref_aliases_like_phase_2():
    """C = B (the row panel) and C = A (the column panel): the product is
    formed before anything is written, as the panels kernel's block
    ownership gives (``minplus_accum_panels``, modelled by the in-place
    plain version on each panel)."""
    rng = np.random.default_rng(11)
    p = ref.fw_ref(torch.from_numpy(_int_inf((16, 16), rng)))
    row0 = torch.from_numpy(_int_inf((16, 70), rng))
    row = row0.clone()
    ops.minplus_accum_into(row, p, row)
    assert torch.equal(row, ref.minplus_accum_ref(row0, p, row0))
    col0 = torch.from_numpy(_int_inf((70, 16), rng))
    col = col0.clone()
    ops.minplus_accum_into(col, col, p)
    assert torch.equal(col, ref.minplus_accum_ref(col0, col0, p))
    row, col = row0.clone(), col0.clone()
    ops.minplus_accum_panels((row, p, row), (col, col, p))
    assert torch.equal(row, ref.minplus_accum_ref(row0, p, row0))
    assert torch.equal(col, ref.minplus_accum_ref(col0, col0, p))


def test_fw_batch_out_and_cpu_dispatch_count_nothing():
    """ops.fw_batch(out=) writes the plain closure into a strided view;
    a CPU tensor launches no kernel and the kernel wrappers refuse it."""
    counters = (floyd_warshall.fw_batch_cuda,
                minplus.minplus_accum_panels_cuda,
                minplus.minplus_accum_into_cuda)
    before = [k.launches for k in counters]
    rng = np.random.default_rng(4)
    big = torch.from_numpy(_int_inf((40, 40), rng))
    want = ref.fw_ref(big[8:24, 8:24])
    tile = big[None, 8:24, 8:24]
    assert ops.fw_batch(tile, out=tile).data_ptr() == tile.data_ptr()
    assert torch.equal(big[8:24, 8:24], want)
    with pytest.raises(ValueError, match="CUDA"):
        floyd_warshall.fw_batch_cuda(tile, tile)
    with pytest.raises(ValueError, match="CUDA"):
        minplus.minplus_accum_into_cuda(big, big, big)
    with pytest.raises(ValueError, match="CUDA"):
        ops.minplus_accum_into(big, big, big, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        minplus.minplus_accum_panels_cuda((big, big, big), (big, big, big))
    with pytest.raises(ValueError, match="CUDA"):
        ops.minplus_accum_panels((big, big, big), (big, big, big),
                                 force="kernel")
    assert [k.launches for k in counters] == before


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 64), (1, 128), (3, 100), (2, 240),
                                 (5, 31), (2, 1), (2, 200), (3, 300),
                                 (4, 496)])
def test_fw_batch_kernel_variants_on_card(cuda_device, b, n):
    """Kernel 3 on each route (registers n <= 128, the batched blocked
    schedule above), fresh and in place on a strided tile, array-equal
    to the plain version (one all-+inf entry)."""
    rng = np.random.default_rng(b * 131 + n)
    d_np = _int_inf((b, n, n), rng)
    d_np[b - 1] = np.inf
    d = torch.from_numpy(d_np).to(cuda_device)
    want = ops.fw_batch(d, force="ref")
    assert torch.equal(floyd_warshall.fw_batch_cuda(d),
                       want)
    big = torch.full((b, n + 7, n + 9), 5.0, device=cuda_device)
    tile = big[:, 3:3 + n, 4:4 + n]
    tile.copy_(d)
    floyd_warshall.fw_batch_cuda(tile, tile)
    assert torch.equal(tile, want)
    rest = torch.ones_like(big, dtype=torch.bool)
    rest[:, 3:3 + n, 4:4 + n] = False
    assert bool((big[rest] == 5.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("np_,block,s,kind", [
    (1792, 128, 512, "ragged"), (1792, 128, 0, "ties"),
    (1728, 64, 1664, "ragged"), (300, 128, 128, "ragged"),
    (100, 32, 64, "ties"), (1792, 128, 1664, "inf"),
    (1728, 64, 576, "open"), (100, 32, 64, "open")])
def test_minplus_accum_into_phases_on_card(cuda_device, np_, block, s,
                                           kind):
    """The in-place entries at the schedule's shapes, ragged widths
    included, against the plain model on the same views: phase 2 in one
    launch with its aliased panels, and each panel alone through
    ``minplus_accum_into`` (which takes no panel alias, so its aliased
    operand is a copy); phase 3 with its band skipped.  "inf" blocks are
    all +inf in the pivot tile; "open" leaves the pivot tile unclosed,
    so a block that read a cell another block had already updated would
    show."""
    rng = np.random.default_rng(np_ + block + s)
    if kind == "ties":
        x = rng.integers(0, 3, (np_, np_)).astype(np.float32)
        x[rng.random(x.shape) < 0.6] = np.inf
    else:
        x = _int_inf((np_, np_), rng)
    e = min(s + block, np_)
    if kind == "inf":
        x[s:e, s:e] = np.inf
    if kind != "open":
        x[s:e, s:e] = ref.fw_ref(torch.from_numpy(x[s:e, s:e])).numpy()
    got = torch.from_numpy(x).to(cuda_device)
    want = got.clone()
    both = got.clone()
    pairs = ((got, None), (want, "ref"))
    for mat, f in pairs:                        # phase 2
        dkk, row, col = mat[s:e, s:e], mat[s:e], mat[:, s:e]
        ops.minplus_accum_into(row, dkk, row.clone(), skip_cols=(s, e),
                               force=f)
        ops.minplus_accum_into(col, col.clone(), dkk, skip_rows=(s, e),
                               force=f)
    dkk, row, col = both[s:e, s:e], both[s:e], both[:, s:e]
    before = minplus.minplus_accum_panels_cuda.launches
    ops.minplus_accum_panels((row, dkk, row), (col, col, dkk),
                             skip_cols=(s, e), skip_rows=(s, e))
    assert minplus.minplus_accum_panels_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(both, want)
    for mat, f in pairs:                        # phase 3
        ops.minplus_accum_into(mat, mat[:, s:e], mat[s:e], skip_rows=(s, e),
                               skip_cols=(s, e), force=f)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(128, 128, 1792), (1792, 128, 128),
                                   (1792, 128, 1792), (100, 37, 250),
                                   (61, 64, 999), (700, 64, 50)])
def test_minplus_accum_fresh_on_card(cuda_device, m, k, n):
    """The fresh-output entry at each tile shape it picks, with C = B
    or C = A where the shapes allow, against the plain version."""
    rng = np.random.default_rng(m + 3 * k + n)
    a, b, c = (torch.from_numpy(_int_inf(sh, rng)).to(cuda_device)
               for sh in ((m, k), (k, n), (m, n)))
    assert torch.equal(minplus.minplus_accum_cuda(c, a, b),
                       ops.minplus_accum(c, a, b, force="ref"))
    if m == k:
        assert torch.equal(minplus.minplus_accum_cuda(b, a, b),
                           ops.minplus_accum(b, a, b, force="ref"))
    if k == n:
        assert torch.equal(minplus.minplus_accum_cuda(a, a, b),
                           ops.minplus_accum(a, a, b, force="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,inf_frac", [
    (1711, None, 0.995), (300, 128, 0.9),
    (100, 32, 0.9), (1711, 64, 0.995), (77, 128, 0.5)])
def test_fw_apsp_on_card(cuda_device, n, block, inf_frac):
    d = torch.from_numpy(_int_inf((n, n), np.random.default_rng(n),
                                  inf_frac=inf_frac)).to(cuda_device)
    counters = (floyd_warshall.fw_batch_cuda,
                minplus.minplus_accum_panels_cuda,
                minplus.minplus_accum_into_cuda)
    before = [k.launches for k in counters]
    got = ops.fw_apsp(d, block=block)
    kb = -(-n // (block or floyd_warshall.apsp_block(n)))
    assert [k.launches - b for k, b in zip(counters, before)] == [kb] * 3
    assert torch.equal(got, ops.fw_apsp(d, force="ref"))


@pytest.mark.parametrize("np_,block", [(64, 32), (1792, 128), (1728, 64)])
def test_schedule_windows_alias_only_skipped_cells(np_, block):
    """Every operand window of every step lies inside the padded matrix,
    and each that shares memory with C other than as phase 2's panel
    operand (B of the row panel, A of the column panel, the same window
    as C, at most PANEL rows or columns) is a window of C's skipped
    cells: the condition under which the in-place kernels are race-free
    (``csrc/minplus.cu``), checked by the wrappers' own check on CPU
    views."""
    pad = torch.zeros((np_, np_))

    def view(w):
        assert 0 <= w[0] and w[0] + w[2] <= np_
        assert 0 <= w[1] and w[1] + w[3] <= np_
        return pad[w[0]:w[0] + w[2], w[1]:w[1] + w[3]]
    steps = list(floyd_warshall.blocked_steps(np_, block))
    assert len(steps) == 3 * (np_ // block)
    for i, step in enumerate(steps):
        s = block * (i // 3)
        piv = view((s, s, block, block))
        if step[0] == "fw":
            assert step[1] == (s, s, block, block)
            continue
        if step[0] == "p2":
            _, row, skip_c, col, skip_r = step
            jobs = [(row, (0, 0), skip_c, "b"), (col, skip_r, (0, 0), "a")]
            # the two panels write disjoint cells
            assert skip_c == skip_r == (s, s + block)
        else:
            _, c, a, b, skip_r, skip_c = step
            jobs = [((c, a, b), skip_r, skip_c, "")]
        for (c, a, b), skip_r, skip_c, panel in jobs:
            vc, va, vb = view(c), view(a), view(b)
            assert va.shape[1] == vb.shape[0] == block
            m, n = vc.shape
            for name, x in (("b", vb), ("a", va)):
                assert minplus._overlap(vc, x)
                if name == panel:
                    assert minplus._same_window(vc, x)
                    assert (m if name == "b" else n) <= minplus.PANEL
                else:
                    assert minplus._skipped(vc, x, skip_r, skip_c)
            minplus._check_alias("schedule", vc, va, vb, skip_r, skip_c,
                                 panel)
            # the pivot tile, read by every block, is never written
            assert minplus._skipped(vc, piv, skip_r, skip_c)


def test_skipped_and_overlap_helpers():
    x = torch.zeros(256, 256)
    s, e = 128, 256
    assert minplus._skipped(x, x[s:e, s:e], (s, e), (0, 0))
    assert minplus._skipped(x[:, s:e], x[s:e, s:e], (s, e), (0, 0))
    assert minplus._skipped(x[s:e], x[s:e, s:e], (0, 0), (s, e))
    assert minplus._skipped(x, x[:, s:e], (s, e), (s, e))
    assert not minplus._skipped(x, x[:, 0:128], (s, e), (s, e))
    assert not minplus._skipped(x, x[0:130, 0:10], (s, e), (s, e))
    assert not minplus._skipped(x, torch.zeros(4, 4), (0, 256), (0, 0))
    assert minplus._overlap(x, x[5:7, 9:11])
    assert not minplus._overlap(x[:10], x[20:])


def _alias_refused(c, a, b, skip_r=(0, 0), skip_c=(0, 0), panel=""):
    try:
        minplus._check_alias("t", c, a, b, skip_r, skip_c, panel)
    except ValueError:
        return True
    return False


def test_alias_check_takes_only_skipped_cells_and_same_window_panels():
    """The wrappers' alias rule on CPU views: a panel operand may be the
    same window as C (start and row stride), never a shifted view of
    it; the in-place entry (no panel operand) takes no alias outside
    C's skipped cells, at any width; the other operand of a panel job
    only in skipped cells."""
    x = torch.zeros(256, 256)
    other = torch.zeros(64, 256)
    row, piv = x[64:128], x[64:128, 64:128]
    assert not _alias_refused(row, piv, row, skip_c=(64, 128), panel="b")
    assert _alias_refused(row, piv, x[65:129], skip_c=(64, 128), panel="b")
    assert _alias_refused(row, piv, row, skip_c=(64, 128))
    assert _alias_refused(row, row[:, :64], other, panel="b")
    col = x[:, 64:128]
    assert not _alias_refused(col, col, piv, skip_r=(64, 128), panel="a")
    assert _alias_refused(col, x[:, 65:129], piv, skip_r=(64, 128),
                          panel="a")
    assert _alias_refused(col, col, piv, skip_r=(64, 128))
    narrow = x[:100, :32]
    assert _alias_refused(narrow, narrow, torch.zeros(32, 32))
    assert _alias_refused(narrow, torch.zeros(100, 64), x[:64, :32])
    assert not _alias_refused(x, x[:, 64:128], x[64:128], (64, 128),
                              (64, 128))
    assert not _alias_refused(x, torch.zeros(256, 8), torch.zeros(8, 256))


def test_apsp_block_by_size():
    """The k-block width follows n (64 up to APSP_WIDE_N, 128 above), and
    fw_blocked's default takes it."""
    assert floyd_warshall.apsp_block(1711) == 64
    assert floyd_warshall.apsp_block(floyd_warshall.APSP_WIDE_N) == 64
    assert floyd_warshall.apsp_block(4661) == 128
    d = torch.from_numpy(_apsp_input("sparse", 70, 64, 3))
    assert torch.equal(floyd_warshall.fw_blocked(d), ref.fw_ref(d))
