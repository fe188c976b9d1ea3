"""The port's kernel layer against the reference package's.

The same numpy-seeded, integer-valued float32 inputs (about 20% +inf)
go through ``repro.kernels`` (jnp oracle, and the Pallas kernel in
interpret mode) and ``repro_torch.kernels``; integer weights keep every
sum below 2**24, so the tolerance is exact (``assert_array_equal``).
On the CPU the port runs its plain versions; the CUDA kernels run on the
card only (tests marked ``cuda``, skipped where there is no card).  The
reference package is imported through a fixture, so the ``cuda`` tests
also run on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, floyd_warshall, label_merge, minplus
from repro_torch.kernels import minplus_twoside, ops, ref

# tiny tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def J():
    """The reference package's kernel layer (jnp oracles, Pallas)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return SimpleNamespace(jnp=jnp, ops=jops, ref=jref)


def _int_inf(shape, rng, inf_frac=0.2, hi=100):
    x = rng.integers(0, hi, size=shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


def _fw_input(b, n, rng, all_inf=()):
    d = _int_inf((b, n, n), rng)
    for i in all_inf:
        d[i] = np.inf
    return d


FW_SHAPES = [(1, 1, ()), (3, 13, ()), (2, 37, (1,)), (5, 8, (0, 3)),
             (1, 61, ())]


@pytest.mark.parametrize("b,n,all_inf", FW_SHAPES)
@pytest.mark.parametrize("jforce", ["ref", "pallas"])
def test_fw_batch_next_ref_matches_reference(J, b, n, all_inf, jforce):
    rng = np.random.default_rng(b * 1000 + n)
    d = _fw_input(b, n, rng, all_inf)
    want_d, want_n = J.ops.fw_batch_next(J.jnp.asarray(d), force=jforce)
    got_d, got_n = ref.fw_batch_next_ref(torch.from_numpy(d))
    assert got_d.dtype == torch.float32 and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert not np.isnan(got_d.numpy()).any()


@pytest.mark.parametrize("n", [1, 9, 40])
def test_fw_next_single_and_init_match_reference(J, n):
    rng = np.random.default_rng(n)
    d = _int_inf((n, n), rng)
    want = J.ref.fw_next_ref(J.jnp.asarray(d))
    got = ops.fw_next(torch.from_numpy(d))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(ref.fw_next_init(torch.from_numpy(d)),
                    J.ref.fw_next_init(J.jnp.asarray(d))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


TS_SHAPES = [(1, 1, 1), (5, 7, 3), (16, 48, 480), (37, 130, 201),
             (9, 70, 53)]


@pytest.mark.parametrize("q,k1,k2", TS_SHAPES)
@pytest.mark.parametrize("jforce", ["ref", "pallas"])
def test_minplus_twoside_ref_matches_reference(J, q, k1, k2, jforce):
    rng = np.random.default_rng(q * 7919 + k1 * 31 + k2)
    rows = _int_inf((q, k1), rng)
    d = _int_inf((k1, k2), rng)
    rowt = _int_inf((q, k2), rng)
    want = J.ops.minplus_twoside(J.jnp.asarray(rows), J.jnp.asarray(d),
                                 J.jnp.asarray(rowt), force=jforce)
    got = ops.minplus_twoside(torch.from_numpy(rows), torch.from_numpy(d),
                              torch.from_numpy(rowt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    naive = np.min(rows[:, :, None] + d[None] + rowt[:, None, :],
                   axis=(1, 2))
    np.testing.assert_array_equal(got.numpy(), naive)


def test_minplus_twoside_all_inf(J):
    q, k1, k2 = 16, 24, 33
    inf = np.full((q, k1), np.inf, np.float32)
    d = _int_inf((k1, k2), np.random.default_rng(0))
    rowt = _int_inf((q, k2), np.random.default_rng(1))
    got = ops.minplus_twoside(torch.from_numpy(inf), torch.from_numpy(d),
                              torch.from_numpy(rowt))
    want = J.ref.minplus_twoside_ref(J.jnp.asarray(inf), J.jnp.asarray(d),
                                     J.jnp.asarray(rowt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isinf(got.numpy()).all()


def _argmin_input(q, k1, k2, kind):
    """(rows, d, rowt) for the witness twoside: "ragged" integers with
    ~20% +inf, "ties" values from {0, 1, 2} (many cells at the minimum,
    so the tie rule decides), "inf" all-+inf query rows, "large_ties"
    the ties moved up to BIG - 2, BIG - 1 and BIG, BIG = (2**24 - 1) // 3,
    so that a cell's three terms reach 2**24 - 1, which query 0 reaches
    exactly (one finite entry a side: x = 0, y = k2 - 1)."""
    rng = np.random.default_rng(q * 7919 + k1 * 31 + k2)
    if kind in ("ties", "large_ties"):
        lo = (2**24 - 1) // 3 - 2 if kind == "large_ties" else 0
        rows, d, rowt = (rng.integers(lo, lo + 3, s).astype(np.float32)
                         for s in ((q, k1), (k1, k2), (q, k2)))
        if kind == "large_ties":
            rows[0], rowt[0] = np.inf, np.inf
            rows[0, 0] = rowt[0, k2 - 1] = d[0, k2 - 1] = lo + 2
        return rows, d, rowt
    rows, d, rowt = (_int_inf(s, rng) for s in ((q, k1), (k1, k2), (q, k2)))
    if kind == "inf":
        rows[::2] = np.inf
    return rows, d, rowt


ARGMIN_CASES = [(1, 1, 1, "ragged"), (5, 7, 3, "ragged"),
                (37, 130, 201, "ragged"), (16, 48, 480, "ragged"),
                (9, 70, 53, "inf"), (33, 40, 90, "ties"),
                (4, 17, 5, "ties")]


@pytest.mark.parametrize("q,k1,k2,kind", ARGMIN_CASES)
def test_minplus_twoside_argmin_ref_matches_reference(J, q, k1, k2, kind):
    """out, wx and wy array-equal to the reference's plain version (the
    smallest y at the minimum, then its smallest x)."""
    rows, d, rowt = _argmin_input(q, k1, k2, kind)
    got = ops.minplus_twoside_argmin(*(torch.from_numpy(x)
                                       for x in (rows, d, rowt)))
    want = J.ref.minplus_twoside_argmin_ref(
        *(J.jnp.asarray(x) for x in (rows, d, rowt)))
    for g, w, dtype in zip(got, want, (torch.float32, torch.int32,
                                       torch.int32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(), ops.minplus_twoside(
        *(torch.from_numpy(x) for x in (rows, d, rowt))).numpy())


@pytest.mark.parametrize("q,k1,k2,kind", ARGMIN_CASES)
def test_minplus_twoside_argmin_witness_achieves_min(J, q, k1, k2, kind):
    """Values equal to the Pallas kernel (interpret mode), whose tie rule
    differs (smallest packed x * k2p + y); both witnesses achieve the
    minimum, and are -1 exactly where it is +inf."""
    rows, d, rowt = _argmin_input(q, k1, k2, kind)
    out, wx, wy = (x.numpy() for x in ref.minplus_twoside_argmin_ref(
        *(torch.from_numpy(x) for x in (rows, d, rowt))))
    pal = [np.asarray(x) for x in J.ops.minplus_twoside_argmin(
        *(J.jnp.asarray(x) for x in (rows, d, rowt)), force="pallas")]
    np.testing.assert_array_equal(out, pal[0])
    fin = np.isfinite(out)
    for x, y in ((wx, wy), (pal[1], pal[2])):
        assert (x[~fin] == -1).all() and (y[~fin] == -1).all()
        qi = np.nonzero(fin)[0]
        np.testing.assert_array_equal(
            rows[qi, x[qi]] + d[x[qi], y[qi]] + rowt[qi, y[qi]], out[qi])
    if kind == "inf":
        assert not fin[::2].any()


@pytest.mark.parametrize("q,w,inf_row", [(37, 300, 5), (16, 480, None),
                                         (3, 1, 0), (9, 130, None)])
def test_label_merge_ref_matches_reference(J, q, w, inf_row):
    """label_merge_ref == the reference's plain version and its Pallas
    kernel (interpret mode), +inf labels and an all-+inf row included."""
    rng = np.random.default_rng(q * 31 + w)
    labs = rng.integers(1, 2 ** 20, (q, w)).astype(np.float32)
    labt = rng.integers(1, 2 ** 20, (q, w)).astype(np.float32)
    labs[rng.random(labs.shape) < 0.1] = np.inf
    labt[rng.random(labt.shape) < 0.1] = np.inf
    if inf_row is not None:
        labs[inf_row] = np.inf
    got = ops.label_merge(torch.from_numpy(labs), torch.from_numpy(labt))
    np.testing.assert_array_equal(got.numpy(), np.min(labs + labt, axis=1))
    for jforce in ("ref", "pallas"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            J.ops.label_merge(J.jnp.asarray(labs), J.jnp.asarray(labt),
                              force=jforce)))
    if inf_row is not None:
        assert np.isinf(got[inf_row].item())


MP_SHAPES = [(1, 1, 1), (1, 37, 53), (5, 7, 3), (33, 77, 129),
             (40, 130, 9)]


@pytest.mark.parametrize("m,k,n", MP_SHAPES)
@pytest.mark.parametrize("jforce", ["ref", "pallas"])
def test_minplus_refs_match_reference(J, m, k, n, jforce):
    """minplus_ref and minplus_accum_ref == the reference's minplus /
    minplus_accum (jnp oracle and Pallas in interpret mode), on odd
    shapes with an all-+inf row of A and column of B."""
    rng = np.random.default_rng(m * 7919 + k * 31 + n)
    a, b, c = _int_inf((m, k), rng), _int_inf((k, n), rng), \
        _int_inf((m, n), rng, hi=400)
    a[-1] = np.inf
    b[:, 0] = np.inf
    ja, jb, jc = (J.jnp.asarray(x) for x in (a, b, c))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    got = ops.minplus(ta, tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        J.ops.minplus(ja, jb, force=jforce)))
    np.testing.assert_array_equal(got.numpy(), np.min(
        a[:, :, None] + b[None], axis=1))
    np.testing.assert_array_equal(ops.minplus_accum(tc, ta, tb).numpy(),
                                  np.asarray(J.ops.minplus_accum(
                                      jc, ja, jb, force=jforce)))


@pytest.mark.parametrize("b,n,all_inf", FW_SHAPES)
def test_fw_batch_ref_matches_reference(J, b, n, all_inf):
    rng = np.random.default_rng(b * 1000 + n + 1)
    d = _fw_input(b, n, rng, all_inf)
    got = ops.fw_batch(torch.from_numpy(d))
    for jforce in ("ref", "pallas"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            J.ops.fw_batch(J.jnp.asarray(d), force=jforce)))
    # distance-only FW equals the witness FW's distances
    np.testing.assert_array_equal(
        got.numpy(), ref.fw_batch_next_ref(torch.from_numpy(d))[0].numpy())
    np.testing.assert_array_equal(ref.fw_ref(torch.from_numpy(d[0])),
                                  np.asarray(J.ref.fw_ref(J.jnp.asarray(
                                      d[0]))))


@pytest.mark.parametrize("n,block", [(100, 32), (61, 16), (8, 8),
                                     (40, 64)])
def test_fw_blocked_matches_reference(J, n, block):
    """The blocked 3-phase schedule, run on the CPU through the plain
    versions, == the reference's fw_blocked (Pallas, interpret mode) and
    fw_ref; ops.fw_apsp on the CPU runs fw_ref, as the reference's CPU
    path does."""
    from repro.kernels import floyd_warshall as jfw
    rng = np.random.default_rng(n * 3 + block)
    d = _int_inf((n, n), rng, inf_frac=0.7)
    got = floyd_warshall.fw_blocked(torch.from_numpy(d), block=block)
    assert got.shape == (n, n) and got.is_contiguous()
    want = np.asarray(jfw.fw_blocked(J.jnp.asarray(d), block=block,
                                     interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.fw_apsp(torch.from_numpy(d), block=block).numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(J.ops.fw_apsp(J.jnp.asarray(d), force="ref")))


def test_ops_force_kernel_on_cpu_raises():
    d = torch.zeros((1, 4, 4))
    rows = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fw_batch_next(d, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fw_next(d[0], force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.minplus_twoside(rows, torch.zeros((3, 5)), torch.zeros((2, 5)),
                            force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fw_batch(d, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fw_apsp(d[0], force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.minplus(rows, rows.T, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.minplus_accum(rows, rows, torch.zeros((3, 3)), force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.minplus_twoside_argmin(rows, torch.zeros((3, 5)),
                                   torch.zeros((2, 5)), force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.minplus_twoside_grouped(
            rows, torch.zeros(2, dtype=torch.int64),
            torch.zeros((1, 3), dtype=torch.int32), torch.zeros((3, 5)),
            rows, torch.zeros(2, dtype=torch.int64),
            torch.zeros((1, 3), dtype=torch.int32), force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.label_merge(rows, rows, force="kernel")
    with pytest.raises(ValueError, match="force"):
        ops.use_kernel("cpu", "pallas")


def test_cpu_dispatch_runs_plain_versions_and_counts_nothing():
    """A CPU tensor takes the plain version and launches no kernel;
    the kernel wrappers refuse CPU tensors outright."""
    def counts():
        return (floyd_warshall.fw_next_reg_cuda.launches,
                floyd_warshall.fw_next_blocked_cuda.launches,
                minplus_twoside.minplus_twoside_cuda.launches,
                minplus_twoside.minplus_twoside_grouped_cuda.launches,
                floyd_warshall.fw_batch_cuda.launches,
                minplus.minplus_cuda.launches,
                minplus.minplus_accum_cuda.launches,
                minplus_twoside.minplus_twoside_argmin_cuda.launches,
                label_merge.label_merge_cuda.launches)
    before = counts()
    rng = np.random.default_rng(3)
    d = torch.from_numpy(_fw_input(2, 9, rng))
    for g, w in zip(ops.fw_batch_next(d), ref.fw_batch_next_ref(d)):
        assert torch.equal(g, w)
    assert torch.equal(ops.fw_batch(d), ref.fw_batch_ref(d))
    assert torch.equal(ops.fw_apsp(d[0], block=4), ref.fw_ref(d[0]))
    assert torch.equal(ops.minplus(d[0], d[1]), ref.minplus_ref(d[0], d[1]))
    eye = torch.arange(9, dtype=torch.int32)[None]
    zero = torch.zeros(9, dtype=torch.int64)
    assert torch.equal(
        ops.minplus_twoside_grouped(d[0], zero, eye, d[1], d[0], zero, eye),
        ref.minplus_twoside_ref(d[0], d[1], d[0]))
    for g, w in zip(ops.minplus_twoside_argmin(d[0], d[1], d[0]),
                    ref.minplus_twoside_argmin_ref(d[0], d[1], d[0])):
        assert torch.equal(g, w)
    assert torch.equal(ops.label_merge(d[0], d[1]),
                       ref.label_merge_ref(d[0], d[1]))
    assert not ops.use_kernel("cpu") and not ops.use_kernel("cpu", "ref")
    with pytest.raises(ValueError, match="CUDA"):
        floyd_warshall.fw_batch_next_cuda(d)
    with pytest.raises(ValueError, match="CUDA"):
        floyd_warshall.fw_next_blocked_cuda(d)
    with pytest.raises(ValueError, match="CUDA"):
        minplus_twoside.minplus_twoside_cuda(d[0], d[0], d[0])
    ids = torch.zeros((1, 9), dtype=torch.int32)
    qi = torch.zeros(9, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        minplus_twoside.minplus_twoside_grouped_cuda(d[0], qi, ids, d[1],
                                                     d[0], qi, ids)
    with pytest.raises(ValueError, match="CUDA"):
        floyd_warshall.fw_batch_cuda(d)
    with pytest.raises(ValueError, match="CUDA"):
        minplus.minplus_cuda(d[0], d[1])
    with pytest.raises(ValueError, match="CUDA"):
        minplus.minplus_accum_cuda(d[0], d[0], d[1])
    with pytest.raises(ValueError, match="CUDA"):
        minplus_twoside.minplus_twoside_argmin_cuda(d[0], d[0], d[0])
    with pytest.raises(ValueError, match="CUDA"):
        label_merge.label_merge_cuda(d[0], d[1])
    assert counts() == before


def test_nvcc_command_keeps_exact_arithmetic():
    """The build targets sm_90a and never enables fast math (exactness
    rests on plain IEEE adds and inf handling)."""
    for name in _build.SOURCES:
        cmd = _build.nvcc_command(name, _build.lib_path(name))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any("fast_math" in c or "fast-math" in c for c in cmd)
        assert cmd[-1].endswith(f"{name}.cu")
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.lib_path(name).parent == _build.BUILD_DIR


def test_library_is_built_and_loaded_once_across_threads(monkeypatch,
                                                         tmp_path):
    """Eight threads that first use one library at once (a serving
    flusher beside a refresh thread) build it once and share one
    loaded library; every thread joins in bounded time."""
    import threading
    import time

    builds, loads = [], []

    def fake_build(names):
        builds.append(tuple(names))
        time.sleep(0.05)                 # widen the race window
        for name in names:
            _build.lib_path(name).write_bytes(b"")

    def fake_cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "lib_path",
                        lambda name: tmp_path / f"{name}.so")
    barrier = threading.Barrier(8)
    got = []

    def first_use():
        barrier.wait(timeout=30)
        got.append(_build.load("label_merge"))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert builds == [("label_merge",)]
    assert len(loads) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)


def test_build_names_temporaries_by_process_and_thread(monkeypatch,
                                                       tmp_path):
    """Each nvcc of ``build`` writes a temporary file named by the pid
    and the thread id, so two threads of one process never share one."""
    import os
    import threading

    outs = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            outs.append(cmd[cmd.index("-o") + 1])
            open(outs[-1], "wb").close()

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "lib_path",
                        lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    _build.build(("label_merge",))
    assert outs[0].endswith(
        f".tmp{os.getpid()}-{threading.get_ident()}.so")
    assert (tmp_path / "label_merge.so").exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(3, 13), (2, 160), (2, 161), (1, 300)])
def test_fw_kernel_matches_plain_on_card(cuda_device, b, n):
    d = torch.from_numpy(_fw_input(b, n, np.random.default_rng(n),
                                   all_inf=(b - 1,))).to(cuda_device)
    got = ops.fw_batch_next(d)
    want = ops.fw_batch_next(d, force="ref")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,kind", [(1, 1, "ragged"), (2, 64, "ties"),
                                      (3, 65, "ragged"), (2, 161, "ties"),
                                      (4, 200, "ragged"), (1, 517, "ties"),
                                      (130, 96, "ties")])
def test_fw_blocked_kernel_matches_plain_on_card(cuda_device, b, n, kind):
    """The blocked witness FW, dist and nxt array-equal to the serial
    plain version: ragged n, tie-heavy values from {0, 1, 2} with 60%
    +inf, an all-+inf batch entry."""
    rng = np.random.default_rng(b * 7 + n)
    if kind == "ties":
        d = _int_inf((b, n, n), rng, inf_frac=0.6, hi=3)
    else:
        d = _int_inf((b, n, n), rng)
    d[b - 1] = np.inf
    d = torch.from_numpy(d).to(cuda_device)
    before = floyd_warshall.fw_next_blocked_cuda.launches
    got = floyd_warshall.fw_next_blocked_cuda(d)
    assert floyd_warshall.fw_next_blocked_cuda.launches == before + 1
    for g, w in zip(got, ops.fw_batch_next(d, force="ref")):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("q,k1,k2", [(5, 7, 3), (37, 130, 201),
                                     (16, 480, 480)])
def test_twoside_kernel_matches_plain_on_card(cuda_device, q, k1, k2):
    rng = np.random.default_rng(q + k1 + k2)
    args = [torch.from_numpy(_int_inf(s, rng)).to(cuda_device)
            for s in ((q, k1), (k1, k2), (q, k2))]
    assert torch.equal(ops.minplus_twoside(*args),
                       ops.minplus_twoside(*args, force="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 128), (3, 100), (2, 240), (4, 241),
                                 (1, 496)])
def test_fw_batch_kernel_matches_plain_on_card(cuda_device, b, n):
    d = torch.from_numpy(_fw_input(b, n, np.random.default_rng(n),
                                   all_inf=(b - 1,))).to(cuda_device)
    assert torch.equal(ops.fw_batch(d), ops.fw_batch(d, force="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 1712, 1712), (33, 77, 129),
                                   (128, 128, 1792), (100, 37, 250)])
def test_minplus_kernels_match_plain_on_card(cuda_device, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b, c = (torch.from_numpy(_int_inf(s, rng)).to(cuda_device)
               for s in ((m, k), (k, n), (m, n)))
    assert torch.equal(ops.minplus(a, b), ops.minplus(a, b, force="ref"))
    assert torch.equal(ops.minplus_accum(c, a, b),
                       ops.minplus_accum(c, a, b, force="ref"))
    if m == k:                         # phase 2's aliasing: C_in is B
        assert torch.equal(ops.minplus_accum(b, a, b),
                           ops.minplus_accum(b, a, b, force="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,block", [(100, 32), (300, 128)])
def test_fw_apsp_kernels_match_plain_on_card(cuda_device, n, block):
    d = torch.from_numpy(_int_inf((n, n), np.random.default_rng(n),
                                  inf_frac=0.9)).to(cuda_device)
    assert torch.equal(ops.fw_apsp(d, block=block),
                       ops.fw_apsp(d, force="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("q,k1,k2,kind", ARGMIN_CASES + [
    (1024, 480, 480, "ragged"), (64, 1712, 1712, "ties"),
    (16, 1000, 1000, "ties"), (3, 2000, 50, "inf"), (1, 300, 4614, "ties"),
    (1024, 480, 480, "large_ties"), (16, 1712, 1712, "large_ties")])
def test_twoside_argmin_kernel_matches_plain_on_card(cuda_device, q, k1, k2,
                                                     kind):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in _argmin_input(q, k1, k2, kind)]
    got = ops.minplus_twoside_argmin(*args)
    assert [g.dtype for g in got] == [torch.float32, torch.int32,
                                      torch.int32]
    for g, w in zip(got, ops.minplus_twoside_argmin(*args, force="ref")):
        assert torch.equal(g, w)
    if kind == "large_ties":
        assert [g[0].item() for g in got] == [2**24 - 1, 0, k2 - 1]


@pytest.mark.cuda
@pytest.mark.parametrize("q,w", [(37, 300), (1024, 1712), (5, 3), (8, 7)])
def test_label_merge_kernel_matches_plain_on_card(cuda_device, q, w):
    rng = np.random.default_rng(q + w)
    labs, labt = (torch.from_numpy(_int_inf((q, w), rng)).to(cuda_device)
                  for _ in range(2))
    labs[0] = float("inf")
    assert torch.equal(ops.label_merge(labs, labt),
                       ops.label_merge(labs, labt, force="ref"))
