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

from repro_torch.kernels import _build, floyd_warshall, minplus_twoside
from repro_torch.kernels import ops, ref

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
    with pytest.raises(ValueError, match="force"):
        ops.use_kernel("cpu", "pallas")


def test_cpu_dispatch_runs_plain_versions_and_counts_nothing():
    """A CPU tensor takes the plain version and launches no kernel;
    the kernel wrappers refuse CPU tensors outright."""
    before = (floyd_warshall.fw_next_smem_cuda.launches,
              floyd_warshall.fw_next_global_cuda.launches,
              minplus_twoside.minplus_twoside_cuda.launches)
    rng = np.random.default_rng(3)
    d = torch.from_numpy(_fw_input(2, 9, rng))
    for g, w in zip(ops.fw_batch_next(d), ref.fw_batch_next_ref(d)):
        assert torch.equal(g, w)
    assert not ops.use_kernel("cpu") and not ops.use_kernel("cpu", "ref")
    with pytest.raises(ValueError, match="CUDA"):
        floyd_warshall.fw_batch_next_cuda(d)
    with pytest.raises(ValueError, match="CUDA"):
        minplus_twoside.minplus_twoside_cuda(d[0], d[0], d[0])
    after = (floyd_warshall.fw_next_smem_cuda.launches,
             floyd_warshall.fw_next_global_cuda.launches,
             minplus_twoside.minplus_twoside_cuda.launches)
    assert after == before


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
@pytest.mark.parametrize("q,k1,k2", [(5, 7, 3), (37, 130, 201),
                                     (16, 480, 480)])
def test_twoside_kernel_matches_plain_on_card(cuda_device, q, k1, k2):
    rng = np.random.default_rng(q + k1 + k2)
    args = [torch.from_numpy(_int_inf(s, rng)).to(cuda_device)
            for s in ((q, k1), (k1, k2), (q, k2))]
    assert torch.equal(ops.minplus_twoside(*args),
                       ops.minplus_twoside(*args, force="ref"))
