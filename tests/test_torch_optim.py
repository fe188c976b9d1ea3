"""The port's optimizer and quantizer against the reference package.

The optimizer cases of ``tests/test_substrate.py`` run on the port
(convergence on a quadratic, ``serialize`` changes nothing, ``grad_scale``
== a pre-scaled gradient, the cosine schedule's shape, the int8 error
bound).  ``adamw_update`` is held to the reference's on identical
parameters, gradients and states, apart from any train step: equal to 1
ulp (float32 and bfloat16 parameters, float32 and bfloat16 moments,
clipped and unclipped gradients, a first and a later step), and its
in-place (``donate=True``) form is bit-equal to the functional one.
``global_norm_clip``, ``cosine_schedule``, ``quantize_int8`` and
``dequantize_int8`` equal the reference's; ``compressed_psum`` over the
shards of a CPU mesh axis follows the reference's steps (max scale,
int8 clip, int32 sum, / n) and stays within its error bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch import convert
from repro_torch.checkpoint.manager import tree_leaves, tree_map
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               compressed_psum, cosine_schedule,
                               dequantize_int8, global_norm_clip,
                               quantize_int8)

torch.set_num_threads(1)


# ---- the reference's cases, on the port -------------------------------------
def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params)
    for _ in range(300):
        g = {"w": 2.0 * (params["w"] - 1.0)}
        params, opt, _ = adamw_update(params, g, opt, lr=5e-2,
                                      weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), np.ones(3), atol=1e-2)


def test_adamw_serialize_matches_parallel():
    params = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    grads = {"a": torch.ones(2, 3) * 0.1, "b": -torch.ones(4) * 0.2}
    p1, s1, _ = adamw_update(params, grads, adamw_init(params), lr=1e-2,
                             serialize=False)
    p2, s2, _ = adamw_update(params, grads, adamw_init(params), lr=1e-2,
                             serialize=True)
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        assert torch.equal(a, b)


def test_grad_scale_equals_prescaled():
    params = {"w": torch.tensor([1.0, 2.0])}
    grads = {"w": torch.tensor([8.0, -4.0])}
    p1, _, m1 = adamw_update(params, grads, adamw_init(params), lr=1e-2,
                             grad_scale=0.25)
    pre = {"w": grads["w"] * 0.25}
    p2, _, m2 = adamw_update(params, pre, adamw_init(params), lr=1e-2)
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-6)


def test_cosine_schedule_shape():
    f = cosine_schedule(1.0, warmup=10, total=100)
    assert float(f(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(f(torch.tensor(10, dtype=torch.int32))) - 1.0) < 1e-6
    assert float(f(torch.tensor(100, dtype=torch.int32))) < 1e-6


@given(st.integers(0, 10_000))
@settings(max_examples=20)
def test_int8_quantization_error_bound(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32) * 10)
    q, scale = quantize_int8(x)
    back = dequantize_int8(q, scale)
    max_err = float(torch.max(torch.abs(back - x)))
    assert max_err <= float(scale) * 0.5 + 1e-6


# ---- parity with the reference ----------------------------------------------
def _tree(rng, dtype_p, dtype_s, step, grad_mul):
    """(params, grads, state) as numpy trees; bf16 leaves as their bits
    of float32 values rounded by JAX."""
    def arr(shape, dt, scale=1.0):
        x = (rng.normal(size=shape) * scale).astype(np.float32)
        return np.array(jnp.asarray(x, dt))
    shapes = {"w": (7, 5), "layers": {"a": (3, 4, 2), "b": (6,)},
              "z": (9,)}
    params = jax.tree_util.tree_map(lambda s: arr(s, dtype_p), shapes,
                                    is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree_util.tree_map(lambda s: arr(s, dtype_p, grad_mul),
                                   shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
    grads["z"][:4] = 0.0                        # exact zeros in a leaf
    if step == 0:
        m = jax.tree_util.tree_map(lambda s: np.zeros(s, dtype_s), shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
        v = jax.tree_util.tree_map(lambda s: np.zeros(s, dtype_s), shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
    else:
        m = jax.tree_util.tree_map(lambda s: arr(s, dtype_s, 0.1), shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
        v = jax.tree_util.tree_map(
            lambda s: np.abs(arr(s, dtype_s, 0.01)), shapes,
            is_leaf=lambda x: isinstance(x, tuple))
    return params, grads, (m, v, np.int32(step))


def _ulps_equal(a, b, maxulp=1):
    """a, b: numpy arrays (bf16 as |V2 bits or ml_dtypes); within maxulp
    units in the last place of their own dtype."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.itemsize == 2:                   # bf16 bits
        ia = a.view(np.int16).astype(np.int32)
        ib = b.view(np.int16).astype(np.int32)
        # sign-magnitude to a monotone integer line
        ia = np.where(ia < 0, -32768 - ia, ia)
        ib = np.where(ib < 0, -32768 - ib, ib)
        assert np.max(np.abs(ia - ib)) <= maxulp, np.max(np.abs(ia - ib))
    else:
        np.testing.assert_array_max_ulp(a, b, maxulp=maxulp)


@pytest.mark.parametrize("dtype_p,dtype_s", [
    (jnp.float32, jnp.float32), (jnp.bfloat16, jnp.float32),
    (jnp.float32, jnp.bfloat16)], ids=["f32", "bf16_params", "bf16_state"])
@pytest.mark.parametrize("step", [0, 4], ids=["first", "later"])
@pytest.mark.parametrize("grad_mul", [0.01, 10.0], ids=["unclipped",
                                                        "clipped"])
def test_adamw_update_matches_reference_to_one_ulp(dtype_p, dtype_s, step,
                                                   grad_mul):
    rng = np.random.default_rng(step * 7 + int(grad_mul))
    p, g, (m, v, s) = _tree(rng, dtype_p, dtype_s, step, grad_mul)
    jp, jst, jmet = jadamw.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, p),
        jax.tree_util.tree_map(jnp.asarray, g),
        jadamw.AdamWState(jax.tree_util.tree_map(jnp.asarray, m),
                          jax.tree_util.tree_map(jnp.asarray, v),
                          jnp.asarray(s)), lr=3e-4, grad_scale=0.5)
    tp, tst, tmet = adamw_update(
        convert.tree_from_numpy(p, "cpu"), convert.tree_from_numpy(g, "cpu"),
        AdamWState(convert.tree_from_numpy(m, "cpu"),
                   convert.tree_from_numpy(v, "cpu"),
                   torch.tensor(s)), lr=3e-4, grad_scale=0.5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    clipped = float(jmet["grad_norm"]) > 1.0
    assert clipped == (grad_mul > 1.0)
    want = jax.tree_util.tree_leaves((jp, jst.m, jst.v))
    got = tree_leaves(convert.tree_to_numpy((tp, tst.m, tst.v)))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        _ulps_equal(np.asarray(a), b)
    assert int(tst.step) == int(jst.step) == step + 1


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_adamw_donate_is_bit_equal_to_functional(state_dtype):
    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, 3, generator=gen),
              "b": torch.randn(4, generator=gen).to(torch.bfloat16)}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen
                                           ).to(p.dtype) * 3, params)
    opt = adamw_init(params, state_dtype)
    for _ in range(3):
        p_new, o_new, _ = adamw_update(params, grads, opt, lr=1e-2)
        keep = [t.clone() for t in tree_leaves((params, opt))]
        p_don, o_don, _ = adamw_update(params, grads, opt, lr=1e-2,
                                       donate=True)
        for a, b in zip(tree_leaves((p_new, o_new)),
                        tree_leaves((p_don, o_don))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        # donated: the inputs now hold the result, the functional call
        # left them as they were
        assert all(x is y for x, y in zip(tree_leaves((p_don, o_don)),
                                          tree_leaves((params, opt))))
        assert not all(torch.equal(a, b) for a, b in
                       zip(keep, tree_leaves((params, opt))))
        params, opt = p_don, o_don


def test_global_norm_clip_and_schedule_match_reference():
    rng = np.random.default_rng(5)
    g = {"a": rng.normal(size=(4, 3)).astype(np.float32) * 3,
         "b": rng.normal(size=(5,)).astype(np.float32)}
    jg, jn = jadamw.global_norm_clip(jax.tree_util.tree_map(jnp.asarray, g),
                                     1.0)
    tg, tn = global_norm_clip(convert.tree_from_numpy(g, "cpu"), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tree_leaves(tg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    jf = jadamw.cosine_schedule(3e-4, warmup=10, total=100)
    tf = cosine_schedule(3e-4, warmup=10, total=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(tf(torch.tensor(s, dtype=torch.int32))),
            float(jf(jnp.int32(s))), rtol=1e-6, atol=1e-12)


def test_schedule_as_lr_matches_reference():
    rng = np.random.default_rng(6)
    p = {"w": rng.normal(size=(8,)).astype(np.float32)}
    g = {"w": rng.normal(size=(8,)).astype(np.float32) * 0.1}
    jp, _, jm = jadamw.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, p),
        jax.tree_util.tree_map(jnp.asarray, g),
        jadamw.adamw_init(jax.tree_util.tree_map(jnp.asarray, p)),
        lr=jadamw.cosine_schedule(1e-2, 4, 20))
    tp, _, tm = adamw_update(convert.tree_from_numpy(p, "cpu"),
                             convert.tree_from_numpy(g, "cpu"),
                             adamw_init(convert.tree_from_numpy(p, "cpu")),
                             lr=cosine_schedule(1e-2, 4, 20))
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    _ulps_equal(np.asarray(jp["w"]), tp["w"].numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_reference(seed):
    x = (np.random.default_rng(seed).normal(size=(257,)) * 10
         ).astype(np.float32)
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    tq, ts = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        dequantize_int8(tq, ts).numpy(),
        np.asarray(jcompress.dequantize_int8(jq, js)))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_psum_over_a_mesh_axis(n):
    mesh = make_host_mesh((n,), ("data",), device="cpu")
    rng = np.random.default_rng(n)
    xs = [rng.normal(size=(33,)).astype(np.float32) * (i + 1)
          for i in range(n)]
    shards = [torch.from_numpy(x).to(d)
              for x, d in zip(xs, mesh.shard_devices(("data",)))]
    out = compressed_psum(shards)
    # the reference's steps in numpy: max scale, int8 clip, int32 sum, / n
    smax = np.float32(max(np.max(np.abs(x)) / np.float32(127.0)
                          + np.float32(1e-12) for x in xs))
    q = [np.clip(np.round(x / smax), -127, 127).astype(np.int8) for x in xs]
    total = np.sum([qi.astype(np.int32) for qi in q], axis=0)
    want = total.astype(np.float32) * smax / np.float32(n)
    for o in out:
        np.testing.assert_array_equal(o.numpy(), want)
    mean = np.mean(xs, axis=0)
    assert np.max(np.abs(out[0].numpy() - mean)) <= smax * 0.5 + 1e-6
    if n == 1:                 # one replica: the reference's own result
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.compat import shard_map
        jmesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        f = shard_map(lambda x: jcompress.compressed_psum(x, "data"),
                      mesh=jmesh, in_specs=P(), out_specs=P())
        np.testing.assert_array_equal(out[0].numpy(),
                                      np.asarray(f(jnp.asarray(xs[0]))))
