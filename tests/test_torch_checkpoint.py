"""The port's checkpoints and fault runtime against the reference package.

The checkpoint and runtime cases of ``tests/test_substrate.py`` run on
the port (round trip, retention and atomicity; a structure mismatch
raises; the straggler monitor; the failure injector; the elastic
trainer's recovery, here halving a 4-device CPU mesh).  Checkpoints
interchange: one the reference writes (float32, int32 and bfloat16
leaves, an ``AdamWState``) restores in the port bit for bit (bf16
compared through its uint16 view); for the same tree the port's npz
entries hold the same array data bytes as the reference's (a bf16
entry's ``.npy`` header may name its dtype differently); a float32
checkpoint the port writes restores in the reference.  The port's leaf
order is ``jax.tree_util``'s, and ``convert.tree_from_numpy`` refuses a
wrong dtype or shape.
"""
import gc
import os
import weakref
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.optim import adamw_init as jadamw_init
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import (read_npz, tree_flatten,
                                            tree_leaves, tree_map,
                                            tree_unflatten)
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime import (ElasticTrainer, FailureInjector,
                                 StragglerMonitor)
from repro_torch.runtime.fault import SimulatedNodeFailure, device_count

torch.set_num_threads(1)


# ---- the reference's cases, on the port -------------------------------------
def test_checkpoint_roundtrip_retention_atomicity(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(10.0), "opt": {"m": torch.ones((3, 3))}}
    for step in [5, 10, 15]:
        ck.save(step, tree_map(lambda x: x * step, state))
    assert ck.all_steps() == [10, 15]   # retention
    step, got = ck.restore(state)
    assert step == 15
    np.testing.assert_allclose(got["w"].numpy(), np.arange(10.0) * 15)
    # stale tmp dirs are GC'd on next save
    os.makedirs(str(tmp_path / "step_000000099.tmp-123"), exist_ok=True)
    ck.save(20, state)
    assert not any(".tmp" in n for n in os.listdir(tmp_path))


def test_checkpoint_structure_mismatch_raises(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, {"a": torch.ones(3)})
    with pytest.raises(ValueError):
        ck.restore({"a": torch.ones(3), "b": torch.ones(2)})


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(factor=3.0)
    for _ in range(20):
        mon.observe(0.1)
    assert mon.observe(1.0) is True
    assert mon.observe(0.1) is False
    assert mon.summary()["stragglers"] == 1


def test_failure_injector_fires_once():
    inj = FailureInjector(fail_at_step=3)
    inj.check(2)
    with pytest.raises(SimulatedNodeFailure):
        inj.check(3)
    inj.check(3)  # second time: already failed, no raise


@pytest.mark.parametrize("cpu_devices,after", [(1, 1), (4, 2)])
def test_elastic_trainer_recovers_from_failure(tmp_path, cpu_devices,
                                               after):
    """Full restart path: fail at step 7, restore from step 5, finish on
    half the devices."""
    ck = CheckpointManager(str(tmp_path), keep=3)
    meshes = []

    def make_mesh(n):
        meshes.append(n)
        return None

    def make_step(mesh):
        def step(state, batch):
            return {"x": state["x"] + batch}
        return step, None

    def init_state(mesh):
        return {"x": torch.zeros(())}

    def batches():
        while True:
            yield torch.ones(())

    tr = ElasticTrainer(ckpt=ck, make_mesh=make_mesh,
                        make_step=make_step, init_state=init_state,
                        checkpoint_every=5, device="cpu",
                        cpu_devices=cpu_devices)
    inj = FailureInjector(fail_at_step=7)
    out = tr.run(12, batches(), injector=inj)
    assert out["restarts"] == 1
    assert out["final_step"] == 12
    assert out["devices"] == after and meshes == [cpu_devices, after]
    _, state = ck.restore({"x": torch.zeros(())})
    assert float(state["x"]) == 12.0


def test_device_count_refuses_cuda_without_a_card():
    assert device_count("cpu", 3) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device_count("cuda")


# ---- leaf order and conversion ----------------------------------------------
def _nested(mk):
    return {"z": mk((2,)), "a": [mk((3,)), (mk((1, 2)), mk(()))],
            "m": {"y": mk((4,)), "b": mk((2, 2))}, "n": None}


def test_leaf_order_is_jax_tree_util_order():
    counter = iter(range(100))
    tree_np = _nested(lambda s: np.full(s, next(counter), np.float32))
    want = [float(np.asarray(x).ravel()[0]) if np.asarray(x).size else None
            for x in jax.tree_util.tree_leaves(tree_np)]
    leaves, treedef = tree_flatten(tree_np)
    assert [float(x.ravel()[0]) if x.size else None
            for x in leaves] == want
    back = tree_unflatten(treedef, leaves)
    assert back["n"] is None and back["a"][1][1] is leaves[
        want.index(float(np.asarray(tree_np["a"][1][1])))]
    state = adamw_init({"w": torch.ones(2), "b": torch.ones(3)})
    jstate = jadamw_init({"w": jnp.ones(2), "b": jnp.ones(3)})
    assert [tuple(x.shape) for x in tree_leaves(state)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jstate)]
    with pytest.raises(ValueError):
        tree_unflatten(treedef, leaves + [np.zeros(1)])


def test_tree_helpers_hold_no_leaf_after_return():
    """No reference cycle: with the cyclic collector off, a leaf goes as
    soon as the caller drops it."""
    gc.collect()
    gc.disable()
    try:
        t = torch.ones(3)
        alive = weakref.ref(t)
        leaves, treedef = tree_flatten({"a": [t, (t,)], "s": AdamWState(
            t, t, t)})
        tree_unflatten(treedef, leaves)
        tree_map(lambda x: x + 1, {"a": t})
        del leaves, treedef, t
        assert alive() is None
    finally:
        gc.enable()


def test_tree_from_numpy_refuses_wrong_dtype_or_shape():
    like = {"w": torch.zeros(2, 3), "b": torch.zeros(4, dtype=torch.bfloat16)}
    good = convert.tree_to_numpy(like)
    convert.tree_from_numpy(good, "cpu", like=like)
    with pytest.raises(TypeError):
        convert.tree_from_numpy({"w": np.zeros((2, 3)), "b": good["b"]},
                                "cpu")                   # float64
    with pytest.raises(TypeError):
        convert.tree_from_numpy({"w": np.zeros((3, 2), np.float32),
                                 "b": good["b"]}, "cpu", like=like)
    with pytest.raises(TypeError):
        convert.tree_from_numpy({"w": good["w"],
                                 "b": np.zeros(4, np.float32)}, "cpu",
                                like=like)
    with pytest.raises(ValueError):
        convert.tree_from_numpy({"w": good["w"]}, "cpu", like=like)


# ---- interchange with the reference -----------------------------------------
def _jax_state():
    rng = np.random.default_rng(11)
    params = {
        "w": jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32)),
        "emb": jnp.asarray(rng.normal(size=(7, 4)).astype(np.float32),
                           jnp.bfloat16),
        "ids": jnp.asarray(rng.integers(-50, 50, (6,)).astype(np.int32)),
        "layers": {"norm": jnp.asarray(rng.normal(size=(2, 4)),
                                       jnp.bfloat16),
                   "s": jnp.float32(rng.normal())},
    }
    float_params = {k: v for k, v in params.items() if k != "ids"}
    opt = jadamw_init(float_params)
    opt = type(opt)(jax.tree_util.tree_map(lambda x: x + 0.25, opt.m),
                    jax.tree_util.tree_map(lambda x: x + 0.5, opt.v),
                    jnp.int32(7))
    return params, opt


def _to_port(params, opt):
    """The reference's (params, AdamWState) as the port's, on the CPU."""
    as_np = jax.tree_util.tree_map(np.asarray, (params, opt.m, opt.v))
    p, m, v = (convert.tree_from_numpy(t, "cpu") for t in as_np)
    return p, AdamWState(m, v, torch.tensor(int(opt.step),
                                            dtype=torch.int32))


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    params, opt = _jax_state()
    JCheckpointManager(str(tmp_path)).save(7, (params, opt))
    like = tree_map(torch.zeros_like, _to_port(params, opt))
    step, got = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 7 and isinstance(got[1], AdamWState)
    want = jax.tree_util.tree_leaves((params, opt))
    mine = tree_leaves(got)
    assert len(want) == len(mine)
    for a, b in zip(want, mine):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape
        if b.dtype == torch.bfloat16:
            assert a.dtype.name == "bfloat16"
            np.testing.assert_array_equal(
                b.view(torch.int16).numpy().view(np.uint16), _bits(a))
        else:
            assert str(b.numpy().dtype) == str(a.dtype)
            np.testing.assert_array_equal(b.numpy(), a)


def _npy_members(path):
    """{name: (header dtype string, data bytes)} of an npz file."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                version = np.lib.format.read_magic(f)
                hdr = (np.lib.format.read_array_header_1_0 if version ==
                       (1, 0) else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = hdr(f)
                out[name] = (dtype.str, shape, fortran, f.read())
    return out


def test_port_npz_entries_hold_the_reference_bytes(tmp_path):
    params, opt = _jax_state()
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    JCheckpointManager(str(ref_dir)).save(3, (params, opt))
    mine = _to_port(params, opt)
    CheckpointManager(str(port_dir)).save(3, mine)
    ref = _npy_members(ref_dir / "step_000000003" / "shard_000.npz")
    port = _npy_members(port_dir / "step_000000003" / "shard_000.npz")
    assert sorted(ref) == sorted(port)
    n_bf16 = 0
    for name in ref:
        rdt, rshape, rf, rdata = ref[name]
        pdt, pshape, pf, pdata = port[name]
        assert (rshape, rf, rdata) == (pshape, pf, pdata), name
        if rdt != pdt:                     # only a bf16 entry's name
            assert {rdt, pdt} <= {"|V2", "<V2"}, (rdt, pdt)
        n_bf16 += rdt in ("|V2", "<V2")
    assert n_bf16 == 2         # emb and norm (the moments are float32)
    rman = (ref_dir / "step_000000003" / "manifest.json").read_text()
    pman = (port_dir / "step_000000003" / "manifest.json").read_text()
    import json
    rman, pman = json.loads(rman), json.loads(pman)
    for key in ("step", "n_leaves", "dtypes", "shapes"):
        assert rman[key] == pman[key], key


def test_port_float32_checkpoint_restores_in_the_reference(tmp_path):
    rng = np.random.default_rng(12)
    p = {"w": rng.normal(size=(4, 3)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    state = (convert.tree_from_numpy(p, "cpu"),
             adamw_init(convert.tree_from_numpy(p, "cpu")))
    CheckpointManager(str(tmp_path)).save(2, state)
    jlike = (jax.tree_util.tree_map(jnp.zeros_like, p),
             jadamw_init(jax.tree_util.tree_map(jnp.asarray, p)))
    step, got = JCheckpointManager(str(tmp_path)).restore(jlike)
    assert step == 2
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bf16_checkpoint_round_trip_in_the_port(tmp_path):
    gen = torch.Generator().manual_seed(4)
    params = {"e": torch.randn(9, 5, generator=gen).to(torch.bfloat16),
              "w": torch.randn(3, generator=gen)}
    state = (params, adamw_init(params, torch.bfloat16))
    ck = CheckpointManager(str(tmp_path), chunk_leaves=2)   # 4 shards
    ck.save(1, state)
    assert len([n for n in os.listdir(tmp_path / "step_000000001")
                if n.startswith("shard_")]) == 4
    _, got = ck.restore(tree_map(torch.zeros_like, state))
    _, on_dev = ck.restore(state, device="cpu")     # device= over like's
    assert all(t.device.type == "cpu" for t in tree_leaves(on_dev))
    for a, b in zip(tree_leaves(state), tree_leaves(got)):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)


def test_read_npz_equals_np_load(tmp_path):
    path = str(tmp_path / "x.npz")
    arrs = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "f": np.asfortranarray(np.arange(6, dtype=np.int32
                                             ).reshape(2, 3)),
            "s": np.float32(3.5), "e": np.zeros((0, 2), np.float32)}
    np.savez(path, **arrs)
    got = dict(read_npz(path))
    with np.load(path) as z:
        for k in z.files:
            np.testing.assert_array_equal(got[k], z[k])
            assert got[k].dtype == z[k].dtype
    cpath = str(tmp_path / "c.npz")
    np.savez_compressed(cpath, **arrs)          # not a checkpoint shard
    with pytest.raises(ValueError, match="compressed"):
        dict(read_npz(cpath))
