"""The port's sharded GNN forwards against the dense ones and the
reference's, on the CPU.

The reference's two cases (``tests/test_multidevice.py``: graphcast
with owner-computes edges, dimenet with partition-local triplets) run on
the port over the CPU meshes (4, 2), (8,) and (1, 1): the port's
sharded loss and gradients equal the port's dense ones, the reference's
dense loss and gradients (in process) and the reference's sharded loss
and gradients (``shard_map`` over 8 forced host devices, in a
subprocess, as that file runs it), at loss rtol 1e-4 and gradient rtol
1e-4.  A mesh of two distinct devices (``cpu`` and ``cpu:0``, shards
interleaved) runs the one-group-per-device path with more than one
group.  The per-layer halo gather moves n x d x itemsize bytes a
device, logged by ``launch.mesh.record_collectives``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gnn as jgnn
from repro.models.common import Shardings as JShardings
from repro_torch import convert
from repro_torch.checkpoint.manager import tree_leaves, tree_map
from repro_torch.launch.mesh import Mesh, make_host_mesh, record_collectives
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import gnn
from repro_torch.models.common import Shardings

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
MESHES = {"4x2": ((4, 2), ("data", "model")), "8": ((8,), ("d",)),
          "1x1": ((1, 1), ("data", "model"))}
ARCHS = ("graphcast", "dimenet")
N = 64


def _cfg(arch, **kw):
    if arch == "graphcast":
        base = gnn.GNNConfig(name="gc", arch="graphcast", n_layers=2,
                             d_hidden=8, d_feat=8, n_out=2)
    else:
        base = gnn.GNNConfig(name="dn", arch="dimenet", n_layers=2,
                             d_hidden=8, d_feat=6)
    return dataclasses.replace(base, **{"sharded": True, **kw})


def _jcfg(arch):
    c = _cfg(arch)
    return jgnn.GNNConfig(**{f.name: getattr(c, f.name)
                             for f in dataclasses.fields(c)
                             if f.name != "dtype"})


def _batches(arch: str, n_shards: int) -> tuple:
    """(owner layout, dense layout) numpy batches of the reference's
    cases for ``n_shards`` shards: shard i owns nodes [i*N/P, (i+1)*N/P)
    and their incoming edges; dst shard-local, src global; dimenet's
    triplets within a shard."""
    rng = np.random.default_rng(3 if arch == "graphcast" else 5)
    d = 8 if arch == "graphcast" else 6
    npp = N // n_shards
    e_per = (96 if arch == "graphcast" else 64) // n_shards
    src, dst_l, dst_g = [], [], []
    for shard in range(n_shards):
        for _ in range(e_per):
            dst = shard * npp + rng.integers(0, npp)
            src.append(rng.integers(0, N))
            dst_g.append(dst)
            dst_l.append(dst - shard * npp)
    i32 = np.int32
    base = {"node_feat": rng.normal(size=(N, d)).astype(np.float32),
            "edge_src": np.array(src, i32)}
    if arch == "graphcast":
        base.update(
            edge_feat=rng.normal(size=(len(src), 4)).astype(np.float32),
            target=rng.normal(size=(N, 2)).astype(np.float32),
            loss_mask=(np.arange(N) % 5 != 0).astype(np.float32))
        return (dict(base, edge_dst=np.array(dst_l, i32)),
                dict(base, edge_dst=np.array(dst_g, i32)))
    kj_l, ji_l, kj_g, ji_g, ang = [], [], [], [], []
    for shard in range(n_shards):
        for _ in range(2 * e_per):
            a, b = rng.integers(0, e_per), rng.integers(0, e_per)
            kj_l.append(a)
            ji_l.append(b)
            kj_g.append(shard * e_per + a)
            ji_g.append(shard * e_per + b)
            ang.append(rng.uniform(0, np.pi))
    base.update(
        edge_dist=rng.uniform(0.5, 3, len(src)).astype(np.float32),
        tri_angle=np.array(ang, np.float32),
        graph_id=(np.arange(N) // 16).astype(i32),
        target_g=rng.normal(size=(4,)).astype(np.float32))
    return (dict(base, edge_dst=np.array(dst_l, i32),
                 tri_edge_kj=np.array(kj_l, i32),
                 tri_edge_ji=np.array(ji_l, i32)),
            dict(base, edge_dst=np.array(dst_g, i32),
                 tri_edge_kj=np.array(kj_g, i32),
                 tri_edge_ji=np.array(ji_g, i32)))


def _jparams(arch):
    return jgnn.init_params(_jcfg(arch), jax.random.PRNGKey(7))


def _port_params(arch):
    return convert.tree_from_numpy(
        jax.tree_util.tree_map(np.asarray, _jparams(arch)), "cpu")


def _t(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _port_mesh(name: str) -> Mesh:
    shape, axes = MESHES[name]
    return make_host_mesh(shape, axes, device="cpu")


def _port_run(arch, mesh, batch, sharded=True):
    cfg = _cfg(arch, sharded=sharded)
    sh = Shardings(mesh if sharded else None)
    return value_and_grad(lambda p, b: gnn.forward_loss(cfg, sh, p, b),
                          _port_params(arch), _t(batch))


def _assert_grads(got, want):
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * 1e-2 * scale)


# ---- the reference's sharded forwards, in a subprocess ------------------------
_JAX_SHARDED = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, %(src)r)
import dataclasses, jax, numpy as np
import jax.numpy as jnp
from repro.compat import make_mesh
from repro.models import gnn
from repro.models.common import Shardings
data = np.load(%(inp)r)
out = {}
for case in %(cases)r:
    arch, mname = case.split("/")
    shape, axes = %(meshes)r[mname]
    cfg = gnn.GNNConfig(**%(cfgs)r[arch])
    cfg = dataclasses.replace(cfg, sharded=True)
    params = gnn.init_params(cfg, jax.random.PRNGKey(7))
    batch = {k.split("/")[2]: jnp.asarray(data[k]) for k in data.files
             if k.startswith(case + "/")}
    sh = Shardings(mesh=make_mesh(shape, axes))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: gnn.forward_loss(cfg, sh, p, batch)))(params)
    out[case + "/loss"] = np.asarray(loss)
    for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
        out[case + "/g%%03d" %% i] = np.asarray(g)
np.savez(%(outp)r, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The reference's sharded losses and gradients of every case."""
    tmp = tmp_path_factory.mktemp("jax_sharded")
    cases, arrays = [], {}
    for arch in ARCHS:
        for name, (shape, _) in MESHES.items():
            case = f"{arch}/{name}"
            cases.append(case)
            owner, _ = _batches(arch, int(np.prod(shape)))
            arrays.update({f"{case}/{k}": v for k, v in owner.items()})
    np.savez(tmp / "in.npz", **arrays)
    cfgs = {}
    for arch in ARCHS:
        j = _jcfg(arch)
        cfgs[arch] = {f.name: getattr(j, f.name)
                      for f in dataclasses.fields(j)
                      if f.name not in ("dtype", "sharded")}
    prog = textwrap.dedent(_JAX_SHARDED % {
        "src": os.path.join(ROOT, "src"), "inp": str(tmp / "in.npz"),
        "outp": str(tmp / "out.npz"), "cases": cases, "meshes": MESHES,
        "cfgs": cfgs})
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(tmp / "out.npz"))


# ---- the tests ---------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_matches_port_dense(arch, mesh):
    m = _port_mesh(mesh)
    owner, dense = _batches(arch, m.size)
    ls, gs = _port_run(arch, m, owner)
    ld, gd = _port_run(arch, None, dense, sharded=False)
    np.testing.assert_allclose(float(ls), float(ld), rtol=LOSS_RTOL)
    _assert_grads(tree_leaves(gs), [g.numpy() for g in tree_leaves(gd)])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_matches_jax_dense(arch, mesh):
    m = _port_mesh(mesh)
    owner, dense = _batches(arch, m.size)
    cfg = dataclasses.replace(_jcfg(arch), sharded=False)
    lj, gj = jax.value_and_grad(lambda p: jgnn.forward_loss(
        cfg, JShardings(None), p,
        {k: jnp.asarray(v) for k, v in dense.items()}))(_jparams(arch))
    ls, gs = _port_run(arch, m, owner)
    np.testing.assert_allclose(float(ls), float(lj), rtol=LOSS_RTOL)
    _assert_grads(tree_leaves(gs), jax.tree_util.tree_leaves(gj))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_matches_jax_sharded(arch, mesh, jax_sharded):
    m = _port_mesh(mesh)
    owner, _ = _batches(arch, m.size)
    ls, gs = _port_run(arch, m, owner)
    case = f"{arch}/{mesh}"
    np.testing.assert_allclose(float(ls), float(jax_sharded[case + "/loss"]),
                               rtol=LOSS_RTOL)
    want = [jax_sharded[k] for k in sorted(jax_sharded)
            if k.startswith(case + "/g")]
    _assert_grads(tree_leaves(gs), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_on_two_devices_interleaved(arch):
    """Shards 0, 2, .. on ``cpu`` and 1, 3, .. on ``cpu:0``: two groups
    of non-consecutive shards, each run as one batch on its device."""
    cpu, cpu0 = torch.device("cpu"), torch.device("cpu", 0)
    m = Mesh((cpu, cpu0) * 4, (4, 2), ("data", "model"))
    owner, dense = _batches(arch, m.size)
    ls, gs = _port_run(arch, m, owner)
    ld, gd = _port_run(arch, None, dense, sharded=False)
    np.testing.assert_allclose(float(ls), float(ld), rtol=LOSS_RTOL)
    _assert_grads(tree_leaves(gs), [g.numpy() for g in tree_leaves(gd)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_halo_gather_bytes(arch, dtype):
    """Forward only: graphcast gathers the [N, d_hidden] node state once
    a layer, dimenet the [N, d_feat] features once; each gather's
    per-device bytes are N x width x itemsize, and the loss psum one
    part's bytes."""
    m = _port_mesh("4x2")
    cfg = _cfg(arch, dtype=dtype)
    owner, _ = _batches(arch, m.size)
    params = tree_map(lambda w: w.to(dtype), _port_params(arch))
    with torch.no_grad(), record_collectives() as log:
        gnn.forward_loss(cfg, Shardings(m), params, _t(owner))
    item = torch.tensor([], dtype=dtype).element_size()
    if arch == "graphcast":
        want = [("all-gather", N * cfg.d_hidden * item)] * cfg.n_layers
        want.append(("all-reduce", 2 * 4))              # (sse, cnt) f32
    else:
        want = [("all-gather", N * cfg.d_feat * item),
                ("all-reduce", 4 * item)]               # 4 graph energies
    assert log.events == want
    assert log.counts["reduce-scatter"] == 0


def _meta_peak(n_layers: int, sharded: bool) -> int:
    from repro_torch.launch.opanalysis import analyze
    n, d = 8192, 64
    cfg = gnn.GNNConfig(name="gc", arch="graphcast", n_layers=n_layers,
                        d_hidden=d, d_feat=8, n_out=2, sharded=sharded)
    meta = torch.device("meta")
    batch = {"node_feat": torch.empty(n, 8, device=meta),
             "edge_src": torch.empty(n, dtype=torch.int32, device=meta),
             "edge_dst": torch.empty(n, dtype=torch.int32, device=meta),
             "edge_feat": torch.empty(n, 4, device=meta),
             "target": torch.empty(n, 2, device=meta),
             "loss_mask": torch.empty(n, device=meta)}
    sh = Shardings(make_host_mesh((4, 2), device="meta") if sharded
                   else None)
    params = gnn.init_params(cfg, torch.Generator(), meta)
    return analyze(lambda p, b: value_and_grad(
        lambda pp, bb: gnn.forward_loss(cfg, sh, pp, bb), p, b),
        params, batch).peak_live_bytes


def test_block_checkpoints_keep_only_block_inputs():
    """The sharded graphcast's blocks of 4 checkpointed layers hold only
    each block's input (node and edge state) through the forward pass:
    8 more layers add 2 block inputs to its peak (on ``meta``), where
    the dense forward's per-layer checkpoints add 8 layer inputs."""
    carry = 2 * 8192 * 64 * 4                       # h and e, float32
    assert _meta_peak(16, True) - _meta_peak(8, True) == 2 * carry
    assert _meta_peak(16, False) - _meta_peak(8, False) == 8 * carry
