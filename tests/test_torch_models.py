"""The port's models against the reference package, on the CPU.

The 11 tests of ``tests/test_models.py`` run on the port (chunked
attention == full, decode == prefill dense and MoE, GQA == a dense
per-head loop, the vocab CE == a dense one, MoE capacity, RMSNorm, the
block-diagonal molecule batch, GAT's segment softmax, the embedding
bags against their oracles, retrieval top-k).  Then each model is held
to the reference on the same parameters and inputs, carried across by
``convert.tree_from_numpy`` in float32, at the tolerances stated at the
top of this file: ``common``'s functions; the LM's ``forward_loss``
with its gradients against ``jax.grad``, ``prefill`` and
``decode_step``, dense and MoE (the MoE cases first assert that the
reference's k-th and (k+1)-th router probabilities differ by more than
the tolerance, so a float near-tie cannot pass for a dispatch fault);
the four GNN archs' losses and gradients; recsys logits, loss and
gradients; retrieval top-k index for index, ties included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.graph import road_like as jroad_like
from repro.data.pipelines import gnn_full_batch as jgnn_full_batch
from repro.data.pipelines import gnn_molecule_batch as jgnn_molecule_batch
from repro.models import common as jcommon
from repro.models import gnn as jgnn
from repro.models import recsys as jrecsys
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.checkpoint.manager import tree_leaves
from repro_torch.core.graph import road_like
from repro_torch.data.pipelines import gnn_full_batch, gnn_molecule_batch
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import gnn, recsys, transformer
from repro_torch.models.common import (Shardings, apply_rope,
                                       causal_lm_loss,
                                       cross_entropy_vocab_sharded,
                                       gqa_attention, rms_norm, rope_angles,
                                       top_k)

torch.set_num_threads(1)

SH = Shardings(mesh=None)
JSH = jcommon.Shardings(mesh=None)
#: float32 tolerances: a loss; logits, activations and gradients
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _port(tree_np):
    return convert.tree_from_numpy(tree_np, "cpu")


# ---- the reference's cases, on the port -------------------------------------
def _tiny_lm(moe=False, **kw):
    # capacity_factor 4.0: no token drops, so prefill/decode agree
    # exactly (drops are legitimate MoE behaviour but break equivalence)
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=64, dtype=torch.float32, attn_chunk=8,
                moe=moe, n_experts=4 if moe else 0, top_k=2 if moe else 0,
                capacity_factor=4.0)
    base.update(kw)
    return transformer.LMConfig(**base)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_chunked_attention_equals_full():
    cfg_c = _tiny_lm(attn_chunk=4)
    cfg_f = _tiny_lm(attn_chunk=64)
    params = transformer.init_params(cfg_c, _gen(0))
    toks = torch.randint(0, 64, (2, 16), generator=_gen(1))
    l1 = transformer.forward_loss(cfg_c, SH, params, toks)
    l2 = transformer.forward_loss(cfg_f, SH, params, toks)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)


@pytest.mark.parametrize("moe", [False, True])
def test_decode_consistent_with_prefill(moe):
    cfg = _tiny_lm(moe=moe)
    params = transformer.init_params(cfg, _gen(2))
    toks = torch.randint(0, 64, (2, 10), generator=_gen(3))
    _, cache = transformer.prefill(cfg, SH, params, toks[:, :9])
    pad = (0, 0, 0, 0, 0, 7)
    cache = {"k": torch.nn.functional.pad(cache["k"], pad),
             "v": torch.nn.functional.pad(cache["v"], pad),
             "len": cache["len"]}
    dec, _ = transformer.decode_step(cfg, SH, params, cache, toks[:, 9])
    ref, _ = transformer.prefill(cfg, SH, params, toks)
    rel = float(torch.max(torch.abs(dec - ref)) / torch.max(torch.abs(ref)))
    assert rel < 5e-4, rel


def test_gqa_attention_matches_dense_reference():
    """GQA vs explicit per-head softmax attention."""
    rng = np.random.default_rng(0)
    b, tq, tk, h, kv, dh = 2, 5, 5, 4, 2, 8
    q = rng.normal(size=(b, tq, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, tk, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, tk, kv, dh)).astype(np.float32)
    got = gqa_attention(_t(q), _t(k), _t(v), causal=True)
    k_e = np.repeat(k, h // kv, axis=2)
    v_e = np.repeat(v, h // kv, axis=2)
    ref = np.zeros((b, tq, h, dh), np.float32)
    for bi in range(b):
        for hi in range(h):
            s = q[bi, :, hi] @ k_e[bi, :, hi].T / np.sqrt(dh)
            s = np.where(np.tril(np.ones((tq, tk))) > 0, s, -np.inf)
            p = np.exp(s - s.max(-1, keepdims=True))
            ref[bi, :, hi] = (p / p.sum(-1, keepdims=True)) @ v_e[bi, :, hi]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_vocab_sharded_ce_matches_dense():
    rng = np.random.default_rng(1)
    logits = _t(rng.normal(size=(2, 6, 50)).astype(np.float32))
    labels = _t(rng.integers(0, 50, (2, 6)).astype(np.int32))
    got = cross_entropy_vocab_sharded(logits, labels, SH)
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, 50),
                                             labels.reshape(-1).long())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_moe_capacity_drops_are_bounded():
    """With capacity_factor >= k the dispatch drops ~nothing and the MoE
    layer output is finite, with a positive aux loss."""
    cfg = _tiny_lm(moe=True, capacity_factor=4.0)
    params = transformer.init_params(cfg, _gen(4))
    x = torch.randn(2, 8, 32, generator=_gen(5))
    lw = {k: w[0] for k, w in params["layers"].items()}
    out, aux = transformer._moe_ffn(cfg, SH, lw, x)
    assert out.shape == x.shape
    assert torch.isfinite(out).all()
    assert float(aux) > 0.0


def test_rms_norm_invariants():
    x = torch.randn(4, 16, generator=_gen(6)) * 100
    y = rms_norm(x, torch.ones(16))
    assert abs(float(torch.mean(y ** 2)) - 1.0) < 0.05


def test_molecule_block_diagonal_equals_per_graph():
    """Disjoint-union batching == running each graph separately."""
    cfg = gnn.GNNConfig(name="g", arch="graphsage", n_layers=2,
                        d_hidden=8, d_feat=4, n_classes=3)
    params = gnn.init_params(cfg, _gen(7))
    b2 = {k: _t(v) for k, v in gnn_molecule_batch(2, 6, 8, 4,
                                                   seed=9).items()}
    b2["labels"] = b2["labels"] % 3
    full = gnn.forward_loss(cfg, SH, params, b2)
    losses = []
    for gi in range(2):
        sel = b2["graph_id"].numpy() == gi
        nidx = np.nonzero(sel)[0]
        remap = -np.ones(12, np.int64)
        remap[nidx] = np.arange(6)
        es, ed = b2["edge_src"].numpy(), b2["edge_dst"].numpy()
        emask = sel[es]
        sub = dict(node_feat=b2["node_feat"][nidx],
                   edge_src=_t(remap[es[emask]].astype(np.int32)),
                   edge_dst=_t(remap[ed[emask]].astype(np.int32)),
                   labels=b2["labels"][nidx],
                   loss_mask=b2["loss_mask"][nidx])
        losses.append(float(gnn.forward_loss(cfg, SH, params, sub)))
    np.testing.assert_allclose(float(full), np.mean(losses), rtol=1e-5)


def test_gat_attention_rows_sum_to_one():
    """Segment softmax: incoming-edge attention normalises per node."""
    g = road_like(200, seed=15)
    batch = gnn_full_batch(g, d_feat=6, n_classes=3, seed=0)
    cfg = gnn.GNNConfig(name="gat", arch="gat", n_layers=1, d_hidden=4,
                        n_heads=2, d_feat=6, n_classes=3)
    params = gnn.init_params(cfg, _gen(8))
    dst = _t(batch["edge_dst"]).long()
    _, alpha = gnn.gat_attention(params["layers"][0],
                                 _t(batch["node_feat"]),
                                 _t(batch["edge_src"]).long(), dst, g.n)
    sums = torch.zeros(g.n, alpha.shape[1]).index_add(0, dst, alpha)
    deg = torch.bincount(dst, minlength=g.n)
    np.testing.assert_allclose(sums[deg > 0].numpy(), 1.0, rtol=1e-5)


@given(st.integers(0, 100_000))
@settings(max_examples=20)
def test_embedding_bag_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    rows, dim = 50, 6
    b, f, h = 3, 2, 4
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    ids = rng.integers(0, rows, (b, f, h)).astype(np.int32)
    got = recsys.embedding_bag(_t(table), _t(ids), combiner="mean")
    np.testing.assert_allclose(got.numpy(), table[ids].mean(axis=2),
                               rtol=1e-5)


@given(st.integers(0, 100_000))
@settings(max_examples=20)
def test_embedding_bag_ragged_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    rows, dim, nnz, bags = 30, 4, 12, 5
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    ids = rng.integers(0, rows, nnz).astype(np.int32)
    cuts = np.sort(rng.integers(0, nnz + 1, bags - 1))
    offsets = np.concatenate([[0], cuts]).astype(np.int32)
    got = recsys.embedding_bag_ragged(_t(table), _t(ids), _t(offsets),
                                      bags, combiner="sum")
    bounds = np.concatenate([offsets, [nnz]])
    want = np.stack([table[ids[bounds[i]:bounds[i + 1]]].sum(0)
                     if bounds[i + 1] > bounds[i] else np.zeros(dim)
                     for i in range(bags)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_retrieval_topk_correct():
    cfg = recsys.RecsysConfig(name="r", n_sparse=3, rows_per_field=40,
                              embed_dim=4, mlp_dims=(16, 8))
    params = recsys.init_params(cfg, _gen(9))
    rng = np.random.default_rng(2)
    batch = dict(
        sparse_ids=_t(rng.integers(0, 40, (1, 3, 2)).astype(np.int32)),
        dense=_t(rng.normal(size=(1, 13)).astype(np.float32)),
        candidates=_t(rng.normal(size=(500, 8)).astype(np.float32)))
    vals, idx = recsys.retrieval_scores(cfg, SH, params, batch, top_k=10)
    assert vals.shape == (10,)
    assert (np.diff(vals.numpy()) <= 1e-6).all()


# ---- parity: common ---------------------------------------------------------
def test_common_functions_match_reference():
    rng = np.random.default_rng(20)
    x = (rng.normal(size=(3, 7, 16)) * 5).astype(np.float32)
    s = rng.normal(size=(16,)).astype(np.float32)
    _close(rms_norm(_t(x), _t(s)), jcommon.rms_norm(jnp.asarray(x),
                                                    jnp.asarray(s)))
    pos = np.arange(11, dtype=np.int32) + 3
    c, sn = rope_angles(_t(pos), 16, 10_000.0)
    jc, js = jcommon.rope_angles(jnp.asarray(pos), 16, 10_000.0)
    _close(c, jc)
    _close(sn, js)
    q = rng.normal(size=(2, 11, 4, 16)).astype(np.float32)
    _close(apply_rope(_t(q), c, sn),
           jcommon.apply_rope(jnp.asarray(q), jc, js))
    k = rng.normal(size=(2, 11, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 11, 2, 16)).astype(np.float32)
    for kw in (dict(causal=True), dict(causal=True, q_offset=4),
               dict(causal=False, kv_len=6), dict(causal=True, kv_len=9)):
        qs = q[:, :7] if "q_offset" in kw else q
        _close(gqa_attention(_t(qs), _t(k), _t(v), **kw),
               jcommon.gqa_attention(jnp.asarray(qs), jnp.asarray(k),
                                     jnp.asarray(v), **kw))
    logits = rng.normal(size=(2, 6, 50)).astype(np.float32) * 3
    toks = rng.integers(0, 50, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        float(causal_lm_loss(_t(logits), _t(toks), SH)),
        float(jcommon.causal_lm_loss(jnp.asarray(logits),
                                     jnp.asarray(toks), JSH)),
        rtol=LOSS_RTOL)


# ---- parity: the LM ----------------------------------------------------------
def _lm_pair(moe, **kw):
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=300, attn_chunk=8, moe=moe,
                n_experts=4 if moe else 0, top_k=2 if moe else 0)
    base.update(kw)
    return (jtransformer.LMConfig(**base, dtype=jnp.float32),
            transformer.LMConfig(**base, dtype=torch.float32))


def _router_gap(cfgj, pj, toks) -> float:
    """Smallest gap, over every token and layer, between the reference's
    k-th and (k+1)-th router probability."""
    b, t = toks.shape
    h = pj["embed"][toks].astype(cfgj.dtype)
    cos, sin = jcommon.rope_angles(jnp.arange(t), cfgj.head_dim,
                                   cfgj.rope_theta)
    gaps = []
    for l in range(cfgj.n_layers):
        lw = jax.tree_util.tree_map(lambda w: w[l], pj["layers"])
        attn, _, _ = jtransformer._attention_block(
            cfgj, JSH, lw, jcommon.rms_norm(h, lw["attn_norm"]), cos, sin)
        hin = jcommon.rms_norm(h + attn, lw["ffn_norm"])
        probs = jax.nn.softmax(hin.reshape(b * t, -1) @ lw["router"], -1)
        srt = -np.sort(-np.asarray(probs), axis=-1)
        gaps.append(np.min(srt[:, cfgj.top_k - 1] - srt[:, cfgj.top_k]))
        h = jtransformer._layer(cfgj, JSH, h, lw, cos, sin)[0]
    return float(min(gaps))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("chunk", [8, 64], ids=["chunked", "full"])
def test_lm_forward_loss_and_grads_match_reference(moe, chunk):
    cfgj, cfgt = _lm_pair(moe, attn_chunk=chunk)
    pj = jtransformer.init_params(cfgj, jax.random.PRNGKey(10))
    toks = np.random.default_rng(10).integers(0, 300, (2, 16)
                                              ).astype(np.int32)
    if moe:
        assert _router_gap(cfgj, pj, jnp.asarray(toks)) > RTOL
    lj, gj = jax.value_and_grad(lambda p: jtransformer.forward_loss(
        cfgj, JSH, p, jnp.asarray(toks)))(pj)
    pt = _port(jax.tree_util.tree_map(np.asarray, pj))
    lt, gt = value_and_grad(
        lambda p, b: transformer.forward_loss(cfgt, SH, p, b), pt, _t(toks))
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    want = jax.tree_util.tree_leaves(gj)
    got = tree_leaves(gt)
    assert len(want) == len(got) == 11 + (1 if moe else 0)
    for a, b in zip(want, got):
        _close(b, a)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_lm_prefill_and_decode_match_reference(moe):
    cfgj, cfgt = _lm_pair(moe, capacity_factor=4.0)
    pj = jtransformer.init_params(cfgj, jax.random.PRNGKey(11))
    pt = _port(jax.tree_util.tree_map(np.asarray, pj))
    toks = np.random.default_rng(11).integers(0, 300, (2, 12)
                                              ).astype(np.int32)
    if moe:
        assert _router_gap(cfgj, pj, jnp.asarray(toks)) > RTOL
    lj, cj = jtransformer.prefill(cfgj, JSH, pj, jnp.asarray(toks[:, :9]))
    lt, ct = transformer.prefill(cfgt, SH, pt, _t(toks[:, :9]))
    _close(lt, lj)
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])
    assert int(ct["len"]) == int(cj["len"]) == 9
    pad = ((0, 0),) * 2 + ((0, 3),) + ((0, 0),) * 2
    cj = {"k": jnp.pad(cj["k"], pad), "v": jnp.pad(cj["v"], pad),
          "len": cj["len"]}
    ct = {"k": _t(np.asarray(cj["k"])), "v": _t(np.asarray(cj["v"])),
          "len": ct["len"]}
    for i in range(9, 12):           # three steps, each cache handed on
        lj, cj = jtransformer.decode_step(cfgj, JSH, pj, cj,
                                          jnp.asarray(toks[:, i]))
        lt, ct = transformer.decode_step(cfgt, SH, pt, ct, _t(toks[:, i]))
        _close(lt, lj)
        assert int(ct["len"]) == int(cj["len"]) == i + 1
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])


def test_moe_dispatch_with_drops_matches_reference():
    """capacity_factor 0.5 drops tokens: which ones is decided by the
    token-major cumsum, and the port must drop the same."""
    cfgj, cfgt = _lm_pair(True, capacity_factor=0.5, d_model=16,
                          n_experts=4, top_k=2)
    pj = jtransformer.init_params(cfgj, jax.random.PRNGKey(12))
    lwj = jax.tree_util.tree_map(lambda w: w[0], pj["layers"])
    x = np.random.default_rng(12).normal(size=(2, 40, 16)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(x.reshape(80, 16)
                                      @ np.asarray(lwj["router"]), -1))
    srt = -np.sort(-probs, axis=-1)
    assert np.min(srt[:, 1] - srt[:, 2]) > RTOL
    oj, aj = jtransformer._moe_ffn(cfgj, JSH, lwj, jnp.asarray(x))
    lwt = _port(jax.tree_util.tree_map(np.asarray, lwj))
    ot, at = transformer._moe_ffn(cfgt, SH, lwt, _t(x))
    _close(ot, oj)
    np.testing.assert_allclose(float(at), float(aj), rtol=LOSS_RTOL)
    # some tokens were dropped: the outputs' zero rows agree
    dropped = np.all(np.asarray(oj) == 0, axis=-1)
    assert dropped.sum() > 0
    np.testing.assert_array_equal(np.all(ot.numpy() == 0, axis=-1), dropped)


def test_top_k_keeps_lax_top_k_order_on_ties():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.1]],
                 np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = top_k(_t(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---- parity: GNNs ------------------------------------------------------------
def _gnn_batch(arch):
    if arch == "dimenet":
        b = jgnn_molecule_batch(3, 8, 12, 5, seed=21)
        tb = gnn_molecule_batch(3, 8, 12, 5, seed=21)
    else:
        b = jgnn_full_batch(jroad_like(120, seed=21), 5, 4, seed=21, n_out=2)
        tb = gnn_full_batch(road_like(120, seed=21), 5, 4, seed=21, n_out=2)
    for k in b:                       # the port's copy makes the same data
        np.testing.assert_array_equal(tb[k], b[k])
    b = dict(b)
    b["labels"] = b["labels"] % 4
    b["target"] = b["target"][:, :1].repeat(2, 1)
    b["loss_mask"] = (np.arange(b["labels"].size) % 3 != 0
                      ).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", ["graphcast", "dimenet", "graphsage",
                                  "gat"])
def test_gnn_loss_and_grads_match_reference(arch):
    kw = dict(name=arch, arch=arch, n_layers=2, d_hidden=8, d_feat=5,
              n_classes=4, n_heads=2, n_out=2)
    cfgj, cfgt = jgnn.GNNConfig(**kw), gnn.GNNConfig(**kw)
    pj = jgnn.init_params(cfgj, jax.random.PRNGKey(13))
    b = _gnn_batch(arch)
    lj, gj = jax.value_and_grad(lambda p: jgnn.forward_loss(
        cfgj, JSH, p, {k: jnp.asarray(v) for k, v in b.items()}))(pj)
    pt = _port(jax.tree_util.tree_map(np.asarray, pj))
    lt, gt = value_and_grad(
        lambda p, bb: gnn.forward_loss(cfgt, SH, p, bb), pt,
        {k: _t(v) for k, v in b.items()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    want, got = jax.tree_util.tree_leaves(gj), tree_leaves(gt)
    assert len(want) == len(got)
    scale = max(float(np.max(np.abs(np.asarray(a)))) for a in want)
    for a, g_ in zip(want, got):
        _close(g_, a, atol=ATOL * max(scale, 1.0))


def test_sharded_gnn_forward_is_refused():
    """The sharded forward (``tests/test_torch_gnn_sharded.py`` holds it
    to the dense one) refuses a batch whose rows do not split evenly
    over the mesh's shards, as ``shard_map`` does."""
    from repro_torch.launch.mesh import make_host_mesh
    cfg = gnn.GNNConfig(name="g", arch="graphcast", n_layers=1, d_hidden=4,
                        d_feat=5, sharded=True)
    sh = Shardings(make_host_mesh((2, 1), device="cpu"))
    batch = {"node_feat": torch.zeros(5, 5),
             "edge_src": torch.zeros(4, dtype=torch.int32),
             "edge_dst": torch.zeros(4, dtype=torch.int32),
             "edge_feat": torch.zeros(4, 4), "target": torch.zeros(5, 1),
             "loss_mask": torch.ones(5)}
    params = gnn.init_params(cfg, _gen(0), "cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        gnn.forward_loss(cfg, sh, params, batch)


# ---- parity: recsys ------------------------------------------------------------
def _recsys_pair():
    kw = dict(name="r", n_sparse=5, rows_per_field=30, embed_dim=4,
              mlp_dims=(16, 8))
    return jrecsys.RecsysConfig(**kw), recsys.RecsysConfig(**kw)


def test_recsys_logits_loss_and_grads_match_reference():
    cfgj, cfgt = _recsys_pair()
    pj = jrecsys.init_params(cfgj, jax.random.PRNGKey(14))
    # a nonzero wide part, so its gradient path is exercised too
    pj["wide_table"] = jnp.asarray(np.random.default_rng(1).normal(
        size=pj["wide_table"].shape).astype(np.float32))
    rng = np.random.default_rng(14)
    b = {"sparse_ids": rng.integers(0, 30, (6, 5, 2)).astype(np.int32),
         "dense": rng.normal(size=(6, 13)).astype(np.float32),
         "labels": rng.integers(0, 2, 6).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    pt = _port(jax.tree_util.tree_map(np.asarray, pj))
    _close(recsys.forward_logits(cfgt, SH, pt, tb),
           jrecsys.forward_logits(cfgj, JSH, pj, jb))
    lj, gj = jax.value_and_grad(
        lambda p: jrecsys.forward_loss(cfgj, JSH, p, jb))(pj)
    lt, gt = value_and_grad(
        lambda p, bb: recsys.forward_loss(cfgt, SH, p, bb), pt, tb)
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    for a, g_ in zip(jax.tree_util.tree_leaves(gj), tree_leaves(gt)):
        _close(g_, a)
    # the table gradient is dense: every row is a (zero or not) entry
    assert gt["table"].layout == torch.strided
    assert gt["table"].shape == pt["table"].shape


@pytest.mark.parametrize("ties", [False, True])
def test_retrieval_topk_matches_reference_index_for_index(ties):
    cfgj, cfgt = _recsys_pair()
    pj = jrecsys.init_params(cfgj, jax.random.PRNGKey(15))
    rng = np.random.default_rng(15)
    cand = rng.normal(size=(700, 8)).astype(np.float32)
    if ties:                      # repeated candidates: equal scores
        cand[350:] = cand[:350]
        cand[::7] = cand[3]
    b = {"sparse_ids": rng.integers(0, 30, (1, 5, 2)).astype(np.int32),
         "dense": rng.normal(size=(1, 13)).astype(np.float32),
         "candidates": cand}
    jv, ji = jrecsys.retrieval_scores(
        cfgj, JSH, pj, {k: jnp.asarray(v) for k, v in b.items()}, top_k=50)
    tv, ti = recsys.retrieval_scores(
        cfgt, SH, _port(jax.tree_util.tree_map(np.asarray, pj)),
        {k: _t(v) for k, v in b.items()}, top_k=50)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv)
    if ties:
        assert len(set(np.round(tv.numpy(), 5))) < 50
