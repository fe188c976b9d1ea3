"""Decoder-only transformer LM: dense + MoE, GQA, RoPE, SwiGLU, RMSNorm.

Port of ``repro/models/transformer.py`` (the five LM archs: granite-8b,
command-r-plus, phi4-mini, llama4-scout MoE, granite-moe).  Layer
weights stay stacked ``[L, ...]`` as in the reference, so parameters
convert one to one; the port loops over the layers in Python.

  * ``cfg.remat`` wraps each layer in ``torch.utils.checkpoint``
    (non-reentrant).  ``remat_policy="save_tp_outputs"`` only keeps the
    reference's recompute from repeating its tensor-parallel
    collectives; the port's one-controller model has none, so it is the
    same as full remat here.
  * prefill uses q-chunked attention (fixed [chunk, T] score tiles) so
    a long prefill never materialises a T x T score matrix.
  * decode keeps a [L, B, Tmax, KV, dh] cache.  Where the reference
    updates it functionally, ``decode_step`` writes the caller's cache
    tensors in place and returns them: a cache handed to
    ``decode_step`` holds the new position afterwards.
  * MoE uses the reference's gather/scatter dispatch with static
    capacity: position-in-expert from a cumsum over the one-hot mask of
    the flat [N*K] choices in token-major order (it decides which tokens
    are dropped), the overflow slot E*cap of an [E*cap+1] buffer, and
    ``lax.top_k``'s order (a stable descending sort: a tie goes to the
    lower expert index).
  * logits run over ``vocab_padded``; the padded embedding rows are
    parameters and enter the log-sum-exp, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import (Shardings, apply_rope, causal_lm_loss, gqa_attention,
                     rms_norm, rope_angles, top_k)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    rope_theta: float = 500_000.0
    dtype: Any = torch.bfloat16
    remat: bool = True
    attn_chunk: int = 1024           # q-chunk for long prefill
    # the reference's memory levers for its SPMD layouts; kept so the
    # arch specs read the same, and inert on one controller
    gather_fsdp_in_body: bool = False
    seq_shard_activations: bool = False
    zero_stage: int = 3
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256

    def n_params(self) -> int:
        """Total parameter count (for 6ND model-FLOPs accounting)."""
        d, f, h, kv, dh = (self.d_model, self.d_ff, self.n_heads,
                           self.n_kv_heads, self.head_dim)
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.moe:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return (self.n_layers * per_layer + self.vocab_padded * d + d)

    def n_active_params(self) -> int:
        if not self.moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_ffn = 3 * d * f * self.top_k + d * self.n_experts
        moe_ffn = self.n_experts * 3 * d * f + d * self.n_experts
        return self.n_params() - self.n_layers * (moe_ffn - dense_ffn)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def init_params(cfg: LMConfig, generator: torch.Generator,
                device=None) -> Dict:
    """The reference's shapes, scales and dtypes, drawn from
    ``generator`` (a generator of ``device``'s kind) on ``device``
    (default: the generator's)."""
    device = generator.device if device is None else torch.device(device)
    d, f, h, kv, dh = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    L, V = cfg.n_layers, cfg.vocab_padded
    dt = cfg.dtype

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": ones((L, d)),
        "ffn_norm": ones((L, d)),
        "wq": normal((L, d, h, dh), d ** -0.5),
        "wk": normal((L, d, kv, dh), d ** -0.5),
        "wv": normal((L, d, kv, dh), d ** -0.5),
        "wo": normal((L, h, dh, d), (h * dh) ** -0.5),
    }
    if cfg.moe:
        E = cfg.n_experts
        layers.update({
            "router": normal((L, d, E), d ** -0.5),
            "w_gate": normal((L, E, d, f), d ** -0.5),
            "w_up": normal((L, E, d, f), d ** -0.5),
            "w_down": normal((L, E, f, d), f ** -0.5),
        })
    else:
        layers.update({
            "w_gate": normal((L, d, f), d ** -0.5),
            "w_up": normal((L, d, f), d ** -0.5),
            "w_down": normal((L, f, d), f ** -0.5),
        })
    return {
        # tied in/out embedding: small init keeps initial logits ~O(1)
        "embed": normal((V, d), d ** -0.5),
        "final_norm": ones((d,)),
        "layers": layers,
    }


def param_specs(cfg: LMConfig, sh: Shardings, *,
                for_opt_state: bool = False) -> Dict:
    """Partition-spec tree matching init_params output (the reference's
    answers; on one controller they place nothing)."""
    tp = sh.tp
    fsdp = "data" if (sh.mesh is not None
                      and "data" in sh.mesh.axis_names) else None
    if cfg.zero_stage == 1 and not for_opt_state:
        fsdp = None
    tp_size = sh.axis_size("model") if tp else 1
    heads_ok = cfg.n_heads % max(tp_size, 1) == 0
    h_tp = tp if heads_ok else None
    P_ = sh.spec
    layers = {
        "attn_norm": P_(None, None),
        "ffn_norm": P_(None, None),
        "wq": P_(None, fsdp, h_tp, None),
        "wk": P_(None, fsdp, None, None),
        "wv": P_(None, fsdp, None, None),
        "wo": P_(None, h_tp, None, fsdp),
    }
    if cfg.moe:
        e_tp = tp if cfg.n_experts % max(tp_size, 1) == 0 else None
        layers.update({
            "router": P_(None, fsdp, None),
            "w_gate": P_(None, e_tp, fsdp, None),
            "w_up": P_(None, e_tp, fsdp, None),
            "w_down": P_(None, e_tp, None, fsdp),
        })
    else:
        f_tp = tp if cfg.d_ff % max(tp_size, 1) == 0 else None
        layers.update({
            "w_gate": P_(None, fsdp, f_tp),
            "w_up": P_(None, fsdp, f_tp),
            "w_down": P_(None, f_tp, fsdp),
        })
    v_tp = tp if cfg.vocab_padded % max(tp_size, 1) == 0 else None
    return {
        "embed": P_(v_tp, fsdp),
        "final_norm": P_(None),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _attention_block(cfg: LMConfig, sh: Shardings, lw: Dict,
                     x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence causal attention, q-chunked for long T.

    Returns (out, k, v) so prefill can cache k/v without recompute."""
    b, t, d = x.shape
    q = torch.einsum("btd,dhk->bthk", x, lw["wq"])
    k = torch.einsum("btd,dhk->bthk", x, lw["wk"])
    v = torch.einsum("btd,dhk->bthk", x, lw["wv"])
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if t <= cfg.attn_chunk or t % cfg.attn_chunk != 0:
        o = gqa_attention(q, k, v, causal=True)
    else:
        c = cfg.attn_chunk
        o = torch.cat([gqa_attention(q[:, i:i + c], k, v, causal=True,
                                     q_offset=i)
                       for i in range(0, t, c)], dim=1)
    return torch.einsum("bthk,hkd->btd", o, lw["wo"]), k, v


def _dense_ffn(cfg: LMConfig, sh: Shardings, lw: Dict,
               x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("btd,df->btf", x, lw["w_gate"])
    u = torch.einsum("btd,df->btf", x, lw["w_up"])
    hidden = F.silu(g) * u
    return torch.einsum("btf,fd->btd", hidden, lw["w_down"])


def _moe_ffn(cfg: LMConfig, sh: Shardings, lw: Dict, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with static-capacity gather/scatter dispatch.

    Returns (output, aux_loss)."""
    b, t, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = b * t
    dev = x.device
    xf = x.reshape(N, d)
    logits = torch.einsum("nd,de->ne", xf, lw["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, K)                             # [N, K]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    experts = torch.arange(E, device=dev)
    # Switch-style load-balance aux loss
    density = torch.mean((eidx[:, :1] == experts).float(), dim=0)
    router_prob = torch.mean(probs, dim=0)
    aux = E * torch.sum(density * router_prob)
    # ---- dispatch -----------------------------------------------------
    cap = int(cfg.capacity_factor * N * K / E)
    cap = max(8, -(-cap // 8) * 8)
    flat_e = eidx.reshape(-1)                                # [N*K]
    # the one-hot mask transposed, [E, N*K], so the cumsum runs along
    # the inner axis (the same counts, in the same token-major order)
    onehot = (flat_e[None, :] == experts[:, None]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.sum(pos * onehot, dim=0)                     # [N*K]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, E * cap))     # overflow
    token_of = torch.arange(N, device=dev).repeat_interleave(K)
    # inverse map: slot -> token; kept slots are distinct, and the
    # overflow slot's duplicates are never read
    slot_token = torch.zeros(E * cap + 1, dtype=torch.long, device=dev)
    slot_token[slot] = token_of
    slot_valid = torch.zeros(E * cap + 1, dtype=torch.bool, device=dev)
    slot_valid[slot] = keep
    # index_select, not advanced indexing: its backward is an index_add
    # where indexing's is a sorted accumulate, ~20x slower on the card
    buf = (torch.index_select(xf, 0, slot_token[:E * cap])
           * slot_valid[:E * cap, None])
    buf = buf.reshape(E, cap, d)
    # ---- expert compute -------------------------------------------------
    g = torch.einsum("ecd,edf->ecf", buf, lw["w_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, lw["w_up"])
    hidden = F.silu(g) * u
    y = torch.einsum("ecf,efd->ecd", hidden, lw["w_down"])
    # ---- combine ----------------------------------------------------------
    yf = y.reshape(E * cap, d)
    gathered = torch.index_select(yf, 0, torch.clamp(slot,
                                                     max=E * cap - 1))
    gathered = gathered * (keep & (slot < E * cap))[:, None]
    contrib = gathered.reshape(N, K, d) * gate[..., None].to(x.dtype)
    out = torch.sum(contrib, dim=1).reshape(b, t, d)
    return out, aux


def _layer(cfg: LMConfig, sh: Shardings, x: torch.Tensor, lw: Dict,
           cos: torch.Tensor, sin: torch.Tensor):
    """-> (h, aux_loss, k, v)."""
    attn, k, v = _attention_block(cfg, sh, lw,
                                  rms_norm(x, lw["attn_norm"]), cos, sin)
    h = x + attn
    hin = rms_norm(h, lw["ffn_norm"])
    if cfg.moe:
        out, aux = _moe_ffn(cfg, sh, lw, hin)
    else:
        out = _dense_ffn(cfg, sh, lw, hin)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return h + out, aux, k, v


def _embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """params["embed"][tokens] as an ``index_select``."""
    emb = params["embed"]
    return torch.index_select(emb, 0, tokens.reshape(-1)).reshape(
        tokens.shape + emb.shape[1:])


def _layer_weights(params: Dict, n_layers: int) -> list:
    """Per-layer weight dicts as views of the stacked [L, ...] leaves
    (one ``unbind`` a leaf, so the backward pass stacks each leaf's
    gradient once)."""
    parts = {k: torch.unbind(w, 0) for k, w in params["layers"].items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n_layers)]


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------
def forward_loss(cfg: LMConfig, sh: Shardings, params: Dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Causal-LM loss for a [B, T] token batch."""
    b, t = tokens.shape
    tokens = tokens.long()
    h = _embed(params, tokens).to(cfg.dtype)
    cos, sin = rope_angles(torch.arange(t, device=h.device), cfg.head_dim,
                           cfg.rope_theta)

    def body(h, lw):
        h, aux, _, _ = _layer(cfg, sh, h, lw, cos, sin)
        return h, aux

    auxs = []
    for lw in _layer_weights(params, cfg.n_layers):
        if cfg.remat and torch.is_grad_enabled():
            h, aux = checkpoint(body, h, lw, use_reentrant=False)
        else:
            h, aux = body(h, lw)
        auxs.append(aux)
    h = rms_norm(h, params["final_norm"])
    logits = torch.einsum("btd,vd->btv", h, params["embed"])
    loss = causal_lm_loss(logits, tokens, sh)
    if cfg.moe:
        loss = loss + 0.01 * torch.mean(torch.stack(auxs))
    return loss


# ---------------------------------------------------------------------------
# inference: prefill + decode
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(cfg: LMConfig, sh: Shardings, params: Dict,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """[B, T] prompt -> (last-position logits [B, V], kv cache).

    Cache layout: k/v [L, B, T, KV, dh], ``len`` an int32 scalar."""
    b, t = tokens.shape
    h = _embed(params, tokens.long()).to(cfg.dtype)
    cos, sin = rope_angles(torch.arange(t, device=h.device), cfg.head_dim,
                           cfg.rope_theta)
    ks, vs = [], []
    for lw in _layer_weights(params, cfg.n_layers):
        h, _, k, v = _layer(cfg, sh, h, lw, cos, sin)
        ks.append(k)
        vs.append(v)
    h = rms_norm(h[:, -1:], params["final_norm"])
    logits = torch.einsum("btd,vd->btv", h, params["embed"])[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "len": torch.full((), t, dtype=torch.int32,
                                      device=h.device)}


@torch.no_grad()
def decode_step(cfg: LMConfig, sh: Shardings, params: Dict, cache: Dict,
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step: token [B] + cache -> (logits [B, V], cache).

    Writes position ``cache["len"]`` of the caller's ``k``/``v`` tensors
    in place (the reference's ``dynamic_update_slice``) and returns them
    with ``len + 1``."""
    ck, cv = cache["k"], cache["v"]
    # the slot written: the cache's fill, read on the host; a meta cache
    # (the dry runs) has no values, and takes the last slot, as no shape
    # depends on it
    pos = (ck.shape[2] - 1 if cache["len"].device.type == "meta"
           else int(cache["len"]))
    h = _embed(params, token.long()[:, None]).to(cfg.dtype)   # [B, 1, D]
    cos, sin = rope_angles(torch.full((1,), pos, device=h.device),
                           cfg.head_dim, cfg.rope_theta)
    for l, lw in enumerate(_layer_weights(params, cfg.n_layers)):
        xn = rms_norm(h, lw["attn_norm"])
        q = torch.einsum("btd,dhk->bthk", xn, lw["wq"])
        k = torch.einsum("btd,dhk->bthk", xn, lw["wk"])
        v = torch.einsum("btd,dhk->bthk", xn, lw["wv"])
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        ck[l, :, pos] = k[:, 0].to(ck.dtype)
        cv[l, :, pos] = v[:, 0].to(cv.dtype)
        o = gqa_attention(q, ck[l], cv[l], causal=False, kv_len=pos + 1)
        attn = torch.einsum("bthk,hkd->btd", o, lw["wo"])
        hh = h + attn
        hin = rms_norm(hh, lw["ffn_norm"])
        if cfg.moe:
            out, _ = _moe_ffn(cfg, sh, lw, hin)
        else:
            out = _dense_ffn(cfg, sh, lw, hin)
        h = hh + out
    h = rms_norm(h, params["final_norm"])
    logits = torch.einsum("btd,vd->btv", h, params["embed"])[:, 0]
    return logits, {"k": ck, "v": cv, "len": cache["len"] + 1}


def cache_specs(cfg: LMConfig, sh: Shardings, batch: int, t_max: int,
                *, shard_seq: bool) -> Dict:
    """(shape, dtype) + partition spec of each decode-cache entry."""
    kv, dh, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    shape = (L, batch, t_max, kv, dh)
    if shard_seq:
        seq_axes = tuple(a for a in ("pod", "data", "model")
                         if sh.mesh is not None
                         and a in sh.mesh.axis_names)
        spec = sh.spec(None, None, seq_axes or None, None, None)
    else:
        spec = sh.spec(None, sh.dp, sh.tp, None, None)
    return {
        "k": ((shape, cfg.dtype), spec), "v": ((shape, cfg.dtype), spec),
        "len": (((), torch.int32), sh.spec()),
    }
