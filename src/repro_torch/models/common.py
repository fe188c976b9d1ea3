"""Shared model building blocks: norms, RoPE, attention, cross entropy.

Port of ``repro/models/common.py``.  ``Shardings`` keeps the reference's
answers (``dp``, ``tp``, ``spec``, ``named``) over the port's ``Mesh``
(``launch/mesh.py``), so the models' ``param_specs`` read the same; but
on the port's one-controller mesh a tensor's placement is the device it
lives on, so ``constrain`` returns its input unchanged.

Attention is written as the reference writes it (einsum, float32
scores, softmax), not as ``F.scaled_dot_product_attention``: the parity
tests hold the same arithmetic, and no library kernel stands in for a
reference function.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The port's stand-in for ``jax.sharding.NamedSharding``: a mesh and
    a partition spec (a tuple of axis names or ``None``s)."""
    mesh: object
    spec: tuple


@dataclasses.dataclass(frozen=True)
class Shardings:
    mesh: Optional[object]          # a launch.mesh.Mesh, or None

    @property
    def dp(self):
        """Batch / FSDP axes: ('pod','data') on multi-pod, ('data',)."""
        if self.mesh is None:
            return None
        names = self.mesh.axis_names
        return tuple(a for a in ("pod", "data") if a in names) or None

    @property
    def tp(self):
        if self.mesh is None:
            return None
        return "model" if "model" in self.mesh.axis_names else None

    def axis_size(self, name: str) -> int:
        """Size of mesh axis ``name`` (1 without a mesh or the axis)."""
        if self.mesh is None or name not in self.mesh.axis_names:
            return 1
        return dict(zip(self.mesh.axis_names, self.mesh.shape))[name]

    def spec(self, *axes) -> tuple:
        return tuple(axes)

    def constrain(self, x: torch.Tensor, *axes) -> torch.Tensor:
        return x

    def named(self, *axes) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(*axes))


# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [.. T] -> (cos, sin) each [..., T, head_dim/2] f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., T, n_heads, head_dim]; cos/sin broadcast over heads."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention.

    q [B, Tq, H, dh]; k/v [B, Tk, KV, dh]; H = KV * group.
    ``q_offset``: absolute position of q[0] (decode: Tk_filled - 1).
    ``kv_len``: number of valid cache slots (decode masking).
    Returns [B, Tq, H, dh].  Scores are float32 products of the
    inputs' values (the reference's ``preferred_element_type``).
    """
    b, tq, h, dh = q.shape
    _, tk, kv, _ = k.shape
    group = h // kv
    qg = q.reshape(b, tq, kv, group, dh)
    scale = dh ** -0.5
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                          k.float()) * scale
    kpos = torch.arange(tk, device=q.device)
    mask = None
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        mask = kpos[None, :] <= qpos                 # [tq, tk]
        if kv_len is not None:
            mask = mask & (kpos[None, :] < kv_len)
    elif kv_len is not None:
        mask = (kpos < kv_len)[None, :]              # [1, tk]
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, tq, h, dh)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest in descending
    order, a tie to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cross_entropy_vocab_sharded(logits: torch.Tensor, labels: torch.Tensor,
                                sh: Shardings) -> torch.Tensor:
    """Mean CE with logits [B, T, V], written with plain reductions over
    V as the reference's vocab-sharded form is."""
    logits = sh.constrain(logits.float(), sh.dp, None, sh.tp)
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   sh: Shardings) -> torch.Tensor:
    """Next-token prediction: logits[:, :-1] vs tokens[:, 1:]."""
    return cross_entropy_vocab_sharded(logits[:, :-1], tokens[:, 1:], sh)
