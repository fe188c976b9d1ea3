"""AdamW + schedules + global-norm clipping.

Port of ``repro/optim/adamw.py`` with the reference's arithmetic: the
moments (m, v) are computed in float32 whatever the parameter dtype and
rounded to ``state_dtype`` on store; the clip scale is folded into the
per-leaf update and ``grad_scale`` into the clip; each new parameter is
cast back to its parameter's dtype.  Leaves are visited in the
reference's order (``checkpoint.manager.tree_flatten``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..checkpoint.manager import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass
class AdamWState:
    m: Any
    v: Any
    step: torch.Tensor        # int32 scalar


def adamw_init(params, state_dtype=torch.float32) -> AdamWState:
    """``state_dtype=torch.bfloat16`` halves optimizer memory: the
    moments are accumulated in float32 inside the update and rounded on
    store.  The state lives on the device of each parameter."""
    m = tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                       device=p.device), params)
    v = tree_map(torch.clone, m)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(m=m, v=v, step=step)


def _global_norm(leaves) -> torch.Tensor:
    total = 0
    for g in leaves:                  # the reference's summation order
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def global_norm_clip(grads, max_norm: float):
    gn = _global_norm(tree_leaves(grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01, max_norm: float = 1.0,
                 serialize: bool = False, grad_scale: float = 1.0,
                 donate: bool = False):
    """-> (new_params, new_state, metrics). ``lr`` is a scalar or a
    schedule callable of the step.

    ``donate=False`` returns new tensors and writes no input.
    ``donate=True`` is the port's ``jax.jit(..., donate_argnums=(0, 1))``
    (the reference's train driver; the port's train steps use it): each
    parameter and moment is written in place and returned, so the update
    holds no second copy of the parameters or of the optimizer state.
    Both round every operation as the reference does.

    ``serialize`` is kept for the reference's signature and changes
    nothing: the reference chains its leaf updates through
    ``optimization_barrier`` so XLA cannot hold every leaf's float32
    temporaries at once, and eager torch already updates one leaf after
    another, freeing each leaf's temporaries before the next."""
    del serialize
    gnorm = _global_norm(tree_leaves(grads)) * grad_scale
    clip = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0) * grad_scale
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def f32(x):
        """x in float32: x itself when donated and already float32."""
        return x.to(torch.float32, copy=not donate)

    def store(dst, x32):
        """x32 rounded to dst's dtype: into dst when donated."""
        if not donate:
            return x32.to(dst.dtype)
        if x32 is not dst:
            dst.copy_(x32)
        return dst

    def upd(p, g, m, v):
        g = g.float() * clip
        m32 = f32(m).mul_(b1).add_((1 - b1) * g)
        v32 = f32(v).mul_(b2).add_((1 - b2) * g * g)
        del g
        new_m, new_v = store(m, m32), store(v, v32)
        mh = m32 / bc1
        vh = v32 / bc2
        del m32, v32
        delta = mh.div_(vh.sqrt_().add_(eps)).add_(
            weight_decay * p.float())
        del vh
        newp = f32(p).sub_(delta.mul_(lr_t))
        return store(p, newp), new_m, new_v

    flat_p, tdef = tree_flatten(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(state.m)
    flat_v = tree_leaves(state.v)
    out = [upd(p, g, m, v)
           for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = tree_unflatten(tdef, [o[0] for o in out])
    new_m = tree_unflatten(tdef, [o[1] for o in out])
    new_v = tree_unflatten(tdef, [o[2] for o in out])
    if donate:
        state.step.copy_(step)
        step = state.step
    return new_p, AdamWState(new_m, new_v, step), {"grad_norm": gnorm,
                                                   "lr": lr_t}


def cosine_schedule(peak_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def f(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * peak_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return f
