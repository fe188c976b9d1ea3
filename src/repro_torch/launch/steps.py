"""Step functions (train/prefill/decode/serve) composed from models +
optimizer, with gradient accumulation.

Port of ``repro/launch/steps.py``.  Where the reference traces
``jax.value_and_grad`` under ``jit``, a port step runs autograd eagerly
over each microbatch.  A train step updates the parameters and the
optimizer state in place and returns them, as the reference's train
driver's ``jax.jit(step, donate_argnums=(0, 1))`` reuses their buffers:
the step holds no second copy of either.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..checkpoint.manager import tree_flatten, tree_map, tree_unflatten
from ..models import gnn, recsys, transformer
from ..models.common import Shardings
from ..optim import AdamWState, adamw_update


def constrain_tree(tree, specs, sh: Shardings):
    """Identity: on the port's one-controller mesh a tensor's placement
    is where it lives (``Shardings.constrain``)."""
    return tree


def value_and_grad(loss_fn: Callable, params, batch):
    """-> (loss, grads): ``loss_fn(params, batch)`` and its gradient
    tree (a leaf the loss does not reach gets zeros, as in JAX)."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(tree_unflatten(treedef, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), tree_unflatten(treedef, grads)


def make_grad_accum_step(loss_fn: Callable, split_batch: Callable,
                         n_micro: int, param_specs, sh: Shardings,
                         lr: float = 3e-4, serialize_update: bool = False,
                         accum_dtype=torch.float32):
    """Generic train step: grads accumulated over n_micro microbatches
    (float32 by default), then one AdamW update.

    loss_fn(params, microbatch) -> scalar loss
    split_batch(batch, n_micro) -> tree with leading [n_micro, ...]
    The 1/n_micro mean goes into the optimizer as ``grad_scale`` (folded
    into its clip scale), as in the reference.
    """

    def step(params, opt: AdamWState, batch):
        if n_micro <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
            grad_scale = 1.0
        else:
            micro = split_batch(batch, n_micro)
            leaves, treedef = tree_flatten(params)
            acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                   for p in leaves]
            losses = []
            for i in range(n_micro):
                mb = tree_map(lambda x: x[i], micro)
                loss, g = value_and_grad(loss_fn, params, mb)
                acc = [a + b.to(accum_dtype)
                       for a, b in zip(acc, tree_flatten(g)[0])]
                losses.append(loss)
            grads = tree_unflatten(treedef, acc)
            grad_scale = 1.0 / n_micro
            loss = torch.mean(torch.stack(losses))
        new_params, new_opt, metrics = adamw_update(
            params, grads, opt, lr=lr, serialize=serialize_update,
            grad_scale=grad_scale, donate=True)
        metrics = dict(metrics, loss=loss)
        return new_params, new_opt, metrics

    return step


# ---------------------------------------------------------------------------
# LM steps
# ---------------------------------------------------------------------------
def lm_train_step(cfg: transformer.LMConfig, sh: Shardings,
                  n_micro: int, serialize_update: bool = False,
                  accum_dtype=torch.float32):
    specs = transformer.param_specs(cfg, sh, for_opt_state=True)

    def loss_fn(params, tokens):
        return transformer.forward_loss(cfg, sh, params, tokens)

    def split(tokens, n):
        b, t = tokens.shape
        return tokens.reshape(n, b // n, t)

    return make_grad_accum_step(loss_fn, split, n_micro, specs, sh,
                                serialize_update=serialize_update,
                                accum_dtype=accum_dtype)


def lm_prefill_step(cfg: transformer.LMConfig, sh: Shardings):
    def step(params, tokens):
        return transformer.prefill(cfg, sh, params, tokens)
    return step


def lm_decode_step(cfg: transformer.LMConfig, sh: Shardings):
    def step(params, cache, token):
        return transformer.decode_step(cfg, sh, params, cache, token)
    return step


# ---------------------------------------------------------------------------
# GNN / recsys steps
# ---------------------------------------------------------------------------
def gnn_train_step(cfg: gnn.GNNConfig, sh: Shardings):
    def loss_fn(params, batch):
        return gnn.forward_loss(cfg, sh, params, batch)
    return make_grad_accum_step(loss_fn, None, 1, None, sh)


def recsys_train_step(cfg: recsys.RecsysConfig, sh: Shardings):
    specs = recsys.param_specs(cfg, sh)

    def loss_fn(params, batch):
        return recsys.forward_loss(cfg, sh, params, batch)
    return make_grad_accum_step(loss_fn, None, 1, specs, sh)


def recsys_serve_step(cfg: recsys.RecsysConfig, sh: Shardings):
    def step(params, batch):
        return recsys.forward_logits(cfg, sh, params, batch)
    return step


def recsys_retrieval_step(cfg: recsys.RecsysConfig, sh: Shardings,
                          top_k: int = 100):
    def step(params, batch):
        return recsys.retrieval_scores(cfg, sh, params, batch,
                                       top_k=top_k)
    return step
