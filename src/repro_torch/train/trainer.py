"""Train-step factory (port of ``repro/train/trainer.py``): loss → gradients
(optionally accumulated over microbatches) → AdamW, with activation remat
on each block.

Plain autograd: the reference jits its train step with ``backend="xla"``
and runs full-sequence attention chunked, so no kernel is on this path (and
``kernels.ops`` refuses operands that require grad).  No ``torch.compile``
and no CUDA graph.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import api
from repro_torch.optim import adamw


def make_loss_fn(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    remat = tc.remat != "none"

    def loss_fn(params, batch):
        return api.loss_fn(params, batch, cfg, remat=remat)

    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """(the loss, detached; its gradient for each leaf of ``params``, in
    leaf order).  The loss runs on aliases of the parameters that require
    grad, so the caller's tensors are left as they are."""
    leaves = T.leaves(params)
    alias = [t.detach().requires_grad_(t.is_floating_point())
             if isinstance(t, torch.Tensor) else t for t in leaves]
    with torch.enable_grad():
        loss = loss_fn(T.unflatten(params, alias), batch)
        wrt = [a for a in alias if isinstance(a, torch.Tensor)
               and a.requires_grad]
        it = iter(torch.autograd.grad(loss, wrt))
    return loss.detach(), [next(it) if isinstance(a, torch.Tensor)
                           and a.requires_grad else None for a in alias]


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """The reference's strided split: microbatch i holds rows i, i+n, ..."""
    return [{k: v[i::n] for k, v in batch.items()} for i in range(n)]


def accumulate_microbatch(loss_fn: Callable, params, mb, acc, n: int
                          ) -> torch.Tensor:
    """One microbatch of a step over ``n``: its gradients, over ``n``, are
    added into the f32 leaves ``acc`` in place; returns its loss over
    ``n`` (the reference's scan body)."""
    loss, grads = value_and_grad(loss_fn, params, mb)
    for a, g in zip(acc, grads, strict=True):
        a.add_(g.to(torch.float32) / n)
    return loss / n


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    metrics)``; the params and the state are updated in place
    (:func:`repro_torch.optim.adamw.adamw_update`), ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as device scalars."""
    loss_fn = make_loss_fn(cfg, tc)

    def train_step(params, opt_state, batch):
        if tc.microbatch and tc.microbatch > 1:
            n = tc.microbatch
            # zeros_like: a placed (DTensor) leaf gets its placements
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in T.leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=acc[0].device)
            for mb in _split_microbatches(batch, n):
                loss = loss + accumulate_microbatch(loss_fn, params, mb, acc,
                                                    n)
            grads = acc
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        params, state, metrics = adamw.adamw_update(
            params, T.unflatten(params, grads), opt_state, tc)
        return params, state, dict(metrics, loss=loss)

    return train_step
