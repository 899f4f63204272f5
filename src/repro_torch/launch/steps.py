"""Step builders (those of `repro.launch.steps`): the train step used by
`launch.train`, and the serving steps, prefill and cached decode.

Each step runs as well on parameters, optimizer state and inputs placed
as DTensors by the sharding plan (`distributed.sharding.distribute`):
the model's DTensor paths (`models.plan`) and the ZeRO-1 update
(`optim.adamw.apply_update`) take over there, and plain tensors met
along the way count as replicated (`plan.mesh_context`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import plan
from repro_torch.models.model import decode_step, forward, lm_loss
from repro_torch.optim import schedules
from repro_torch.optim.adamw import AdamWConfig, apply_update
from repro_torch.tree import leaves, tree_map, unflatten


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    schedule: str = "cosine", total_steps: int = 10_000):
    """step(params, opt_state, tokens, targets, frontend_embeds=None) ->
    (params, opt_state, metrics): the loss and its gradient, then one
    AdamW update in place. The schedule is read at the step count before
    the increment. A leaf the loss does not reach (a MoE's
    ``router_bias``, which only picks experts) gets a zero gradient, as
    the reference's."""
    sched = schedules.get(schedule)

    def train_step(params, opt_state, tokens, targets, frontend_embeds=None):
        with plan.mesh_context(params["embed"]):
            return step(params, opt_state, tokens, targets, frontend_embeds)

    def step(params, opt_state, tokens, targets, frontend_embeds):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss = lm_loss(live, cfg, tokens, targets, frontend_embeds)
            flat = leaves(live)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = unflatten(params, [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(flat, grads)])
        del live, flat
        scale = sched(opt_state["count"], total_steps)
        params, opt_state, metrics = apply_update(params, grads, opt_state,
                                                  opt, scale)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def _on(params, tokens) -> torch.Tensor:
    """`tokens` (a tensor or an array) on the device of `params` (a
    DTensor as it is)."""
    if plan.is_dtensor(tokens):
        return tokens
    return torch.as_tensor(tokens, device=params["embed"].device)


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None):
    """prefill(params, tokens, frontend_embeds=None) -> logits (no
    `cache_len`) or (logits, a decode cache of `cache_len` positions).
    Runs without autograd on the params' device (CUDA as `init_params`
    makes them, unless the caller made them elsewhere); tokens and
    frontend embeddings are moved there."""

    @torch.no_grad()
    def prefill(params, tokens, frontend_embeds=None):
        tokens = _on(params, tokens)
        if frontend_embeds is not None:
            frontend_embeds = _on(params, frontend_embeds)
        with plan.mesh_context(params["embed"]):
            if cache_len is None:
                return forward(params, cfg, tokens, frontend_embeds,
                               mode="train")
            return forward(params, cfg, tokens, frontend_embeds,
                           mode="prefill", cache_len=cache_len)

    return prefill


def make_decode_step(cfg: ModelConfig):
    """serve_step(params, token (B, 1), cache) -> (logits (B, 1, V),
    cache): `models.model.decode_step` without autograd, the cache
    updated in place."""

    @torch.no_grad()
    def serve_step(params, token, cache):
        with plan.mesh_context(params["embed"]):
            return decode_step(params, cfg, _on(params, token), cache)

    return serve_step
