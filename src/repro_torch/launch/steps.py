"""The train step used by `launch.train` (the training form of
`repro.launch.steps`)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import lm_loss
from repro_torch.optim import schedules
from repro_torch.optim.adamw import AdamWConfig, apply_update
from repro_torch.tree import leaves, tree_map, unflatten


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    schedule: str = "cosine", total_steps: int = 10_000):
    """step(params, opt_state, tokens, targets) -> (params, opt_state,
    metrics): the loss and its gradient, then one AdamW update in place.
    The schedule is read at the step count before the increment."""
    sched = schedules.get(schedule)

    def train_step(params, opt_state, tokens, targets):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss = lm_loss(live, cfg, tokens, targets)
            grads = torch.autograd.grad(loss, leaves(live))
        del live
        grads = unflatten(params, grads)
        scale = sched(opt_state["count"], total_steps)
        params, opt_state, metrics = apply_update(params, grads, opt_state,
                                                  opt, scale)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step

