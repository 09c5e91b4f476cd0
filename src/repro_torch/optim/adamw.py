"""AdamW + schedules + global-norm clipping, functional over a module's
parameters.

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(module.named_parameters())``).  :func:`update` returns new
parameter tensors and a new state and changes nothing in place; the
train step from :func:`make_train_step` copies the new values into the
module's parameters (in place, so the module keeps its tensors).
Optimizer moments are fp32 whatever the parameters' dtype, and the
update is the reference's exactly: ``delta = m̂/(sqrt(v̂)+eps) + wd·p``
with decay on every parameter, under warmup × cosine/linear/const.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32 scalar
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"         # cosine | linear | const


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or integer tensor), fp32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        decay = 1.0
    else:
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0, 1)
        if cfg.schedule == "linear":
            decay = 1.0 - frac
        else:  # cosine
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def global_norm(tensors: Tensors) -> torch.Tensor:
    total = sum(torch.sum(torch.square(x.to(torch.float32)))
                for x in tensors.values())
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def init(params: Tensors) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=zeros, nu={k: z.clone() for k, z in zeros.items()})


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Tensors, state: AdamWState,
           params: Tensors) -> Tuple[Tensors, AdamWState, dict]:
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    s = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, s)
    bc2 = 1.0 - torch.pow(b2, s)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        dev = p.device
        g32 = grads[k].to(torch.float32)
        m = b1 * state.mu[k] + (1 - b1) * g32
        v = b2 * state.nu[k] + (1 - b2) * torch.square(g32)
        mh = m / bc1.to(dev)
        vh = v / bc2.to(dev)
        p32 = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        new_p[k] = (p32 - lr.to(dev) * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), \
        {"lr": lr, "grad_norm": gnorm}


def make_train_step(loss_fn: Callable, cfg: AdamWConfig):
    """``loss_fn(model, batch) -> (loss, metrics)``.  Returns
    ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: gradients by ``torch.autograd``, then :func:`update`,
    whose new values are copied into the model's parameters."""

    def train_step(model: nn.Module, opt_state: AdamWState, batch):
        params = dict(model.named_parameters())
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        new_p, opt_state, om = update(cfg, dict(zip(params, grads)),
                                      opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_p[k])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        metrics["total_loss"] = loss.detach()
        return model, opt_state, metrics

    return train_step
