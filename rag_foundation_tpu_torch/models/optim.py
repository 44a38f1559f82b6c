"""The optax pieces the JAX training code uses, with optax's semantics.

- ``adamw`` / ``adam``: ``torch.optim.AdamW`` / ``Adam`` with optax's
  defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0; adamw's weight decay
  1e-4, where torch's default is 1e-2). Each returns a factory: called
  with a list of parameter leaves it builds the optimizer, whose state
  (the moments and the step count) is PyTorch's counterpart of optax's
  ``opt_state``. The learning rate may be a schedule of the update count,
  evaluated as optax does: the n-th update (from 0) uses
  ``schedule(n)``.
- ``clip_by_global_norm_``: optax's ``clip_by_global_norm`` in place;
  gradients are left alone below ``max_norm`` and scaled by
  ``max_norm / norm`` from it up (no ``+1e-6`` in the denominator, as
  ``torch.nn.utils.clip_grad_norm_`` has).
- ``warmup_cosine_decay_schedule``: optax's piecewise definition.

torch's AdamW is optax's ``adamw`` in another order of operations:
``p * (1 - lr*wd) - lr * m_hat / (sqrt(v_hat) + eps)`` against optax's
``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``. Both update a
parameter in its own dtype (moments of a bf16 parameter in bf16, as
optax's ``zeros_like(params)``).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import torch

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]
OptimizerFactory = Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]


def _factory(cls, learning_rate: LearningRate, **kwargs) -> OptimizerFactory:
    def build(params: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
        if not callable(learning_rate):
            return cls(list(params), lr=learning_rate, **kwargs)
        opt = cls(list(params), lr=float(learning_rate(0)), **kwargs)
        count = 0

        def advance(optimizer, args, kw) -> None:
            nonlocal count
            count += 1
            for group in optimizer.param_groups:
                group["lr"] = float(learning_rate(count))

        opt.register_step_post_hook(advance)
        return opt

    return build


def adamw(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerFactory:
    """``optax.adamw``'s defaults on ``torch.optim.AdamW``."""
    return _factory(torch.optim.AdamW, learning_rate, betas=(b1, b2),
                    eps=eps, weight_decay=weight_decay)


def adam(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OptimizerFactory:
    """``optax.adam``'s defaults on ``torch.optim.Adam``."""
    return _factory(torch.optim.Adam, learning_rate, betas=(b1, b2),
                    eps=eps)


@torch.no_grad()
def clip_by_global_norm_(params: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale the ``.grad`` of ``params`` in place as optax's
    ``clip_by_global_norm`` scales its updates: unchanged while the global
    norm is below ``max_norm``, else ``g / norm * max_norm`` in each
    gradient's dtype. Returns the global norm (f32, on the device; no host
    sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps`` (which counts the warmup), then
    ``end_value``."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"the cosine decay needs positive decay_steps - "
                         f"warmup_steps, got {cosine_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule
