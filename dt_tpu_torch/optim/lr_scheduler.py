"""LR schedulers with the reference's semantics (counterpart of
``dt_tpu/optim/lr_scheduler.py``).

A scheduler is a callable ``step -> lr`` in plain Python floats: the port
looks the LR up on the host once per update, where the JAX package computes
it inside the compiled step.  The optimizers call it with the 1-based update
count (:mod:`dt_tpu_torch.optim.optimizers`).
"""

from __future__ import annotations

import math
from typing import Sequence


class LRScheduler:
    """Base: warmup handling shared by all schedulers
    (reference ``LRScheduler.get_warmup_lr``)."""

    def __init__(self, base_lr: float = 0.01, warmup_steps: int = 0,
                 warmup_begin_lr: float = 0.0, warmup_mode: str = "linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise ValueError(f"warmup_mode {warmup_mode!r}")
        self.warmup_mode = warmup_mode

    def _warmup_lr(self, step: int) -> float:
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) / \
                max(self.warmup_steps, 1)
            return self.warmup_begin_lr + inc * step
        return self.warmup_begin_lr

    def _main_lr(self, step: int) -> float:
        raise NotImplementedError

    def __call__(self, step: int) -> float:
        step = int(step)
        if self.warmup_steps > 0 and step < self.warmup_steps:
            return float(self._warmup_lr(step))
        return float(self._main_lr(step))


class ConstantScheduler(LRScheduler):
    def _main_lr(self, step):
        return self.base_lr


def constant(base_lr: float, **kw) -> ConstantScheduler:
    return ConstantScheduler(base_lr, **kw)


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^(step // step_size), floored at stop_factor_lr.
    Reference: FactorScheduler."""

    def __init__(self, step: int, factor: float = 1.0,
                 stop_factor_lr: float = 1e-8, base_lr: float = 0.01, **kw):
        super().__init__(base_lr, **kw)
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _main_lr(self, step):
        # the reference drops only when num_update exceeds count + step
        # (strict >): the n-th drop lands at step*n + 1, not step*n
        n = max((step - 1) // self.step, 0)
        return max(self.base_lr * self.factor ** n, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """Drop by ``factor`` at each step in ``steps``.
    Reference: MultiFactorScheduler."""

    def __init__(self, steps: Sequence[int], factor: float = 1.0,
                 base_lr: float = 0.01, **kw):
        super().__init__(base_lr, **kw)
        if sorted(steps) != list(steps):
            raise ValueError("steps must be increasing")
        self.steps = list(steps)
        self.factor = factor

    def _main_lr(self, step):
        # strict >: the drop takes effect on the update AFTER the threshold
        n = sum(1 for s in self.steps if step > s)
        return self.base_lr * self.factor ** n


def _frac(step: int, warmup_steps: int, max_update: int) -> float:
    max_steps = max(max_update - warmup_steps, 1)
    return min(max((step - warmup_steps) / max_steps, 0.0), 1.0)


class PolyScheduler(LRScheduler):
    """Polynomial decay base_lr -> final_lr over max_update steps.
    Reference: PolyScheduler (pwr=2 default)."""

    def __init__(self, max_update: int, base_lr: float = 0.01,
                 final_lr: float = 0.0, pwr: int = 2, **kw):
        super().__init__(base_lr, **kw)
        self.max_update = max_update
        self.final_lr = final_lr
        self.pwr = pwr

    def _main_lr(self, step):
        frac = _frac(step, self.warmup_steps, self.max_update)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1.0 - frac) ** self.pwr


class CosineScheduler(LRScheduler):
    """Cosine decay base_lr -> final_lr over max_update steps.
    Reference: CosineScheduler."""

    def __init__(self, max_update: int, base_lr: float = 0.01,
                 final_lr: float = 0.0, **kw):
        super().__init__(base_lr, **kw)
        self.max_update = max_update
        self.final_lr = final_lr

    def _main_lr(self, step):
        frac = _frac(step, self.warmup_steps, self.max_update)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1.0 + math.cos(math.pi * frac)) / 2.0


def make(name: str, **kwargs) -> LRScheduler:
    """Factory from config (the JAX package's ``LRSchedulerConfig.name``)."""
    table = {
        "constant": ConstantScheduler,
        "factor": FactorScheduler,
        "multifactor": MultiFactorScheduler,
        "poly": PolyScheduler,
        "cosine": CosineScheduler,
    }
    if name not in table:
        raise ValueError(f"unknown scheduler {name!r}; known: {sorted(table)}")
    return table[name](**kwargs)
