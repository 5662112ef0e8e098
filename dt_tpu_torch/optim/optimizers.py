"""Optimizers with the reference's update rules (counterpart of
``dt_tpu/optim/optimizers.py``).

This slice ports ``sgd``; every other name of the JAX registry raises
``NotImplementedError`` until its slice.  An optimizer has ``init(params)``
and ``update(grads, state, params)``, as the JAX package's optax
transformations do, but ``update`` applies the step to ``params`` (and the
momentum) in place and returns only the new state: the port keeps one copy
of each tensor on the card.  ``params``, ``grads`` and the state's ``mom``
are dicts by parameter name.  Do not swap in ``torch.optim.SGD``: its
momentum buffer holds ``sum(g)``, not ``sum(lr * g)``, which is another rule
once the LR changes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

ScalarOrSchedule = Union[float, Callable[[int], float]]
Tensors = Dict[str, torch.Tensor]


def _lr_at(lr: ScalarOrSchedule, count: int) -> float:
    """Schedules receive the reference's 1-based ``num_update`` (mxnet
    increments the count before the lr lookup), not the 0-based count
    (``optimizers.py:32-37``)."""
    return float(lr(count + 1)) if callable(lr) else float(lr)


class SGD:
    """SGD with momentum, ``mom = momentum*mom - lr*(g + wd*w); w += mom``
    (``optimizers.py:90-118``), after the reference's gradient pipeline
    rescale -> clip -> ``+ wd*w`` (``:40-48``), all in f32; a param that is
    not f32 gets the update cast to its dtype.  Without
    momentum, ``w += -lr*g``.  Each step is a few multi-tensor (``_foreach``)
    ops over all parameters, rounded op by op as the JAX rule is."""

    def __init__(self, learning_rate: ScalarOrSchedule = 0.01,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 rescale_grad: float = 1.0,
                 clip_gradient: Optional[float] = None):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient

    def init(self, params: Tensors) -> dict:
        """``{"count": 0}``, and ``"mom"``, f32 zeros like ``params``, when
        there is momentum (the JAX ``CountState``/``MomentumState``)."""
        if self.momentum == 0.0:
            return {"count": 0}
        return {"count": 0, "mom": {
            k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors) -> dict:
        names = list(params)
        ws = [params[k] for k in names]
        lr = _lr_at(self.learning_rate, state["count"])
        g = [grads[k].float() for k in names]
        g = torch._foreach_mul(g, self.rescale_grad)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        if self.weight_decay:
            torch._foreach_add_(g, torch._foreach_mul(
                [w.float() for w in ws], self.weight_decay))
        if self.momentum == 0.0:
            torch._foreach_add_(ws, _in_dtypes(torch._foreach_mul(g, -lr),
                                               ws))
            return {"count": state["count"] + 1}
        mom = [state["mom"][k] for k in names]
        torch._foreach_mul_(mom, self.momentum)
        torch._foreach_sub_(mom, torch._foreach_mul(g, lr))
        torch._foreach_add_(ws, _in_dtypes(mom, ws))
        return {"count": state["count"] + 1, "mom": state["mom"]}


def _in_dtypes(updates, ws):
    """The f32 updates, each cast to its param's dtype first where that is
    not f32 (a bf16 ``pos_embed``), as the JAX rule casts the update to
    ``w.dtype`` before ``w + u`` (``optimizers.py:107, 113-114``)."""
    return [u if u.dtype == w.dtype else u.to(w.dtype)
            for u, w in zip(updates, ws)]


def sgd(learning_rate: ScalarOrSchedule = 0.01, momentum: float = 0.0,
        weight_decay: float = 0.0, rescale_grad: float = 1.0,
        clip_gradient: Optional[float] = None) -> SGD:
    return SGD(learning_rate, momentum, weight_decay, rescale_grad,
               clip_gradient)


_REGISTRY: Dict[str, Callable[..., SGD]] = {"sgd": sgd}
# the JAX package's other optimizers, each for a later slice
_NOT_PORTED = ("nag", "adam", "adagrad", "rmsprop", "adadelta", "ftrl",
               "adamax", "nadam", "signum", "signsgd", "ftml", "sgld",
               "dcasgd", "lbsgd", "lamb")


def create(name: str, multi_precision: bool = False, **kwargs) -> SGD:
    """Create an optimizer by name (reference ``mx.optimizer.create``).
    The port's params are f32 masters already (a bf16 step casts them per
    call), so ``multi_precision`` is not needed and raises until the
    optimizers that would use it are ported."""
    key = name.lower()
    if key in _NOT_PORTED or multi_precision:
        raise NotImplementedError(
            f"optimizer {name!r}" + (" with multi_precision"
                                     if multi_precision else "")
            + f" is not ported yet; ported: {sorted(_REGISTRY)}")
    if key not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)
