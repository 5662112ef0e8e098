"""TrainState: the whole training state of one model (counterpart of
``dt_tpu/training/train_state.py``).

The JAX package keeps ``step``, ``params``, ``batch_stats`` and ``opt_state``
in one immutable pytree.  The port keeps the module, which holds the params
(f32 ``nn.Parameter``s) and the BN stats (buffers), beside ``step`` and the
optimizer's state (a nested dict as ``dt_tpu_torch.optim`` makes it:
counts, per-param slots by parameter name), and updates them in place: one
copy of each tensor on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn

from dt_tpu_torch.training.flat import FlatLayout


@dataclass
class TrainState:
    step: int                  # global update counter
    module: nn.Module          # params and batch_stats (buffers)
    opt_state: Dict[str, Any]  # e.g. {"count": int, "a": {name: tensor}}
    tx: Any                    # the optimizer (``optim.create``)
    layout: FlatLayout         # flat-vector order of params and stats
    # the ZeRO-1/FSDP plan over a mesh (``parallel.zero.ShardPlan``) when
    # the optimizer's slots or the params are held in slices; None: whole
    shards: Any = None

    @classmethod
    def create(cls, module: nn.Module, tx,
               bn_name: str = "BatchNorm") -> "TrainState":
        """``bn_name`` names the JAX package's BN modules for the flat
        vectors' order: ``"BatchNorm"`` (its default) or ``"FusedBatchNorm"``
        (``DT_PALLAS_BN=1``)."""
        return cls(step=0, module=module,
                   opt_state=tx.init(dict(module.named_parameters())),
                   tx=tx, layout=FlatLayout(module, bn_name))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_buffers())

    def apply_gradients(self, grads: Dict[str, torch.Tensor]
                        ) -> "TrainState":
        """One optimizer update from ``grads`` (by parameter name), in
        place; ``step`` goes up by one.  Returns ``self``."""
        self.opt_state = self.tx.update(grads, self.opt_state, self.params)
        self.step += 1
        return self
