"""Monitor: statistics of the layer outputs of a forward pass
(counterpart of ``dt_tpu/training/monitor.py``; reference
``python/mxnet/monitor.py``).

Every forward through :meth:`Monitor.forward` hooks each submodule; on the
steps the interval selects, each output whose name matches ``pattern`` is
reduced by ``stat_func`` (default ``|x|.mean()`` in f32) and queued.  A
name is the module's path with ``/`` and a ``/__call__`` suffix, the
whole model's output being ``__call__``: the names of the JAX Monitor's
captured intermediates, since the port's submodules carry the JAX models'
names.
"""

from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional, Tuple

import torch

logger = logging.getLogger("dt_tpu_torch")


def _default_stat(x: torch.Tensor) -> torch.Tensor:
    """|x|.mean(), the reference's default 'norm' stat."""
    return x.float().abs().mean()


class Monitor:
    def __init__(self, interval: int = 1,
                 stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        self.interval = max(interval, 1)
        self.stat_func = stat_func or _default_stat
        self.pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.queue: List[Tuple[int, str, float]] = []

    def forward(self, model: torch.nn.Module, *args, **kwargs):
        """``model(*args, **kwargs)``, its layer outputs collected on the
        interval's steps; returns the model's output."""
        step = self.step + 1
        collect = step % self.interval == 0
        handles = []
        if collect:
            for path, mod in model.named_modules():
                name = (path.replace(".", "/") + "/__call__") if path \
                    else "__call__"
                handles.append(mod.register_forward_hook(
                    lambda m, a, out, name=name: self._collect(out, name,
                                                               step)))
        try:
            out = model(*args, **kwargs)
        finally:
            for h in handles:
                h.remove()
        self.step = step
        return out

    def _collect(self, out, name: str, step: int) -> None:
        if isinstance(out, (tuple, list)):
            for v in out:
                self._collect(v, name, step)
            return
        if not isinstance(out, torch.Tensor) or \
                not self.pattern.search(name):
            return
        try:
            with torch.no_grad():
                stat = float(self.stat_func(out.detach()))
        except Exception:
            return
        self.queue.append((step, name, stat))

    def toc_print(self):
        """Log and clear the collected stats (reference
        ``Monitor.toc_print``)."""
        entries = sorted(self.queue) if self.sort else self.queue
        for step, name, stat in entries:
            logger.info("Batch: %7d %30s %.6g", step, name, stat)
        out, self.queue = entries, []
        return out
