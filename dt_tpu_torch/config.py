"""Device selection for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  Without a GPU they
raise unless the caller asked for ``"cpu"``: the port never falls back to the
CPU quietly (the counterpart of ``maybe_force_cpu`` in ``dt_tpu/config.py``,
which only moves to the CPU when asked).
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to "
                               "run on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
