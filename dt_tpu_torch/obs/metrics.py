"""The training-health gates of ``dt_tpu/obs/metrics.py:55-103``, copied
since the port imports nothing of ``dt_tpu``: ``DT_METRICS`` arms the
metrics plane, ``DT_HEALTH_HALT`` the halt on a non-finite gradient, and
either arms the sentinels ``Module`` and ``Trainer`` compute a step.

The plane itself (gauges, histograms, the exposition) is ROADMAP Queue 1
item 7; the port only reads the gates.
"""

from __future__ import annotations

import os
from typing import Optional

_ENABLED_OVERRIDE: Optional[bool] = None


def _flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true")


def enabled() -> bool:
    """Whether the metrics plane is on (``DT_METRICS=1`` or
    :func:`set_enabled`)."""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    return _flag("DT_METRICS")


def set_enabled(on: Optional[bool]) -> None:
    """Process-local override (``None`` follows the env var again)."""
    global _ENABLED_OVERRIDE
    _ENABLED_OVERRIDE = on


class HealthHalt(RuntimeError):
    """A training-health sentinel tripped with ``DT_HEALTH_HALT=1``: the
    step's update was not applied and training must stop.  ``Module.fit``
    stops on it by itself; ``Trainer.step`` raises it to the caller."""


def halt_enabled() -> bool:
    """``DT_HEALTH_HALT=1``: a non-finite gradient stops training before
    the poisoned update is applied (read at each fit, not cached)."""
    return _flag("DT_HEALTH_HALT")


def sentinels_enabled() -> bool:
    """Whether the steps compute the health vector: the metrics plane or
    the halt gate is armed."""
    return enabled() or halt_enabled()
