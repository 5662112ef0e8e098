"""The scheduler-side policy engine (counterpart of
``dt_tpu/policy/engine.py:1-182``, copied since the port imports nothing of
the JAX package).

Inputs: the data plane's per-worker round-lag EWMAs (the straggler board of
``elastic.dataplane``).  Outputs: dynamic mini-batch shares (shrink a
straggler's batch, keep the global batch, weight the gradients through
:mod:`~dt_tpu_torch.policy.rescale`), evictions of chronic stragglers
through the host_worker file and the membership diff (the reference's EC2
lifecycle daemon, ``tools/launch.py:88-235``), and scale proposals toward
``DT_POLICY_TARGET_WORKERS``.

:meth:`PolicyEngine.decide` is pure: no clock, no RNG, no side effect, so
the same inputs give the same decision and the decision log is
reproducible.  Its durable state (streaks, shares, the log) lives in the
scheduler's journaled ``ControlState`` (the ``policy_decide`` op).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Set

from dt_tpu_torch import config
from dt_tpu_torch.policy import rescale


@dataclasses.dataclass(frozen=True)
class Decision:
    """One epoch's policy decision (the scheduler journals it as a
    ``policy_decide`` op when it changes anything)."""

    epoch: int
    #: workers whose round-lag EWMA reached the threshold this epoch
    breached: List[str]
    #: the whole post-decision streak map, zero streaks left out
    streaks: Dict[str, int]
    #: chronic stragglers to drop from host_worker before the diff
    evict: List[str]
    #: proposals for the launcher or operator, ``{"kind": "scale_up",
    #: "want": n}`` or ``{"kind": "scale_down", "host": h}``
    proposals: List[dict]
    #: linear LR scale (B'/B); 1.0 under the fixed global batch
    lr_scale: float = 1.0


class PolicyEngine:
    """Deterministic decision rules over the straggler board.

    ``threshold_ms``: the EWMA lag at or above which a worker breaches.
    ``shrink``/``min_frac``: the shrink schedule
    (:func:`~dt_tpu_torch.policy.rescale.weight_for_streak`).
    ``evict_after``: consecutive breaches before a non-base worker is
    evicted (0: never).  ``target_workers``: the autoscale target (0: no
    proposals)."""

    def __init__(self, threshold_ms: float = 500.0, shrink: float = 0.5,
                 min_frac: float = 0.25, evict_after: int = 0,
                 target_workers: int = 0):
        self.threshold_ms = float(threshold_ms)
        self.shrink = float(shrink)
        self.min_frac = float(min_frac)
        self.evict_after = int(evict_after)
        self.target_workers = int(target_workers)

    @classmethod
    def from_env(cls) -> "PolicyEngine":
        """From the ``DT_POLICY*`` rows of ``config.ENV_REGISTRY``; the
        threshold defaults to ``DT_STRAGGLER_MS``."""
        thr = config.env("DT_POLICY_STRAGGLER_MS")
        return cls(
            threshold_ms=float(thr) if thr
            else float(config.env("DT_STRAGGLER_MS")),
            shrink=float(config.env("DT_POLICY_SHRINK")),
            min_frac=float(config.env("DT_POLICY_MIN_FRAC")),
            evict_after=int(config.env("DT_POLICY_EVICT_AFTER")),
            target_workers=int(config.env("DT_POLICY_TARGET_WORKERS")
                               or 0))

    def decide(self, epoch: int, workers: Sequence[str], base: Set[str],
               streaks: Mapping[str, int],
               scores: Mapping[str, float]) -> Decision:
        """The decision at one epoch barrier.  ``workers``: the rank-
        ordered live set before the membership diff; ``streaks``: the
        journaled breach streaks; ``scores``: the live round-lag EWMAs
        (ms).  Base workers are never evicted (the reference's base
        protection, ``README.md:54-61``): a chronically breaching one
        keeps its floored share."""
        if not scores:
            # no lag signal (a job's first barrier, or a successor after a
            # failover whose unjournaled board saw no round yet): hold the
            # journaled streaks, or a failover would revert a rebalance
            breached: List[str] = []
            new_streaks = {h: int(s) for h, s in streaks.items()
                           if h in set(workers) and int(s) > 0}
        else:
            breached = sorted(h for h in workers
                              if scores.get(h, 0.0) >= self.threshold_ms)
            # streaks saturate: past the floored weight and the eviction
            # point a larger number says nothing, and an uncapped one
            # would journal a decision every epoch for an
            # eviction-protected straggler
            cap = max(self.evict_after, 8)
            new_streaks = {}
            for h in workers:
                s = min(int(streaks.get(h, 0)) + 1, cap) \
                    if h in breached else 0
                if s:
                    new_streaks[h] = s
        evict = sorted(
            h for h, s in new_streaks.items()
            if self.evict_after and s >= self.evict_after
            and h not in base)
        proposals: List[dict] = []
        survivors = [h for h in workers if h not in evict]
        if self.target_workers:
            if len(survivors) < self.target_workers:
                proposals.append({"kind": "scale_up",
                                  "want": self.target_workers
                                  - len(survivors)})
            elif len(survivors) > self.target_workers:
                # the slowest non-base worker; equal scores go to the last
                # in rank order (the last joined leaves first)
                cands = [h for h in survivors if h not in base]
                if cands:
                    slowest = max(
                        cands, key=lambda h: (scores.get(h, 0.0),
                                              list(workers).index(h)))
                    proposals.append({"kind": "scale_down",
                                      "host": slowest})
        return Decision(epoch=int(epoch), breached=breached,
                        streaks=new_streaks, evict=evict,
                        proposals=proposals, lr_scale=1.0)

    def shares(self, workers: Sequence[str],
               streaks: Mapping[str, int]) -> Dict[str, int]:
        """Share units over the final (post-diff) rank-ordered workers, so
        an evicted host never holds a share."""
        return rescale.share_units(workers, streaks,
                                   shrink=self.shrink,
                                   min_frac=self.min_frac)


def enabled() -> bool:
    """Whether the policy engine is on in this process (``DT_POLICY=1``)."""
    return config.env("DT_POLICY").strip().lower() in ("1", "true")
