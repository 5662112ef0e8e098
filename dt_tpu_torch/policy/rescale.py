"""The dynamic mini-batch arithmetic of ``dt_tpu/policy/rescale.py``, copied
because the port imports nothing of ``dt_tpu``.

Lin et al. (*Dynamic Mini-batch SGD for Elastic Distributed Training*,
arXiv:1904.12043) keep the effective update fixed while the worker set and
the per-worker batches change.  The scheduler, the client, the data layer
and the fit loop all take their integers from here, so every process of a
job computes the same ones:

- :func:`apportion`: largest-remainder split of an integer total over
  float weights (exact sum, lower index wins ties, a floor a part);
- :func:`weight_for_streak`: a worker's relative speed weight from its
  straggler-breach streak, ``max(shrink**streak, min_frac)``;
- :func:`share_units`: the journaled shares, integers summing to
  :data:`UNITS`;
- :func:`batch_map`: share units to per-worker batches for one global
  batch (``NDArrayIter(part_weights=...)`` shards with the same weights);
- :func:`grad_weight`: ``b_i * W / B``, the factor that makes the data
  plane's plain ``1/W`` average the fixed global batch's gradient;
- :func:`lr_scale`: the linear scaling ``B'/B`` of a realized global batch.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

#: resolution of the journaled share weights: shares ride the journal and
#: the barrier reply as integers summing to UNITS, so the control plane
#: never needs the training side's global batch
UNITS = 10000


def apportion(weights: Sequence[float], total: int,
              min_each: int = 1) -> List[int]:
    """Split integer ``total`` over ``weights`` by largest remainder: the
    parts sum exactly to ``total``, each is ``>= min_each``, equal weights
    split as evenly as possible (the remainder to the lowest indices), ties
    go to the lower index, and no randomness is involved."""
    n = len(weights)
    if n == 0:
        return []
    if total < min_each * n:
        raise ValueError(
            f"cannot apportion {total} over {n} parts with floor "
            f"{min_each}")
    s = float(sum(max(float(w), 0.0) for w in weights))
    if s <= 0.0:
        raw = [total / n] * n
    else:
        raw = [max(float(w), 0.0) / s * total for w in weights]
    out = [int(r) for r in raw]  # floors
    # the integer shortfall by largest fractional remainder, lower index
    # first on ties
    short = total - sum(out)
    order = sorted(range(n), key=lambda i: (-(raw[i] - out[i]), i))
    for i in order[:short]:
        out[i] += 1
    # the floor, taken from the largest parts (lowest index on ties)
    need = sum(max(min_each - v, 0) for v in out)
    out = [max(v, min_each) for v in out]
    while need > 0:
        j = max(range(n), key=lambda i: (out[i], -i))
        take = min(need, out[j] - min_each)
        if take <= 0:  # pragma: no cover - guarded by the total check
            raise ValueError("apportion floor unsatisfiable")
        out[j] -= take
        need -= take
    return out


def weight_for_streak(streak: int, shrink: float = 0.5,
                      min_frac: float = 0.25) -> float:
    """Relative speed weight of a worker with ``streak`` consecutive
    threshold breaches: a geometric shrink, floored so a slow worker keeps
    a useful share until it is evicted."""
    if streak <= 0:
        return 1.0
    return max(float(shrink) ** int(streak), float(min_frac))


def share_units(workers: Sequence[str], streaks: Mapping[str, int],
                shrink: float = 0.5, min_frac: float = 0.25
                ) -> Dict[str, int]:
    """Per-worker integer share weights summing to :data:`UNITS`, in the
    scheduler's rank order (``workers``), which also breaks ties."""
    if not workers:
        return {}
    parts = apportion(
        [weight_for_streak(streaks.get(h, 0), shrink, min_frac)
         for h in workers], UNITS, min_each=1)
    return {h: parts[i] for i, h in enumerate(workers)}


def batch_map(units: Optional[Mapping[str, int]], workers: Sequence[str],
              global_batch: int) -> Dict[str, int]:
    """Per-worker batches summing exactly to ``global_batch`` from the
    share units; a host missing from ``units`` (added after the decision)
    weighs the equal share.  Every worker derives the whole map from the
    same barrier reply."""
    if not workers:
        return {}
    units = units or {}
    default = UNITS / max(len(workers), 1)
    parts = apportion([float(units.get(h, default)) for h in workers],
                      int(global_batch), min_each=1)
    return {h: parts[i] for i, h in enumerate(workers)}


def grad_weight(batch: int, num_workers: int, global_batch: int) -> float:
    """``b_i * W / B``: worker *i*'s gradient pre-weight, so the plain
    ``1/W`` average equals ``sum(b_i / B * g_i)``, the fixed global batch's
    gradient however skewed the shares are."""
    if global_batch <= 0 or num_workers <= 0:
        return 1.0
    return float(batch) * float(num_workers) / float(global_batch)


def lr_scale(new_global_batch: int, base_global_batch: int) -> float:
    """The linear LR scaling ``B'/B`` for a realized global batch that
    departs from the configured one (1.0 under the fixed global batch,
    where the shares always re-apportion the same total)."""
    if base_global_batch <= 0:
        return 1.0
    return float(new_global_batch) / float(base_global_batch)
