"""The largest-remainder apportionment of ``dt_tpu/policy/rescale.py:48``,
copied because the port imports nothing of ``dt_tpu``.

``data.io.NDArrayIter(part_weights=...)`` splits an epoch into contiguous
shards with it; the rest of the JAX module (share units, batch maps, the
gradient weight) belongs to the elastic slice (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from typing import List, Sequence


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
