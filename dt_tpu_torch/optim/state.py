"""Walk an optimizer state of the port (:mod:`dt_tpu_torch.optim`) by its
structure: the per-param slots, dicts keyed by the parameter names
(``mom``, ``a``, ``master``, lamb's ``"0"``/``mu`` ...), and the other
leaves (ints for the counts, numpy arrays for nadam's ``c`` and sgld's
key).  Every place the train state goes (checkpoints, the ``Trainer``
states file, snapshots, ZeRO-1) finds the slots this way, whatever the
optimizer.
"""

from __future__ import annotations

from typing import Any, Callable, Collection, Iterator, Mapping, Tuple

import numpy as np

Path = Tuple[str, ...]


def is_slot(node: Any, names: Collection[str]) -> bool:
    """Whether ``node`` is a per-param slot: a dict keyed by exactly the
    parameter names."""
    return isinstance(node, Mapping) and len(node) > 0 and \
        len(node) == len(names) and all(k in names for k in node)


def slots(state: Mapping, names: Collection[str], path: Path = ()
          ) -> Iterator[Tuple[Path, dict]]:
    """``(path, slot)`` of every per-param slot of ``state``, in its
    order."""
    for k, v in state.items():
        if is_slot(v, names):
            yield path + (k,), v
        elif isinstance(v, Mapping):
            yield from slots(v, names, path + (k,))


def leaves(state: Mapping, names: Collection[str]) -> Iterator[Any]:
    """Every leaf of ``state`` outside the per-param slots (the counts,
    nadam's ``c``, sgld's key), in its order."""
    for v in state.values():
        if is_slot(v, names):
            continue
        if isinstance(v, Mapping):
            yield from leaves(v, names)
        else:
            yield v


def map_state(state: Mapping, names: Collection[str],
              slot_fn: Callable[[Path, dict], Any],
              leaf_fn: Callable[[Any], Any] = lambda x: x,
              path: Path = ()) -> dict:
    """A new state: each per-param slot replaced by ``slot_fn(path,
    slot)``, every other leaf by ``leaf_fn(leaf)``; the nesting is
    kept."""
    out = {}
    for k, v in state.items():
        if is_slot(v, names):
            out[k] = slot_fn(path + (k,), v)
        elif isinstance(v, Mapping):
            out[k] = map_state(v, names, slot_fn, leaf_fn, path + (k,))
        else:
            out[k] = leaf_fn(v)
    return out


def export_leaf(v: Any) -> np.ndarray:
    """A non-slot leaf as the JAX state holds it: a count as a 0-d int32
    array (msgpack encodes it unlike a numpy scalar), a numpy leaf as a
    copy of itself."""
    if isinstance(v, (int, np.integer)):
        return np.asarray(v, np.int32)
    return np.array(v, copy=True)


def load_state(what: str, port: Mapping, src: Mapping,
               names: Collection[str],
               load_slot: Callable[[str, Mapping, dict], Any],
               where: str = "opt_state") -> dict:
    """A port state filled from ``src``, the JAX state dict of the same
    optimizer: ``port`` is the template (its structure decides which
    nodes are slots); each slot goes through ``load_slot(where, src_node,
    slot)``, a count becomes an int and a numpy leaf a copy in the
    template's dtype.  A key or shape that does not match raises."""
    if set(src) != set(port):
        raise KeyError(f"{what}: {where} has {sorted(src)}, the optimizer "
                       f"keeps {sorted(port)}")
    out = {}
    for k, v in port.items():
        at = f"{where}/{k}"
        if is_slot(v, names):
            out[k] = load_slot(at, src[k], v)
        elif isinstance(v, Mapping):
            if not isinstance(src[k], Mapping):
                raise KeyError(f"{what}: {at} is a leaf, the optimizer "
                               "keeps a subtree there")
            out[k] = load_state(what, v, src[k], names, load_slot, at)
        elif isinstance(v, (int, np.integer)):
            out[k] = int(np.asarray(src[k]))
        else:
            arr = np.array(src[k], dtype=v.dtype, copy=True)
            if arr.shape != v.shape:
                raise ValueError(f"{what}: {at} has shape {arr.shape}, the "
                                 f"optimizer keeps {v.shape}")
            out[k] = arr
    return out
