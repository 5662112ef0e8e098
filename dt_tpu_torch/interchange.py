"""Carry the variables of a ``dt_tpu`` model into the port's module and back.

Counterpart of the layout rules of ``dt_tpu/interchange.py:60-128``.  A
JAX-side variable path names the port tensor directly, because the port's
models name their submodules as the JAX models are auto-named
(``BottleneckV1_3/Conv_1/kernel`` is ``BottleneckV1_3.Conv_1.weight``):

- ``params`` go to the module's parameters, ``batch_stats`` to its buffers;
- only a leaf named ``kernel`` changes layout: a conv ``kernel`` (HWIO)
  becomes ``weight`` (OIHW, kept channels_last), a dense ``kernel`` ``(in,
  out)`` becomes ``weight`` ``(out, in)``;
- every other leaf copies as it is, whatever its rank: BatchNorm and
  LayerNorm ``scale``/``bias``/``mean``/``var``, an ``embedding`` ``(V,
  D)``, a ``pos_embed`` ``(max_len, D)``, the LSTM's ``l<i>_wx`` ``(I,
  4H)``, ``l<i>_wh`` ``(H, 4H)`` and ``l<i>_b``;
- a copy keeps the port tensor's dtype, which is the JAX leaf's: float32,
  or bfloat16 for a leaf the JAX model makes in its compute dtype (the bf16
  TransformerLM's ``pos_embed``); a bfloat16 leaf comes in as numpy's
  ``bfloat16`` (the JAX arrays' own) or as a ``torch.bfloat16`` tensor and
  goes out as a ``torch.bfloat16`` tensor (numpy has no bfloat16 of its
  own);
- ``FusedBatchNorm_<i>`` (the JAX name under ``DT_PALLAS_BN=1``) and
  ``BatchNorm_<i>`` (the default) both name the port's ``BatchNorm_<i>``;
- the MoE leaves ``moe/router/kernel`` (a dense kernel) and ``moe/wi``,
  ``moe/wo`` (3-D, not kernels, copied as they are) need no rule of their
  own; an expert-parallel rank's ``wi``/``wo`` hold rows ``[lo, lo + n)``
  of the JAX leaf (the parameter's ``jax_rows = (lo, total)``), which a
  load cuts out and an export gives as they are;
- a module with ``jax_local_tree``/``jax_global_tree`` maps its JAX
  subtree to and from the port's names: ``PipelinedTransformerLM`` cuts its
  stage-stacked ``{"outer", "stages"}`` tree into the stages the process
  holds (a stage rank takes its slice of the leading axis) and stacks them
  again on the way out.

A leaf with no port tensor, a port tensor left unfilled, a tensor filled
twice and a shape mismatch all raise.  ``load_jax_train_state`` and
``export_jax_train_state`` carry a whole train state (step, params, BN stats
and the optimizer's state) the same way.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from dt_tpu_torch.optim.state import export_leaf, load_state, map_state

_FUSED_BN = re.compile(r"^FusedBatchNorm_(\d+)$")
_BN = re.compile(r"^BatchNorm_(\d+)$")
BN_NAMES = ("BatchNorm", "FusedBatchNorm")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple, Any]:
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def jax_path(name: str, bn_name: str = "BatchNorm") -> Tuple[str, ...]:
    """The JAX variable path of the port tensor ``name``
    (``BottleneckV1_3.BatchNorm_0.scale`` -> ``("BottleneckV1_3",
    "FusedBatchNorm_0", "scale")`` for ``bn_name="FusedBatchNorm"``)."""
    if bn_name not in BN_NAMES:
        raise ValueError(f"bn_name must be one of {BN_NAMES}, got "
                         f"{bn_name!r}")
    parts = [_BN.sub(bn_name + r"_\1", p) for p in name.split(".")]
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def to_jax_layout(t: torch.Tensor, leaf: str) -> torch.Tensor:
    """The view in the JAX layout of the port tensor for the JAX leaf named
    ``leaf``: a ``kernel``'s conv OIHW as HWIO and dense ``(out, in)`` as
    ``(in, out)``; any other leaf as it is."""
    if leaf != "kernel":
        return t
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    if t.dim() == 2:
        return t.t()
    return t


def from_jax_layout(t: torch.Tensor, leaf: str) -> torch.Tensor:
    """The inverse of :func:`to_jax_layout` (a ``kernel``'s HWIO -> OIHW,
    (in, out) -> (out, in); any other leaf as it is)."""
    if leaf != "kernel":
        return t
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    if t.dim() == 2:
        return t.t()
    return t


def _port_name(path: Tuple[str, ...]) -> str:
    parts = [_FUSED_BN.sub(r"BatchNorm_\1", p) for p in path]
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


#: the numpy-only form of a bfloat16 leaf where numpy has no bfloat16
#: (:func:`numpy_tree`): its bits under a field the dtype names
BF16_BITS = np.dtype([("bfloat16", "<u2")])


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16" or arr.dtype == BF16_BITS:
        # the JAX arrays' numpy bfloat16, or its bits (numpy_tree)
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def numpy_tree(tree: Mapping) -> Dict[str, Any]:
    """``tree`` (an exported state) with every ``torch.bfloat16`` leaf as
    numpy, so the tree pickles without torch (a published snapshot): as
    ``ml_dtypes.bfloat16``, the JAX arrays' own dtype, where that package
    is installed (a JAX joiner restores it as it restores a JAX worker's),
    else as :data:`BF16_BITS`, the same bits under a structured dtype,
    which the port restores bit for bit and ``jax.device_put`` refuses
    with a ``TypeError`` naming it."""
    try:
        import ml_dtypes
        bf16 = np.dtype(ml_dtypes.bfloat16)
    except ImportError:
        bf16 = BF16_BITS

    def conv(v):
        if isinstance(v, Mapping):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().contiguous().view(torch.int16).numpy() \
                .view(bf16).copy()
        return v
    return conv(tree)


def _subtree_map(module: nn.Module, tree: Mapping, hook: str) -> Mapping:
    """``tree`` with each module's ``hook`` (``jax_local_tree`` or
    ``jax_global_tree``) applied to the subtree at that module's path."""
    for name, sub in module.named_modules():
        fn = getattr(sub, hook, None)
        path = name.split(".") if name else []
        node = tree
        for k in path:
            node = node.get(k) if isinstance(node, Mapping) else None
        if fn is None or node is None:
            continue
        new = fn(node)
        if not path:
            tree = new
            continue
        tree = dict(tree)
        parent = tree
        for k in path[:-1]:
            parent[k] = dict(parent[k])
            parent = parent[k]
        parent[path[-1]] = new
    return tree


def _load_tree(what: str, coll: str, tree: Mapping,
               targets: Dict[str, torch.Tensor]) -> None:
    """Copy every leaf of the JAX-side ``tree`` into the port tensor it
    names, in place; a leaf with no tensor, a tensor filled twice or left
    unfilled, and a shape mismatch raise."""
    filled = set()
    with torch.no_grad():
        for path, leaf in _flatten(tree).items():
            name = _port_name(path)
            where = f"{coll}/{'/'.join(path)}"
            if name not in targets:
                raise KeyError(f"{what}: no port tensor for {where} (looked "
                               f"for {name!r})")
            if name in filled:
                raise KeyError(f"{what}: {where} fills {name!r} a second "
                               "time")
            src = from_jax_layout(_to_tensor(leaf), path[-1])
            rows = getattr(targets[name], "jax_rows", None)
            if rows is not None and src.shape[0] == rows[1]:
                src = src[rows[0]:rows[0] + targets[name].shape[0]]
            if tuple(src.shape) != tuple(targets[name].shape):
                raise ValueError(
                    f"{what}: {where} has shape {tuple(src.shape)} in port "
                    f"layout, {name!r} is {tuple(targets[name].shape)}")
            targets[name].copy_(src)
            filled.add(name)
    missing = [f"{coll}:{n}" for n in targets if n not in filled]
    if missing:
        raise KeyError(f"{what}: {len(missing)} port tensors left unfilled, "
                       f"e.g. {missing[:5]}")


def load_jax_variables(module: nn.Module,
                       variables: Mapping[str, Mapping]) -> nn.Module:
    """Fill ``module`` from ``{"params": ..., "batch_stats": ...}``, nested
    dicts of arrays as the JAX package gives them (numpy, or torch tensors
    for bf16 leaves read from a checkpoint).  Copies keep each port
    tensor's dtype, device and memory format.  Returns ``module``."""
    # ``aux_loss`` is what a MoE layer sowed while the JAX model was
    # initialized: a value of that forward, not a variable
    extra = set(variables) - {"params", "batch_stats", "aux_loss"}
    if extra:
        raise KeyError(f"load_jax_variables: unknown collections "
                       f"{sorted(extra)}")
    _load_tree("load_jax_variables", "params",
               _subtree_map(module, variables.get("params", {}),
                            "jax_local_tree"),
               dict(module.named_parameters()))
    _load_tree("load_jax_variables", "batch_stats",
               variables.get("batch_stats", {}), dict(module.named_buffers()))
    return module


def export_jax_variables(module: nn.Module) -> Dict[str, Dict]:
    """The inverse of :func:`load_jax_variables`: the module's tensors as
    float32 numpy (bfloat16 ones as ``torch.bfloat16`` tensors) in the JAX
    package's layout and default names (``BatchNorm_<i>``)."""
    return {"params": _subtree_map(module, _jax_tree(
        module.named_parameters()), "jax_global_tree"),
            "batch_stats": _jax_tree(module.named_buffers())}


def _jax_tree(named, bn_name: str = "BatchNorm") -> Dict[str, Any]:
    """Port tensors by name -> a nested dict in the JAX layout and names:
    float32 numpy, and bfloat16 tensors as ``torch.bfloat16`` CPU tensors."""
    out: Dict[str, Any] = {}
    for name, t in named:
        *parents, leaf = jax_path(name, bn_name)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        t = to_jax_layout(t.detach().cpu(), leaf).contiguous()
        # a copy: a CPU tensor's .numpy() would alias the live one
        node[leaf] = t.clone() if t.dtype == torch.bfloat16 else \
            t.float().numpy().copy()
    return out


def load_jax_train_state(state, snapshot: Mapping[str, Any]):
    """Fill a ``training.train_state.TrainState`` from a JAX train-state
    snapshot, ``{"step", "params", "batch_stats", "opt_state"}`` in the
    state-dict form the JAX package publishes (``module.py:1235-1251``);
    ``opt_state`` is ``to_state_dict`` of the same optimizer's JAX state:
    each per-param slot (``mom``, ``a``, ``master``, ``inner/b``,
    ``0/mu`` ...) loads as its param does, the counts and the other
    leaves (nadam's ``c``, sgld's key) as they are.  Returns ``state``."""
    extra = set(snapshot) - {"step", "params", "batch_stats", "opt_state"}
    if extra:
        raise KeyError(f"load_jax_train_state: unknown keys {sorted(extra)}")
    load_jax_variables(state.module, {"params": snapshot["params"],
                                      "batch_stats": snapshot["batch_stats"]})
    names = set(dict(state.module.named_parameters()))

    def load_slot(where, node, slot):
        _load_tree("load_jax_train_state", where,
                   _subtree_map(state.module, node, "jax_local_tree"), slot)
        return slot

    state.opt_state = load_state("load_jax_train_state", state.opt_state,
                                 snapshot["opt_state"], names, load_slot)
    state.step = int(np.asarray(snapshot["step"]))
    return state


def export_jax_train_state(state, bn_name: str = "BatchNorm"
                           ) -> Dict[str, Any]:
    """The inverse of :func:`load_jax_train_state`: ``{"step", "params",
    "batch_stats", "opt_state"}`` as float32 numpy (``step`` and ``count``
    0-d int32 arrays; bfloat16 params as ``torch.bfloat16`` tensors) in the JAX
    package's layout, its BN modules named ``bn_name``
    (``"BatchNorm"``, the JAX default, or ``"FusedBatchNorm"``)."""
    return export_jax_tree(state.step, state.module.named_parameters(),
                           state.module.named_buffers(), state.opt_state,
                           bn_name, module=state.module)


def export_jax_tree(step: int, params, buffers, opt_state: Mapping,
                    bn_name: str = "BatchNorm",
                    module: nn.Module = None) -> Dict[str, Any]:
    """:func:`export_jax_train_state` from its parts: ``(name, tensor)``
    pairs of the params and the BN stats, and the optimizer state (a
    checkpoint's host copy is exported this way); each per-param slot of
    the state takes its param's names and layout, ``module``'s
    ``jax_global_tree`` hooks, when given, map the params and the slots
    back to the JAX tree."""
    params = list(params)

    def tree(named):
        t = _jax_tree(named, bn_name)
        return t if module is None else \
            _subtree_map(module, t, "jax_global_tree")

    opt = map_state(opt_state, {n for n, _ in params},
                    lambda path, slot: tree(slot.items()), export_leaf)
    # 0-d arrays, as the JAX package's state holds them (msgpack encodes
    # a 0-d array and a numpy scalar differently)
    return {"step": np.asarray(step, np.int32),
            "params": tree(params),
            "batch_stats": _jax_tree(buffers, bn_name),
            "opt_state": opt}
