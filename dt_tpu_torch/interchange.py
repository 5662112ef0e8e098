"""Carry the variables of a ``dt_tpu`` model into the port's module and back.

Counterpart of the layout rules of ``dt_tpu/interchange.py:60-128``.  A
JAX-side variable path names the port tensor directly, because the port's
models name their submodules as the JAX models are auto-named
(``BottleneckV1_3/Conv_1/kernel`` is ``BottleneckV1_3.Conv_1.weight``):

- ``params`` go to the module's parameters, ``batch_stats`` to its buffers;
- a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW, kept channels_last);
- a dense ``kernel`` ``(in, out)`` becomes ``weight`` ``(out, in)``;
- BatchNorm ``scale``/``bias``/``mean``/``var`` copy as they are;
- ``FusedBatchNorm_<i>`` (the JAX name under ``DT_PALLAS_BN=1``) and
  ``BatchNorm_<i>`` (the default) both name the port's ``BatchNorm_<i>``.

A leaf with no port tensor, a port tensor left unfilled, a tensor filled
twice and a shape mismatch all raise.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_FUSED_BN = re.compile(r"^FusedBatchNorm_(\d+)$")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple, Any]:
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _port_name(path: Tuple[str, ...]) -> str:
    parts = [_FUSED_BN.sub(r"BatchNorm_\1", p) for p in path]
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.array(leaf, copy=True))


def _port_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    if name.endswith(".weight") and t.dim() == 4:
        return t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if name.endswith(".weight") and t.dim() == 2:
        return t.t()  # (in, out) -> (out, in)
    return t


def load_jax_variables(module: nn.Module,
                       variables: Mapping[str, Mapping]) -> nn.Module:
    """Fill ``module`` from ``{"params": ..., "batch_stats": ...}``, nested
    dicts of arrays as the JAX package gives them (numpy, or torch tensors
    for bf16 leaves read from a checkpoint).  Copies keep each port
    tensor's dtype, device and memory format.  Returns ``module``."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"load_jax_variables: unknown collections "
                       f"{sorted(extra)}")
    targets = {"params": dict(module.named_parameters()),
               "batch_stats": dict(module.named_buffers())}
    filled = set()
    with torch.no_grad():
        for coll, tree in variables.items():
            for path, leaf in _flatten(tree).items():
                name = _port_name(path)
                where = f"{coll}/{'/'.join(path)}"
                if name not in targets[coll]:
                    raise KeyError(f"load_jax_variables: no port tensor for "
                                   f"{where} (looked for {name!r})")
                if (coll, name) in filled:
                    raise KeyError(f"load_jax_variables: {where} fills "
                                   f"{name!r} a second time")
                src = _port_layout(name, _to_tensor(leaf))
                dst = targets[coll][name]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"load_jax_variables: {where} has shape "
                        f"{tuple(src.shape)} in port layout, {name!r} is "
                        f"{tuple(dst.shape)}")
                dst.copy_(src)
                filled.add((coll, name))
    missing = [f"{coll}:{name}" for coll, ts in targets.items()
               for name in ts if (coll, name) not in filled]
    if missing:
        raise KeyError(f"load_jax_variables: {len(missing)} port tensors "
                       f"left unfilled, e.g. {missing[:5]}")
    return module


def export_jax_variables(module: nn.Module) -> Dict[str, Dict]:
    """The inverse of :func:`load_jax_variables`: the module's tensors as
    float32 numpy in the JAX package's layout and default names
    (``BatchNorm_<i>``)."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for coll, named in (("params", module.named_parameters()),
                        ("batch_stats", module.named_buffers())):
        for name, t in named:
            parts = name.split(".")
            t = t.detach().float().cpu()
            if parts[-1] == "weight" and t.dim() in (2, 4):
                parts[-1] = "kernel"
                t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.t()
            node = out[coll]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t.contiguous().numpy()
    return out
