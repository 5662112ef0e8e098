"""Model zoo of the port (counterpart of ``dt_tpu/models/__init__.py``).

``create(name, **kwargs)`` takes the JAX package's network names.  The port
has ``mlp`` and ``lenet``, the ResNets: resnet18/34/50/101/152[_v2] and the
CIFAR resnet20/56/110 (also as resnet20_cifar etc.), and the language models
``transformer_lm`` and ``lstm_lm``; every other name raises
``NotImplementedError`` until its slice lands.  ``init_params(module,
seed)`` gives a model the initial weights linen's defaults give the JAX
model, drawn from a seeded ``torch.Generator``.
"""

import re
from typing import Any, Callable, Dict, Union

import torch

from dt_tpu_torch import initializer
from dt_tpu_torch.config import resolve_device
from dt_tpu_torch.interchange import from_jax_layout, jax_path, to_jax_layout
from dt_tpu_torch.models.lenet import LeNet as LeNet
from dt_tpu_torch.models.lstm_lm import LSTMLanguageModel as LSTMLanguageModel
from dt_tpu_torch.models.mlp import MLP as MLP
from dt_tpu_torch.models.resnet import CifarResNet as CifarResNet
from dt_tpu_torch.models.resnet import ResNet as ResNet
from dt_tpu_torch.models.transformer import TransformerLM as TransformerLM

_REGISTRY: Dict[str, Callable[..., Any]] = {}
for _d in (18, 34, 50, 101, 152):
    _REGISTRY[f"resnet{_d}"] = lambda d=_d, **kw: ResNet(depth=d, version=1,
                                                         **kw)
    _REGISTRY[f"resnet{_d}_v2"] = lambda d=_d, **kw: ResNet(depth=d,
                                                            version=2, **kw)
for _d in (20, 56, 110):
    _REGISTRY[f"resnet{_d}"] = lambda d=_d, **kw: CifarResNet(depth=d, **kw)
    _REGISTRY[f"resnet{_d}_cifar"] = _REGISTRY[f"resnet{_d}"]
_REGISTRY["transformer_lm"] = TransformerLM
_REGISTRY["lstm_lm"] = LSTMLanguageModel
_REGISTRY["mlp"] = MLP
_REGISTRY["lenet"] = LeNet


def create(name: str, device: Union[str, torch.device] = "cuda", **kwargs):
    """Build a model by name on ``device`` (default ``"cuda"``; raises when
    there is no GPU unless ``device="cpu"``), in eval mode.  ``dtype`` is the
    compute dtype; the parameters are float32 (but for those the JAX model
    makes in ``dtype``) and trainable (``forward(x, training=True)``).  Its
    weights are zero and its norms at their initial values (scale 1,
    variance 1) until :func:`init_params` draws them or
    ``dt_tpu_torch.interchange.load_jax_variables`` fills them."""
    dev = resolve_device(device)
    key = name.lower().replace("-", "_")
    if key == "transformer_lm_pipelined":
        raise NotImplementedError(
            "PipelinedTransformerLM comes with the parallel layer (ROADMAP "
            "Queue 1 item 6)")
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs).to(dev).eval()


_LSTM_W = re.compile(r"^l\d+_w[xh]$")


def _default_init(leaf: str, shape, hidden: int):
    """linen's default for the JAX leaf ``leaf`` of the JAX-layout
    ``shape``: ``kernel`` lecun-normal (truncated normal, fan-in),
    ``embedding`` normal 1/sqrt(D) (``linen.Embed``), ``pos_embed``
    normal(0.02) (``dt_tpu/models/transformer.py:146, 297``), the LSTM's
    ``l<i>_wx``/``l<i>_wh`` uniform +-1/sqrt(H) and ``l<i>_b`` zeros
    (``dt_tpu/models/lstm_lm.py:39-53``), ``scale`` ones, every ``bias``
    zeros."""
    if leaf == "kernel":
        return initializer.lecun_normal()
    if leaf == "embedding":
        return initializer.embed_normal()
    if leaf == "pos_embed":
        return initializer.normal(0.02)
    if _LSTM_W.match(leaf):
        return initializer.uniform(1.0 / float(hidden) ** 0.5)
    if leaf == "scale":
        return initializer.ones()
    if leaf == "bias" or re.match(r"^l\d+_b$", leaf):
        return initializer.zeros()
    raise KeyError(f"init_params: no default initializer for leaf {leaf!r}")


@torch.no_grad()
def init_params(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Draw ``module``'s parameters as linen's defaults draw the JAX model's
    (see :func:`_default_init`) and set its BatchNorm running stats to mean
    0, variance 1.  The draws come from a CPU ``torch.Generator`` seeded
    with ``seed``, in the order of ``named_parameters``, each in the JAX
    layout, then copied into the parameter (in place, keeping its device,
    dtype and memory format), so a model on the card and one on the CPU get
    the same values.  They are not the JAX package's values (the RNG
    streams differ), only their distributions.  Returns ``module``."""
    gen = torch.Generator().manual_seed(int(seed))
    hidden = getattr(module, "hidden", 1)
    for name, p in module.named_parameters():
        leaf = jax_path(name)[-1]
        shape = tuple(to_jax_layout(p, leaf).shape)
        value = _default_init(leaf, shape, hidden)(gen, shape, torch.float32)
        p.copy_(from_jax_layout(value, leaf))
    for name, b in module.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "mean":
            b.zero_()
        elif leaf == "var":
            b.fill_(1.0)
        else:
            raise KeyError(f"init_params: unknown buffer {name!r}")
    return module
