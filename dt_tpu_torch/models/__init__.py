"""Model zoo of the port (counterpart of ``dt_tpu/models/__init__.py``).

``create(name, **kwargs)`` takes the JAX package's network names.  The port
has the ResNets: resnet18/34/50/101/152[_v2] and the CIFAR resnet20/56/110
(also as resnet20_cifar etc.), and the language models ``transformer_lm``
and ``lstm_lm``; every other name raises ``NotImplementedError`` until its
slice lands.
"""

from typing import Any, Callable, Dict, Union

import torch

from dt_tpu_torch.config import resolve_device
from dt_tpu_torch.models.lstm_lm import LSTMLanguageModel as LSTMLanguageModel
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


def create(name: str, device: Union[str, torch.device] = "cuda", **kwargs):
    """Build a model by name on ``device`` (default ``"cuda"``; raises when
    there is no GPU unless ``device="cpu"``), in eval mode.  ``dtype`` is the
    compute dtype; the parameters are float32 (but for those the JAX model
    makes in ``dtype``) and trainable (``forward(x, training=True)``).  Its
    weights are zero and its norms at their initial values (scale 1,
    variance 1) until ``dt_tpu_torch.interchange.load_jax_variables``
    fills them."""
    dev = resolve_device(device)
    key = name.lower().replace("-", "_")
    if key == "transformer_lm_pipelined":
        raise NotImplementedError(
            "PipelinedTransformerLM comes with the parallel layer (ROADMAP "
            "slice 8)")
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs).to(dev).eval()
