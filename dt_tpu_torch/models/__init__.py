"""Model zoo of the port (counterpart of ``dt_tpu/models/__init__.py``).

``create(name, **kwargs)`` takes the JAX package's network names, ``-``
folded to ``_`` (``inception-v3`` works): ``lenet``, ``mlp``, ``alexnet``,
``vgg11/13/16/19[_bn]``, ``resnet18/34/50/101/152[_v2]``, the CIFAR
``resnet20/56/110`` (also as ``resnet20_cifar`` etc.), ``inception_v3``,
``inception_bn``, ``inception_v4``, ``inception_resnet_v2``,
``googlenet``, ``resnext50/101/152``, ``mobilenet[_v2]``,
``densenet121/161/169/201``, ``squeezenet``, and the language models
``transformer_lm``, ``transformer_lm_pipelined`` and ``lstm_lm``, and the
detectors ``ssd`` and ``faster_rcnn`` (``faster-rcnn``), with their losses
and detection stages (``ssd_loss``, ``ssd_detect``, ``rcnn_loss``,
``rcnn_detect``).  A name neither package registers raises
``NotImplementedError``.
``init_params(module, seed)`` gives a model the initial weights linen's
defaults give the JAX model, drawn from a seeded ``torch.Generator``.
Image models take ``in_channels`` (3); AlexNet and VGG also take
``image_size`` (224), which sizes their first dense layer
(:func:`takes_image_size`).
"""

import inspect
import re
from typing import Any, Dict, Tuple, Union

import torch

from dt_tpu_torch import initializer
from dt_tpu_torch.config import resolve_device
from dt_tpu_torch.interchange import from_jax_layout, jax_path, to_jax_layout
from dt_tpu_torch.models.alexnet import AlexNet as AlexNet
from dt_tpu_torch.models.densenet import DenseNet as DenseNet
from dt_tpu_torch.models.googlenet import GoogLeNet as GoogLeNet
from dt_tpu_torch.models.inception import InceptionV3 as InceptionV3
from dt_tpu_torch.models.inception_resnet_v2 import (
    InceptionResNetV2 as InceptionResNetV2)
from dt_tpu_torch.models.inception_v4 import InceptionBN as InceptionBN
from dt_tpu_torch.models.inception_v4 import InceptionV4 as InceptionV4
from dt_tpu_torch.models.lenet import LeNet as LeNet
from dt_tpu_torch.models.lstm_lm import LSTMLanguageModel as LSTMLanguageModel
from dt_tpu_torch.models.mlp import MLP as MLP
from dt_tpu_torch.models.mobilenet import MobileNetV1 as MobileNetV1
from dt_tpu_torch.models.mobilenet import MobileNetV2 as MobileNetV2
from dt_tpu_torch.models.rcnn import FasterRCNNMini as FasterRCNNMini
from dt_tpu_torch.models.rcnn import rcnn_detect as rcnn_detect
from dt_tpu_torch.models.rcnn import rcnn_loss as rcnn_loss
from dt_tpu_torch.models.resnet import CifarResNet as CifarResNet
from dt_tpu_torch.models.resnet import ResNet as ResNet
from dt_tpu_torch.models.resnext import ResNeXt as ResNeXt
from dt_tpu_torch.models.squeezenet import SqueezeNet as SqueezeNet
from dt_tpu_torch.models.ssd import SSD as SSD
from dt_tpu_torch.models.ssd import ssd_detect as ssd_detect
from dt_tpu_torch.models.ssd import ssd_loss as ssd_loss
from dt_tpu_torch.models.transformer import (
    PipelinedTransformerLM as PipelinedTransformerLM)
from dt_tpu_torch.models.transformer import TransformerLM as TransformerLM
from dt_tpu_torch.models.vgg import VGG as VGG

#: name -> (class, the keyword arguments the name fixes)
_REGISTRY: Dict[str, Tuple[type, Dict[str, Any]]] = {
    "lenet": (LeNet, {}), "mlp": (MLP, {}), "alexnet": (AlexNet, {}),
    "inception_v3": (InceptionV3, {}), "googlenet": (GoogLeNet, {}),
    "inception_bn": (InceptionBN, {}), "inception_v4": (InceptionV4, {}),
    "inception_resnet_v2": (InceptionResNetV2, {}),
    "mobilenet": (MobileNetV1, {}), "mobilenet_v2": (MobileNetV2, {}),
    "squeezenet": (SqueezeNet, {}), "lstm_lm": (LSTMLanguageModel, {}),
    "transformer_lm": (TransformerLM, {}),
    "transformer_lm_pipelined": (PipelinedTransformerLM, {}),
    "ssd": (SSD, {}), "faster_rcnn": (FasterRCNNMini, {}),
}
for _d in (11, 13, 16, 19):
    _REGISTRY[f"vgg{_d}"] = (VGG, {"depth": _d, "batch_norm": False})
    _REGISTRY[f"vgg{_d}_bn"] = (VGG, {"depth": _d, "batch_norm": True})
for _d in (18, 34, 50, 101, 152):
    _REGISTRY[f"resnet{_d}"] = (ResNet, {"depth": _d, "version": 1})
    _REGISTRY[f"resnet{_d}_v2"] = (ResNet, {"depth": _d, "version": 2})
for _d in (20, 56, 110):
    _REGISTRY[f"resnet{_d}"] = (CifarResNet, {"depth": _d})
    _REGISTRY[f"resnet{_d}_cifar"] = _REGISTRY[f"resnet{_d}"]
for _d in (50, 101, 152):
    _REGISTRY[f"resnext{_d}"] = (ResNeXt, {"depth": _d})
for _d in (121, 161, 169, 201):
    _REGISTRY[f"densenet{_d}"] = (DenseNet, {"depth": _d})


def _entry(name: str) -> Tuple[type, Dict[str, Any]]:
    key = name.lower().replace("-", "_")
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"unknown model {name!r}: neither this package nor the JAX "
            f"package registers it; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def takes_image_size(name: str) -> bool:
    """Whether the model ``name`` sizes a layer from ``image_size`` (the
    input side, as an int or ``(h, w)``): AlexNet and VGG, whose first
    dense layer reads the flattened last pool."""
    cls, _ = _entry(name)
    return "image_size" in inspect.signature(cls).parameters


def create(name: str, device: Union[str, torch.device] = "cuda", **kwargs):
    """Build a model by name on ``device`` (default ``"cuda"``; raises when
    there is no GPU unless ``device="cpu"``), in eval mode.  ``dtype`` is the
    compute dtype; the parameters are float32 (but for those the JAX model
    makes in ``dtype``) and trainable (``forward(x, training=True)``).  Its
    weights are zero and its norms at their initial values (scale 1,
    variance 1) until :func:`init_params` draws them or
    ``dt_tpu_torch.interchange.load_jax_variables`` fills them."""
    dev = resolve_device(device)
    cls, fixed = _entry(name)
    return cls(**fixed, **kwargs).to(dev).eval()


_LSTM_W = re.compile(r"^l\d+_w[xh]$")


def _default_init(leaf: str, shape, hidden: int):
    """linen's default for the JAX leaf ``leaf`` of the JAX-layout
    ``shape``: ``kernel`` and the MoE experts' ``wi``/``wo`` lecun-normal
    (truncated normal, fan-in; ``dt_tpu/parallel/moe.py:95-98``),
    ``embedding`` normal 1/sqrt(D) (``linen.Embed``), ``pos_embed``
    normal(0.02) (``dt_tpu/models/transformer.py:146, 297``), the LSTM's
    ``l<i>_wx``/``l<i>_wh`` uniform +-1/sqrt(H) and ``l<i>_b`` zeros
    (``dt_tpu/models/lstm_lm.py:39-53``), ``scale`` ones, every ``bias``
    zeros."""
    if leaf in ("kernel", "wi", "wo"):
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
    streams differ), only their distributions.  A parameter that holds rows
    ``[lo, lo + n)`` of a JAX leaf of ``total`` rows (``jax_rows = (lo,
    total)``: an expert-parallel rank's experts) draws the whole leaf and
    keeps its rows, so every rank draws alike.  Returns ``module``."""
    gen = torch.Generator().manual_seed(int(seed))
    hidden = getattr(module, "hidden", 1)
    for name, p in module.named_parameters():
        leaf = jax_path(name)[-1]
        shape = tuple(to_jax_layout(p, leaf).shape)
        rows = getattr(p, "jax_rows", None)
        if rows is not None:
            shape = (rows[1],) + shape[1:]
        value = _default_init(leaf, shape, hidden)(gen, shape, torch.float32)
        if rows is not None:
            value = value[rows[0]:rows[0] + p.shape[0]]
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
