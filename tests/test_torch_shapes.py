"""Shapes the port's tests share, and a check that they are the model's.

``RESNET50_BN_CHW`` is every distinct BatchNorm input of ResNet-50 v1 at
224x224 as (C, H, W), in the order of a forward; the kernel tests take
their shapes from it.  ``ZOO`` is one model a family of the classification
zoo with its input side, as the card tests and ``chip_smoke.py``'s zoo
phase run them.  ``DETECTORS`` are the detectors at the sizes the card
tests and the detection phase train them (name, input side, batch, model
keyword arguments), ``DETECTOR_BN_CHW`` every BatchNorm input of each as
(C, H, W), in the order of a forward.
"""

import torch

from dt_tpu_torch import models
from dt_tpu_torch.models.common import FusedBatchNorm
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

RESNET50_BN_CHW = [(64, 112, 112), (64, 56, 56), (256, 56, 56),
                   (128, 56, 56), (128, 28, 28), (512, 28, 28),
                   (256, 28, 28), (256, 14, 14), (1024, 14, 14),
                   (512, 14, 14), (512, 7, 7), (2048, 7, 7)]
ZOO = [("alexnet", 224), ("vgg16_bn", 224), ("squeezenet", 224),
       ("googlenet", 224), ("inception_bn", 224), ("inception_v3", 299),
       ("inception_v4", 299), ("inception_resnet_v2", 299),
       ("resnext50", 224), ("mobilenet", 224), ("mobilenet_v2", 224),
       ("densenet121", 224)]
DETECTORS = [("ssd", 300, 32, {"num_classes": 20}),
             ("faster_rcnn", 512, 8, {})]
DETECTOR_BN_CHW = {
    "ssd": [(32, 150, 150), (64, 75, 75), (128, 38, 38), (128, 19, 19),
            (128, 10, 10), (128, 5, 5), (128, 3, 3)],
    "faster_rcnn": [(32, 256, 256), (64, 128, 128), (128, 64, 64)]}


def test_resnet50_bn_shapes_are_the_models():
    """The list is what the port's ResNet-50 hands its 53 BatchNorms in one
    forward of a 224x224 image."""
    model = models.create("resnet50", device="cpu")
    seen = []

    def hook(mod, args):
        seen.append(tuple(args[0].shape[1:]))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, FusedBatchNorm)]
    with torch.inference_mode():
        model(torch.zeros(1, 224, 224, 3).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    assert len(seen) == 53
    assert list(dict.fromkeys(seen)) == RESNET50_BN_CHW


def test_detector_bn_shapes_are_the_models():
    """The lists are what each detector hands its BatchNorms (every one a
    ConvBN's, its ReLU fused in) in one forward at its input side."""
    for name, size, _, kw in DETECTORS:
        model = models.create(name, device="cpu", **kw)
        seen = []

        def hook(mod, args):
            seen.append((tuple(args[0].shape[1:]), mod.relu))

        hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
                 if isinstance(m, FusedBatchNorm)]
        with torch.inference_mode():
            model(torch.zeros(1, size, size, 3).permute(0, 3, 1, 2))
        for h in hooks:
            h.remove()
        assert seen == [(chw, True) for chw in DETECTOR_BN_CHW[name]], name
