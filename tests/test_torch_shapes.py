"""Shapes the port's tests share, and a check that they are the model's.

``RESNET50_BN_CHW`` is every distinct BatchNorm input of ResNet-50 v1 at
224x224 as (C, H, W), in the order of a forward; the kernel tests take
their shapes from it.
"""

import torch

from dt_tpu_torch import models
from dt_tpu_torch.models.common import FusedBatchNorm
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

RESNET50_BN_CHW = [(64, 112, 112), (64, 56, 56), (256, 56, 56),
                   (128, 56, 56), (128, 28, 28), (512, 28, 28),
                   (256, 28, 28), (256, 14, 14), (1024, 14, 14),
                   (512, 14, 14), (512, 7, 7), (2048, 7, 7)]


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
