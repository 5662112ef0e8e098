"""The port's training step against the JAX package's on ResNet-50 v1, the
main path's model, at 64x64x3, 10 classes, 4 images (see
``test_torch_train.py`` for what is compared and the tolerances).  A file of
its own so that each file stays well under a minute on one worker.
"""

import pytest

from test_torch_train import _one_torch_thread  # noqa: F401 (fixture)
from test_torch_train import _run


@pytest.mark.parametrize("dtype,fused", [
    ("float32", True), ("bfloat16", True), ("float32", False)])
def test_two_steps_match_bench_train_step(dtype, fused):
    _run("resnet50", dtype, fused)
