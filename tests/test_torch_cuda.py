"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one.  This file imports
neither JAX nor ``dt_tpu`` (the card's machine has no JAX), so it runs there
without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from dt_tpu_torch import models
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 64, 112, 112), (32, 2048, 7, 7),
                                   (3, 3, 5, 7), (37, 3), (1001, 64)])
def test_bn_kernel_matches_plain_bitwise(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    if x.dim() == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    c = shape[1]
    gamma, beta, mean = (torch.randn(c, generator=g, device=cuda)
                         for _ in range(3))
    var = torch.rand(c, generator=g, device=cuda) + 0.5
    scale, bias = kernels.bn_scale_bias(gamma, beta, mean, var, 1e-5, dtype)
    for relu in (False, True):
        before = kernels.bn_act.launches
        got = kernels.fused_bn_inference(x, gamma, beta, mean, var,
                                         relu=relu)
        assert kernels.bn_act.launches == before + 1
        assert got.stride() == x.stride()
        want = kernels.bn_act_plain(kernels.rows_view(x), scale, bias, relu)
        torch.cuda.synchronize()
        assert torch.equal(kernels.rows_view(got), want)


def test_resnet_on_card_matches_cpu(cuda):
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    cpu = models.create("resnet18", device="cpu", num_classes=10)
    variables = export_jax_variables(cpu)

    def perturb(tree):  # running means away from zero
        for k, v in tree.items():
            if k == "mean":
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif isinstance(v, dict):
                perturb(v)

    perturb(variables["batch_stats"])
    load_jax_variables(cpu, variables)
    card = load_jax_variables(
        models.create("resnet18", device=cuda, num_classes=10), variables)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3))
                         .astype(np.float32)).permute(0, 3, 1, 2)
    before = kernels.bn_act.launches
    with torch.inference_mode():
        got = card(x.to(cuda)).cpu()
        want = cpu(x)
    assert kernels.bn_act.launches - before == 20  # resnet18 v1: 20 BNs
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
