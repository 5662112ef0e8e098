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


def _bn_input(shape, dtype, dev, misaligned=False):
    g = torch.Generator(device=dev).manual_seed(1)
    numel = int(np.prod(shape))
    flat = (torch.randn(numel + 1, generator=g, device=dev) + 0.5).to(dtype)
    if len(shape) == 4:
        n, c, h, w = shape
        return flat[:numel].view(n, h, w, c).permute(0, 3, 1, 2)
    return (flat[1:] if misaligned else flat[:numel]).view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,misaligned", [
    ((32, 64, 112, 112), False), ((32, 2048, 7, 7), False),
    ((3, 3, 5, 7), False), ((37, 3), False), ((1001, 17), False),
    ((1001, 64), True)])
def test_bn_train_kernels_match_plain(cuda, shape, misaligned, dtype):
    """Pass 1 against its plain version (f32 sums in another order: 1e-5 of
    E[x^2]), bit-identical across two launches; pass 2 (y) bit-equal to
    ``bn_act_plain`` with scale and bias from the kernel's mean and var."""
    x = _bn_input(shape, dtype, cuda, misaligned)
    c = shape[1]
    gamma = torch.rand(c, device=cuda) + 0.5
    beta = torch.randn(c, device=cuda)
    rm, rv = torch.zeros(c, device=cuda), torch.ones(c, device=cuda)
    before = kernels.bn_stats.launches
    mean, var = kernels.bn_stats(x)
    mean2, var2 = kernels.bn_stats(x)
    assert kernels.bn_stats.launches == before + 2
    x2 = kernels.rows_view(x)
    pm, pv = kernels.bn_stats_plain(x2)
    torch.cuda.synchronize()
    assert torch.equal(mean, mean2) and torch.equal(var, var2)
    ex2 = float((x2.float() ** 2).mean(0).max())
    torch.testing.assert_close(mean, pm, rtol=0, atol=1e-5 * ex2)
    torch.testing.assert_close(var, pv, rtol=0, atol=1e-5 * ex2)
    y, _, _ = kernels.fused_bn_train(x, gamma, beta, rm, rv, relu=True)
    scale, bias = kernels.bn_scale_bias(gamma, beta, mean, var, 1e-5, dtype)
    want = kernels.bn_act_plain(x2, scale, bias, True)
    torch.cuda.synchronize()
    assert torch.equal(kernels.rows_view(y), want)
    torch.testing.assert_close(rm, 0.1 * mean)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, (1 << 20) + 5])
def test_quantize_kernels_match_plain_bitwise(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    grad = torch.randn(n, generator=g, device=cuda) * 0.6
    resid = torch.randn(n, generator=g, device=cuda) * 0.2
    if n >= 16:
        grad[:8] = torch.tensor([0.5, -0.5, 0.0, -0.0, float("inf"),
                                 -float("inf"), float("nan"), 0.5])
        resid[:8] = torch.tensor([0.0, 0.0, 0.0, -0.0, 1.0, 1.0, 0.0, -1e-8])
    for offset in (0, 1) if n > 1 else (0,):  # 1: not 16-byte aligned
        gi, ri = grad[offset:], resid[offset:]
        words, res = kernels.quantize_2bit(gi, ri, 0.5)
        pw, pr = kernels.quantize_2bit_plain(gi, ri, 0.5)
        out = kernels.dequantize_2bit(words, gi.numel(), 0.5)
        pout = kernels.dequantize_2bit_plain(words, gi.numel(), 0.5)
        torch.cuda.synchronize()
        assert torch.equal(words, pw)
        assert torch.equal(res.view(torch.int32), pr.view(torch.int32))
        assert torch.equal(out.view(torch.int32), pout.view(torch.int32))


def test_train_two_steps_on_card_match_cpu(cuda):
    """Two f32 steps of resnet20 on the card against the port on the CPU
    from the same state (TF32 off): the forward's results tight, the
    gradient to 5e-2 of its norm (a ReLU mask may flip where the two
    devices' rounding differs, as in ``tests/test_torch_train.py``)."""
    from dt_tpu_torch import optim
    from dt_tpu_torch.interchange import (export_jax_train_state,
                                          load_jax_train_state)
    from dt_tpu_torch.training.step import apply_step, grad_step
    from dt_tpu_torch.training.train_state import TrainState
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    states = {}
    for dev in ("cpu", cuda):
        m = models.create("resnet20", device=dev, num_classes=10)
        states[str(dev)] = TrainState.create(m, optim.create(
            "sgd", learning_rate=0.1, momentum=0.9, weight_decay=1e-4))
    cpu, card = states["cpu"], states["cuda"]
    variables = export_jax_variables(cpu.module)

    def he_normal(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                he_normal(v)
            elif k == "kernel":
                tree[k] = rng.normal(0, np.sqrt(2.0 / np.prod(v.shape[:-1])),
                                     v.shape).astype(np.float32)

    he_normal(variables["params"])
    load_jax_variables(cpu.module, variables)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3))
                         .astype(np.float32)).permute(0, 3, 1, 2)
    y = torch.from_numpy(rng.randint(0, 10, 4))
    for _ in range(2):
        load_jax_train_state(card, export_jax_train_state(cpu))
        before = (kernels.bn_stats.launches, kernels.bn_act.launches)
        g_card, s_card, l_card, _ = grad_step(card, x.to(cuda), y.to(cuda))
        assert (kernels.bn_stats.launches - before[0],
                kernels.bn_act.launches - before[1]) == (19, 19)
        g_cpu, s_cpu, l_cpu, _ = grad_step(cpu, x, y)
        apply_step(card, g_card, s_card)
        apply_step(cpu, g_cpu, s_cpu)
        torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=1e-5, atol=0)
        torch.testing.assert_close(s_card.cpu(), s_cpu, rtol=1e-4, atol=1e-5)
        rel = (g_card.cpu() - g_cpu).norm() / g_cpu.norm()
        assert rel < 5e-2, rel
