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


def _qkv_card(dev, b, s, h, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(b, s, h, d, generator=g, device=dev) * 0.5)
            .to(dtype) for _ in range(3)]


def _flash_plain(q, k, v, causal):
    from dt_tpu_torch.ops import attention as TA
    b, _, h, d = q.shape
    out3, lse = TA.flash_attention_plain(TA._to3(q), TA._to3(k), TA._to3(v),
                                         scale=d ** -0.5, causal=causal)
    return TA._from3(out3, b, h), lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", [(3, 128, 2, 32), (1, 384, 3, 64),
                                     (2, 256, 1, 128), (1, 100, 2, 64)])
def test_flash_kernel_matches_plain(cuda, b, s, h, d, causal, dtype):
    """Out and lse against the plain version (f32 sums in another order:
    out 2e-5 in f32, one bf16 ulp of the largest |out| in bf16; lse 1e-5),
    two launches bit-identical; S = 100 is a ragged key tile."""
    from dt_tpu_torch.ops import attention as TA
    q, k, v = _qkv_card(cuda, b, s, h, d, dtype, seed=s + d)
    before = TA.flash_fwd.launches
    out, lse = TA.flash_fwd(q, k, v, scale=d ** -0.5, causal=causal)
    out2, lse2 = TA.flash_fwd(q, k, v, scale=d ** -0.5, causal=causal)
    assert TA.flash_fwd.launches == before + 2
    want, want_lse = _flash_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert out.dtype == dtype and lse.shape == (b * h, s)
    tol = 2e-5 if dtype == torch.float32 else \
        2.0 ** -7 * float(want.float().abs().max())
    assert float((out.float() - want.float()).abs().max()) <= tol
    assert float((lse - want_lse).abs().max()) <= 1e-5


def test_flash_kernel_reads_strided_heads(cuda):
    """q, k, v as the transformer hands them: strided views of one qkv
    buffer, read without a copy."""
    from dt_tpu_torch.ops import attention as TA
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, 256, 3 * 128, generator=g, device=cuda)
    q, k, v = (t.reshape(2, 256, 2, 64) for t in qkv.split(128, dim=-1))
    assert not q.is_contiguous()
    out, lse = TA.flash_fwd(q, k, v, scale=0.125, causal=True)
    want, want_lse = _flash_plain(q, k, v, True)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= 2e-5
    assert float((lse - want_lse).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="head dims"):
        TA.flash_fwd(*(t[..., :48] for t in (q, k, v)), scale=1.0,
                     causal=True)


@pytest.mark.parametrize("c_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", [(32, 200), (33, 650), (1, 7)])
def test_lstm_kernel_matches_plain(cuda, b, h, c_dtype):
    """h and c against the plain version within a few ulps (expf/tanhf
    against PyTorch's own: 1e-6 absolute, one bf16 ulp for a bf16 c), two
    launches bit-identical; odd B and H."""
    g = torch.Generator(device=cuda).manual_seed(b * h)
    gates = torch.randn(b, 4 * h, generator=g, device=cuda) * 2
    c = torch.randn(b, h, generator=g, device=cuda).to(c_dtype)
    before = kernels.lstm_point.launches
    h1, c1 = kernels.lstm_point(gates, c)
    h2, c2 = kernels.lstm_point(gates, c)
    assert kernels.lstm_point.launches == before + 2
    ph, pc = kernels.lstm_pointwise_plain(gates, c)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2) and torch.equal(c1, c2)
    assert h1.dtype == torch.float32 and c1.dtype == c_dtype
    assert float((h1 - ph).abs().max()) <= 1e-6
    ctol = 1e-6 if c_dtype == torch.float32 else \
        2.0 ** -7 * float(pc.float().abs().max())
    assert float((c1.float() - pc.float()).abs().max()) <= ctol


def test_lm_steps_on_card_match_cpu(cuda):
    """One f32 step of each LM on the card against the port on the CPU,
    from the same weights (TF32 off): loss 1e-5, gradient 1e-4 of its
    norm; the kernels ran once per layer (flash) and per step and layer
    (LSTM)."""
    from dt_tpu_torch import optim
    from dt_tpu_torch.ops import attention as TA
    from dt_tpu_torch.training.step import (BPTTLoss, grad_step,
                                            next_token_loss)
    from dt_tpu_torch.training.train_state import TrainState
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    cases = [("transformer_lm", dict(vocab_size=64, embed_dim=64,
                                     num_layers=2, num_heads=2, max_len=256,
                                     seq_parallel="flash"),
              lambda: next_token_loss, rng.randint(0, 64, (2, 200)), None,
              (TA.flash_fwd, 2)),
             ("lstm_lm", dict(vocab_size=50, embed_dim=16, hidden=24,
                              num_layers=2, dropout=0.0),
              BPTTLoss, rng.randint(0, 50, (7, 3)),
              rng.randint(0, 50, (7, 3)), (kernels.lstm_point, 14))]
    for name, kw, make_loss, x, y, (wrapper, launches) in cases:
        cpu = models.create(name, device="cpu", **kw)
        variables = export_jax_variables(cpu)

        def fill(tree):
            for key, val in tree.items():
                if isinstance(val, dict):
                    fill(val)
                else:
                    tree[key] = rng.normal(0, 0.3, tuple(val.shape)) \
                        .astype(np.float32)

        fill(variables["params"])
        got = {}
        for dev in ("cpu", cuda):
            m = load_jax_variables(models.create(name, device=dev, **kw),
                                   variables)
            ts = TrainState.create(m, optim.create("sgd", learning_rate=0.1))
            xt = torch.from_numpy(x).long().to(dev)
            yt = None if y is None else torch.from_numpy(y).long().to(dev)
            before = wrapper.launches
            flat_g, _, loss, _ = grad_step(ts, xt, yt, make_loss())
            got[str(dev)] = (float(loss), flat_g.cpu())
            if str(dev) == "cuda":
                assert wrapper.launches - before == launches
        (l_cpu, g_cpu), (l_card, g_card) = got["cpu"], got["cuda"]
        assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
        assert float((g_card - g_cpu).norm() / g_cpu.norm()) <= 1e-4
