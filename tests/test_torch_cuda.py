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
from test_torch_shapes import RESNET50_BN_CHW

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


# every BatchNorm input of ResNet-50 v1 at 224x224, batch 32
RESNET50_BN = [(32, c, h, w) for c, h, w in RESNET50_BN_CHW]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,misaligned", [
    ((32, 64, 112, 112), False), ((32, 2048, 7, 7), False),
    ((3, 3, 5, 7), False), ((37, 3), False), ((1001, 17), False),
    ((1001, 64), True)] + [(s, False) for s in RESNET50_BN[1:-1]])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_stats_replays_in_a_cuda_graph(cuda, dtype):
    """20 calls on different inputs captured in one CUDA graph and replayed
    twice: every result bit-equal to the eager launch's, so the kernel's
    tickets reset themselves across launches and replays."""
    shapes = RESNET50_BN + [(37, 3), (1001, 17), (1001, 64)]
    xs = [_bn_input(shapes[i % len(shapes)], dtype, cuda) * (1 + i / 20)
          for i in range(20)]
    eager = [kernels.bn_stats(x) for x in xs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.bn_stats(xs[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [kernels.bn_stats(x) for x in xs]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for (m, v), (em, ev) in zip(outs, eager):
            assert torch.equal(m, em) and torch.equal(v, ev)


def test_bn_stats_is_one_kernel(cuda):
    """One ``bn_stats`` call launches one CUDA kernel (its outputs and
    scratch come from ``torch.empty``, which launches none)."""
    from torch.profiler import ProfilerActivity, profile
    x = _bn_input((32, 256, 14, 14), torch.bfloat16, cuda)
    kernels.bn_stats(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernels.bn_stats(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "bn_stats_kernel" in names[0], names


def test_bn_stats_orders_launches_on_two_streams(cuda):
    """Calls alternating between two streams agree bit for bit with the
    same calls on one stream: the kernel's tickets are shared on the
    device, so the wrapper makes a call on another stream wait for the
    last call's stream."""
    xs = [_bn_input(s, torch.bfloat16, cuda) * (1 + i / 8)
          for i, s in enumerate(RESNET50_BN[:8])]
    want = [kernels.bn_stats(x) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for i, x in enumerate(xs):
        with torch.cuda.stream(streams[i % 2]):
            got.append(kernels.bn_stats(x))
    torch.cuda.synchronize()
    for (m, v), (wm, wv) in zip(got, want):
        assert torch.equal(m, wm) and torch.equal(v, wv)


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


def _assert_out_close(out, want, dtype):
    """Flash out against the plain version: 2e-5 absolute in f32 (3xTF32
    products and f32 sums in another order: ~1e-6 in the CPU emulation of
    ``tests/test_torch_attention.py``); in bf16 one ulp of each output row, 2^-7 of that
    row's largest |out| (the kernel rounds p to bf16 for the tensor cores,
    and late causal rows are ~1/sqrt(n) of the first ones)."""
    diff = (out.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-5
        return
    tol = 2.0 ** -7 * want.float().abs().amax(-1, keepdim=True)
    assert bool((diff <= tol).all()), float((diff / tol).max())


def _flash_plain(q, k, v, causal):
    from dt_tpu_torch.ops import attention as TA
    b, _, h, d = q.shape
    out3, lse = TA.flash_attention_plain(TA._to3(q), TA._to3(k), TA._to3(v),
                                         scale=d ** -0.5, causal=causal)
    return TA._from3(out3, b, h), lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", [(3, 128, 2, 32), (1, 384, 3, 64),
                                     (2, 256, 1, 128), (1, 100, 2, 64),
                                     (1, 512, 2, 128)])
def test_flash_kernel_matches_plain(cuda, b, s, h, d, causal, dtype):
    """Out and lse against the plain version (out as ``_assert_out_close``
    holds it; lse 1e-5), two launches bit-identical; S = 100 is a ragged key
    tile."""
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
    _assert_out_close(out, want, dtype)
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


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_at_the_lm_shape(cuda, causal):
    """The TransformerLM's bf16 call: (8, 2048, 8, 64) q, k, v as strided
    views of one qkv buffer; out within one bf16 ulp of each row's largest
    |out|, lse 1e-5, two launches bit-identical."""
    from dt_tpu_torch.ops import attention as TA
    g = torch.Generator(device=cuda).manual_seed(8)
    qkv = torch.randn(8, 2048, 3 * 512, generator=g, device=cuda) \
        .to(torch.bfloat16)
    q, k, v = (t.reshape(8, 2048, 8, 64) for t in qkv.split(512, dim=-1))
    out, lse = TA.flash_fwd(q, k, v, scale=0.125, causal=causal)
    out2, lse2 = TA.flash_fwd(q, k, v, scale=0.125, causal=causal)
    want, want_lse = _flash_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    _assert_out_close(out, want, torch.bfloat16)
    assert float((lse - want_lse).abs().max()) <= 1e-5


def test_flash_bf16_gradients_match_the_plain_forward(cuda, monkeypatch):
    """``flash_attention`` forward and backward with the kernel, against the
    same with the plain forward in its place, bf16 at (2, 256, 4, 64): the
    backward reads the forward's out and lse, so a kernel that shifts
    either shows here.  dq, dk, dv within 2^-7 of each one's largest
    magnitude."""
    from dt_tpu_torch.ops import attention as TA
    q, k, v = _qkv_card(cuda, 2, 256, 4, 64, torch.bfloat16, seed=11)
    dout = _qkv_card(cuda, 2, 256, 4, 64, torch.bfloat16, seed=12)[0]

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        TA.flash_attention(*leaves, causal=True).backward(dout)
        return [t.grad for t in leaves]

    before = TA.flash_fwd.launches
    got = grads()
    assert TA.flash_fwd.launches == before + 1

    def plain_fwd(q, k, v, *, scale, causal, block_q, block_k):
        b, _, h, _ = q.shape
        out3, lse = TA.flash_attention_plain(
            TA._to3(q), TA._to3(k), TA._to3(v), scale=scale, causal=causal,
            block_q=block_q, block_k=block_k)
        return TA._from3(out3, b, h), lse

    monkeypatch.setattr(TA, "flash_fwd", plain_fwd)
    want = grads()
    for name, a, w in zip("qkv", got, want):
        tol = 2.0 ** -7 * float(w.float().abs().max())
        err = float((a.float() - w.float()).abs().max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("case", ["lm", "lm_full", "d128"])
def test_flash_f32_kernel_at_the_lm_shapes(cuda, case):
    """The f32 (3xTF32) kernel at the TransformerLM's shape, causal and
    not, from strided views of one qkv buffer, and at D 128 with S 1024:
    out 2e-5, lse 1e-5 against the plain version, two launches
    bit-identical."""
    from dt_tpu_torch.ops import attention as TA
    b, s, h, d, causal = {"lm": (8, 2048, 8, 64, True),
                          "lm_full": (8, 2048, 8, 64, False),
                          "d128": (8, 1024, 4, 128, True)}[case]
    g = torch.Generator(device=cuda).manual_seed(9)
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    out, lse = TA.flash_fwd(q, k, v, scale=d ** -0.5, causal=causal)
    out2, lse2 = TA.flash_fwd(q, k, v, scale=d ** -0.5, causal=causal)
    want, want_lse = _flash_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    _assert_out_close(out, want, torch.float32)
    assert float((lse - want_lse).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d,strided", [
    (2, 256, 4, 8, False), (3, 100, 2, 8, False), (2, 128, 4, 8, True),
    (2, 256, 4, 16, False), (1, 100, 3, 16, False), (2, 128, 4, 16, True)])
def test_flash_kernel_small_head_dims(cuda, b, s, h, d, strided, causal,
                                      dtype):
    """The head dims of the repo's small flash models, D 8 (bf16 padded to
    16 by TMA's zero fill, f32 native) and D 16, against the plain version
    at the tolerances of ``test_flash_kernel_matches_plain``; contiguous
    and as strided views of one qkv buffer (as the transformer hands them);
    S = 100 is a ragged key tile.  Two launches bit-identical."""
    from dt_tpu_torch.ops import attention as TA
    if strided:
        g = torch.Generator(device=cuda).manual_seed(d)
        qkv = (torch.randn(b, s, 3 * h * d, generator=g, device=cuda)
               * 0.5).to(dtype)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    else:
        q, k, v = _qkv_card(cuda, b, s, h, d, dtype, seed=s + d)
    before = TA.flash_fwd.launches
    out, lse = TA.flash_fwd(q, k, v, scale=d ** -0.5, causal=causal)
    out2, lse2 = TA.flash_fwd(q, k, v, scale=d ** -0.5, causal=causal)
    assert TA.flash_fwd.launches == before + 2
    want, want_lse = _flash_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert out.shape == (b, s, h, d) and out.dtype == dtype
    _assert_out_close(out, want, dtype)
    assert float((lse - want_lse).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_refuses_misaligned_views(cuda, dtype):
    """TMA needs 16-byte starts and strides: a view one element into its
    buffer, or with a row stride off 16 bytes, raises ``ValueError`` in
    either dtype (and launches nothing)."""
    from dt_tpu_torch.ops import attention as TA
    flat = torch.zeros(2 * 128 * 2 * 64 + 8, device=cuda, dtype=dtype)
    shifted = flat[1:1 + 2 * 128 * 2 * 64].view(2, 128, 2, 64)
    odd = torch.zeros(2, 128, 2 * 64 + 2, device=cuda, dtype=dtype)[
        ..., :128].unflatten(-1, (2, 64))  # rows 130 elements apart
    before = TA.flash_fwd.launches
    for bad in (shifted, odd):
        with pytest.raises(ValueError, match="16 bytes"):
            TA.flash_fwd(bad, bad, bad, scale=0.125, causal=True)
    assert TA.flash_fwd.launches == before


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


def _layer_inputs(dev, t, b, i, h, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lim = h ** -0.5
    x = torch.randn(t, b, i, generator=g, device=dev)
    h0, c0 = (torch.randn(b, h, generator=g, device=dev) * 0.3
              for _ in range(2))
    wx, wh = ((torch.rand(n, 4 * h, generator=g, device=dev) * 2 - 1) * lim
              for n in (i, h))
    bias = torch.randn(4 * h, generator=g, device=dev) * 0.02
    return x, h0, c0, wx, wh, bias


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t,b,h", [(35, 32, 200), (35, 32, 650),
                                   (9, 33, 200), (5, 3, 7)])
def test_lstm_layer_kernel_matches_plain(cuda, t, b, h, reverse):
    """The layer kernel against its plain step loop on the same xw: h, c
    and the gates within 1e-5 (f32 sums of the recurrent product in another
    order, carried through the steps), two launches bit-identical, one
    launch a call; the PTB shapes (B 32, H 200 and 650), a batch over
    several clusters, and H below the cluster's 16 blocks."""
    x, h0, c0, wx, wh, bias = _layer_inputs(cuda, t, b, h, h, seed=t + h)
    xw = (x.reshape(t * b, h) @ wx + bias).reshape(t, b, 4 * h)
    before = kernels.lstm_layer.launches
    got = kernels.lstm_layer(xw, h0, c0, wh, reverse)
    again = kernels.lstm_layer(xw, h0, c0, wh, reverse)
    assert kernels.lstm_layer.launches == before + 2
    want = kernels.lstm_layer_plain(xw, h0, c0, wh, reverse)
    torch.cuda.synchronize()
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)
        assert float((a - w).abs().max()) <= 1e-5


def test_wide_f32_lstm_steps_the_fused_cell(cuda):
    """An f32 ``ops.rnn.lstm`` too wide for the layer kernel (B 1, H 6656:
    ``layer_fits`` is False) steps ``lstm_cell_fused``, the pointwise
    kernel, and matches the plain step loop (``fused=False``) within
    1e-5; no layer launch."""
    from dt_tpu_torch.ops import rnn
    t, b, h = 3, 1, 6656
    assert not kernels.layer_fits(b, h)
    x, h0, c0, wx, wh, bias = _layer_inputs(cuda, t, b, 64, h, seed=5)
    w = [rnn.LSTMWeights(wx, wh, bias)]
    layer0, point0 = kernels.lstm_layer.launches, kernels.lstm_point.launches
    got = rnn.lstm(x, h0[None], c0[None], w)
    assert kernels.lstm_layer.launches == layer0
    assert kernels.lstm_point.launches == point0 + t
    want = rnn.lstm(x, h0[None], c0[None], w, fused=False)
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        assert float((a - e).abs().max()) <= 1e-5


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_gradients_match_the_step_path(cuda, reverse):
    """``ops.rnn.lstm`` through the layer kernel (BPTT backward) against
    the per-step path (the fused cell, autograd), two layers at the PTB
    width: outputs, final states and the gradients of x, h0, c0 and every
    weight within 1e-5 of each one's largest magnitude (f32 sums in
    another order)."""
    from dt_tpu_torch.ops import rnn
    t, b, h = 35, 32, 200
    x, h0, c0, wx, wh, bias = _layer_inputs(cuda, t, b, h, h, seed=3)
    ws = [rnn.LSTMWeights(wx, wh, bias),
          rnn.LSTMWeights(wx.flip(0), wh.flip(0), bias.flip(0))]
    h0s, c0s = torch.stack([h0, h0.flip(0)]), torch.stack([c0, c0.flip(0)])
    cots = [torch.randn(s, generator=torch.Generator(device=cuda)
                        .manual_seed(i), device=cuda)
            for i, s in enumerate([(t, b, h), (2, b, h), (2, b, h)])]

    def run(layer):
        leaves = [a.clone().requires_grad_() for a in
                  (x, h0s, c0s, *[p for w in ws for p in w])]
        lw = [rnn.LSTMWeights(*leaves[3:6]), rnn.LSTMWeights(*leaves[6:9])]
        if layer:
            out = rnn.lstm(leaves[0], leaves[1], leaves[2], lw, reverse)
        else:  # the per-step path: the fused cell a step
            outs, hs, cs = leaves[0], [], []
            for i, w in enumerate(lw):
                hh, cc = leaves[1][i], leaves[2][i]
                ys = [None] * t
                for s in (range(t - 1, -1, -1) if reverse else range(t)):
                    hh, cc = kernels.lstm_cell_fused(outs[s], hh, cc, w)
                    ys[s] = hh
                outs = torch.stack(ys)
                hs.append(hh)
                cs.append(cc)
            out = (outs, torch.stack(hs), torch.stack(cs))
        loss = sum((o * c).sum() for o, c in zip(out, cots))
        return list(out) + list(torch.autograd.grad(loss, leaves))

    before = kernels.lstm_layer.launches, kernels.lstm_point.launches
    got = run(True)
    assert (kernels.lstm_layer.launches - before[0],
            kernels.lstm_point.launches - before[1]) == (2, 0)
    want = run(False)
    for a, w in zip(got, want):
        tol = 1e-5 * max(1.0, float(w.detach().abs().max()))
        assert float((a - w).detach().abs().max()) <= tol


def test_lm_steps_on_card_match_cpu(cuda):
    """One f32 step of each LM on the card against the port on the CPU,
    from the same weights (TF32 off): loss 1e-5, gradient 1e-4 of its
    norm; the kernels ran once per layer (flash, and the LSTM's layer
    kernel)."""
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
              rng.randint(0, 50, (7, 3)), (kernels.lstm_layer, 2))]
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


def test_device_prefetch_iter_returns_the_inner_batches(cuda):
    """``DevicePrefetchIter`` on the card hands back the inner iterator's
    batches (data, labels, pads), each already on the card, over two
    epochs with a padded last batch."""
    from dt_tpu_torch.data import io
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (37, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, 37).astype(np.int32)
    inner = io.NDArrayIter(x, y, batch_size=8, shuffle=True, seed=3)
    twin = io.NDArrayIter(x, y, batch_size=8, shuffle=True, seed=3)
    it = io.DevicePrefetchIter(inner, device=cuda)
    for _ in range(2):
        got = list(it)
        want = list(twin)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.data.device.type == "cuda" and g.pad == w.pad
            np.testing.assert_array_equal(g.data.cpu().numpy(), w.data)
            np.testing.assert_array_equal(g.label.cpu().numpy(), w.label)


def test_module_fit_on_card_matches_cpu(cuda):
    """A 2-epoch f32 ``Module.fit`` of ``resnet20`` (the port's own init,
    SGD momentum, shuffled batches through ``DevicePrefetchIter`` on the
    card) against the same fit on the CPU: per-epoch train cross-entropy
    within 1e-4 relative (f32 sums in another order; TF32 off), one
    ``bn_stats`` launch a BatchNorm a step, and the eval scores alike."""
    from dt_tpu_torch.data import io
    from dt_tpu_torch.training.module import Module
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(8)
    x = rng.uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    curves, scores = {}, {}
    for dev in (cuda, torch.device("cpu")):
        mod = Module(models.create("resnet20", device=dev, num_classes=10),
                     optimizer="sgd", optimizer_params=dict(
                         learning_rate=0.1, momentum=0.9), device=dev,
                     seed=1)
        it = io.NDArrayIter(x, y, batch_size=32, shuffle=True)
        if dev.type == "cuda":
            it = io.DevicePrefetchIter(it, device=dev)
        ce = []
        before = kernels.bn_stats.launches
        mod.fit(it, eval_metric="ce", num_epoch=2,
                epoch_end_callback=lambda e, s, m: ce.append(m.get()[1]))
        if dev.type == "cuda":  # resnet20: 19 BatchNorms, 4 steps
            assert kernels.bn_stats.launches - before == 19 * 4
        curves[dev.type] = ce
        scores[dev.type] = dict(mod.score(io.NDArrayIter(x, y, 32), "ce"))
    for a, b in zip(curves["cuda"], curves["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b), curves
    a, b = scores["cuda"]["cross-entropy"], scores["cpu"]["cross-entropy"]
    assert abs(a - b) <= 1e-4 * abs(b), scores


def _two_clients_sync(dev, compress):
    """Two port clients in threads against the port's scheduler: three
    steps each of the serial allreduce and of ``GradSyncEngine.sync`` on
    tensors on ``dev``; returns both workers' (serial, engine) averages."""
    import threading

    from dt_tpu_torch.elastic.client import WorkerClient
    from dt_tpu_torch.elastic.scheduler import Scheduler
    from dt_tpu_torch.parallel.compression import GradientCompression
    from dt_tpu_torch.training.overlap import GradSyncEngine
    n = 1_000_003
    sched = Scheduler(initial_workers=["a", "b"])
    clients, out = {}, {}
    try:
        for h in ("a", "b"):
            clients[h] = WorkerClient("127.0.0.1", sched.port, host=h,
                                      heartbeat_interval_s=5.0)

        def worker(rank, h):
            c = clients[h]
            gcs = [GradientCompression(compress) if compress else None
                   for _ in range(2)]
            eng = GradSyncEngine(dev)
            res = []
            for step in range(3):
                rng = np.random.RandomState(10 * rank + step)
                g = torch.from_numpy(rng.normal(0, 0.01, n).astype(
                    np.float32)).to(dev)
                s = torch.from_numpy(rng.normal(size=211).astype(
                    np.float32)).to(dev)
                if gcs[0] is not None:
                    words = gcs[0].compress_on_device(g).cpu().numpy()
                    payload = {"packed": words.view(np.uint32), "n": n,
                               "threshold": compress}
                else:
                    payload = g.cpu().numpy()
                serial = (c.allreduce("grads", payload),
                          c.allreduce("stats", s.cpu().numpy()))
                avg, avg_s = eng.sync(c, gcs[1], g, s)
                res.append((serial, (avg.cpu().numpy(), avg_s)))
            out[h] = (res, eng.staging.outstanding)

        ts = [threading.Thread(target=worker, args=(i, h))
              for i, h in enumerate(("a", "b"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert not any(t.is_alive() for t in ts)
    finally:
        for c in clients.values():
            c.close()
        sched.close()
    return out


@pytest.mark.parametrize("compress", [None, 0.005])
def test_overlap_engine_on_card_is_bit_identical_to_serial(cuda, monkeypatch,
                                                          compress):
    """The bucketed D2H (side stream, pinned buffers, events), wire and
    H2D of ``GradSyncEngine`` on the card give the serial allreduce's bits
    (1 M elements in 64 KiB buckets)."""
    monkeypatch.setenv("DT_AR_BUCKET_BYTES", str(64 << 10))
    before = kernels.quantize_2bit.launches
    out = _two_clients_sync(cuda, compress)
    if compress:
        assert kernels.quantize_2bit.launches == before + 2 * 2 * 3
    for h, (res, outstanding) in out.items():
        assert outstanding == 0
        for (sg, ss), (og, os_) in res:
            assert og.tobytes() == np.asarray(sg).tobytes()
            assert os_.tobytes() == np.asarray(ss).tobytes()


@pytest.mark.parametrize("size", [8, 32])
def test_elastic_job_on_card_matches_cpu_and_serial(cuda, tmp_path, size):
    """A 2-worker f32 resnet20 job (``size``x``size``x3, 2 epochs of 2
    steps) against the port's scheduler on the card, its workers recording
    every step, held against the port on the CPU by
    ``torch_elastic_drift.hold_card_job`` (each step replayed from the
    card's state within 1e-4, the applied gradient the workers' average bit
    for bit, the per-epoch loss within 1e-4 of the replay's and of the same
    job on the CPU up to the first flipped ReLU mask); on the card with
    ``DT_AR_OVERLAP=0`` the same sha256 of params, stats and optimizer
    state at every epoch end."""
    import time

    import torch_elastic_drift as drift
    from dt_tpu_torch.elastic.scheduler import Scheduler
    runs = {"card": (["--deterministic"], {}),
            "serial": (["--deterministic"], {"DT_AR_OVERLAP": "0"}),
            "cpu": (["--device", "cpu"], {})}
    scheds, procs, stems = {}, {}, {}
    try:
        for tag, (extra, env) in runs.items():
            scheds[tag] = Scheduler(initial_workers=["w0", "w1"])
            for h in ("w0", "w1"):
                stems[tag, h] = str(tmp_path / f"{tag}_{h}")
                procs[tag, h] = drift.spawn(
                    scheds[tag].port, h, stems[tag, h],
                    drift.job_args(size, 128, 64) + extra, env,
                    dump=tag == "card")
        drift.wait_all(procs, stems, time.monotonic() + 120)
    finally:
        for sc in scheds.values():
            sc.close()
    r = {tag: {h: drift.load(stems[tag, h], dump=tag == "card")
               for h in ("w0", "w1")} for tag in runs}
    summary, failures = drift.hold_card_job(r["card"], r["cpu"], 1e-4)
    assert not failures, (failures, summary)
    for h in ("w0", "w1"):
        assert [e["sha256"] for e in r["card"][h][0]["epochs"]] == \
            [e["sha256"] for e in r["serial"][h][0]["epochs"]]
    assert r["card"]["w0"][0]["epochs"][-1]["sha256"] == \
        r["card"]["w1"][0]["epochs"][-1]["sha256"]


def test_async_save_snapshots_before_the_next_in_place_update(cuda,
                                                             tmp_path):
    """``save_checkpoint(async_save=True)`` at step k, then a step (params,
    momentum and BN stats updated in place on the card), then a load: the
    file holds the step-k state, byte for byte a synchronous save of it
    taken before the step."""
    from dt_tpu_torch import optim
    from dt_tpu_torch.interchange import export_jax_train_state
    from dt_tpu_torch.training import checkpoint
    from dt_tpu_torch.training.step import train_step
    from dt_tpu_torch.training.train_state import TrainState
    from dt_tpu_torch.utils import msgpack
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (16, 32, 32, 3)).astype(
        np.float32)).to(cuda).permute(0, 3, 1, 2)
    y = torch.from_numpy(rng.randint(0, 10, 16)).to(cuda)
    st = TrainState.create(models.create("resnet20", device=cuda,
                                         num_classes=10),
                           optim.create("sgd", learning_rate=0.1,
                                        momentum=0.9, weight_decay=1e-4))
    for _ in range(2):
        train_step(st, x, y)
    want = msgpack.pack(export_jax_train_state(st))  # the step-k state
    sync = checkpoint.save_checkpoint(str(tmp_path / "sync"), st.step, st)
    assert open(sync, "rb").read() == want
    k = st.step
    for _ in range(3):  # saves back to back reuse the pinned buffers
        fut = checkpoint.save_checkpoint(str(tmp_path / "async"), k, st,
                                         async_save=True)
        train_step(st, x, y)  # in place, queued behind the copy
        path = fut.result(timeout=60)
        checkpoint.flush_saves(timeout=60)
        got = open(path, "rb").read()
        assert got == want
        assert st.step == k + 1
        want = msgpack.pack(export_jax_train_state(st))
        k = st.step
    # and the load lands the step-k state back on the card
    fresh = TrainState.create(models.create("resnet20", device=cuda,
                                            num_classes=10),
                              optim.create("sgd", learning_rate=0.1,
                                           momentum=0.9,
                                           weight_decay=1e-4))
    checkpoint.load_checkpoint_file(path, fresh)
    assert all(p.is_cuda for p in fresh.module.parameters())
    assert msgpack.pack(export_jax_train_state(fresh)) == got
