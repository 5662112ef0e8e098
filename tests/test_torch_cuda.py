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
from test_torch_shapes import (DETECTOR_BN_CHW, DETECTORS, RESNET50_BN_CHW,
                               ZOO)

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
@pytest.mark.parametrize("batch", [32, 21])
def test_bn_sums_kernel_matches_plain(cuda, batch, dtype):
    """``bn_sums`` (pass 1 stopped short of the finalize) at every BN shape
    of ResNet-50 (the 53 BatchNorms of a forward take these 12) at the
    mesh phase's per-rank batches: the f32 sums against ``bn_sums_plain``
    within 1e-5 of the sums of |x| and of x^2, two launches bit-identical,
    one launch a call counted in ``bn_sums.launches`` (not in
    ``bn_stats.launches``)."""
    for c, h, w in RESNET50_BN_CHW:
        x = _bn_input((batch, c, h, w), dtype, cuda)
        before = (kernels.bn_sums.launches, kernels.bn_stats.launches)
        s, q = kernels.bn_sums(x)
        s2, q2 = kernels.bn_sums(x)
        assert (kernels.bn_sums.launches, kernels.bn_stats.launches) == \
            (before[0] + 2, before[1])
        ps, pq = kernels.bn_sums_plain(kernels.rows_view(x))
        a = kernels.rows_view(x).float().abs().sum(0)
        torch.cuda.synchronize()
        assert torch.equal(s, s2) and torch.equal(q, q2)
        torch.testing.assert_close(s, ps, rtol=0, atol=1e-5 * float(a.max()))
        torch.testing.assert_close(q, pq, rtol=0, atol=1e-5 * float(pq.max()))


def test_one_rank_nccl_world_through_two_rebuilds(cuda):
    """The rebuild's cycle on one card (multi-rank NCCL needs two cards):
    a one-rank group formed as ``MeshManager`` forms a world (its device
    named under the generation's key prefix, the backend chosen from it:
    NCCL, since the rank owns its device), an all-reduce, teardown, and
    a new group under a fresh prefix of the same store, twice."""
    import torch.distributed as dist

    from dt_tpu_torch.elastic.mesh_manager import MeshManager
    from torch_mesh_job import free_port
    assert not dist.is_initialized()
    mm = MeshManager(f"127.0.0.1:{free_port()}", device="cuda")
    try:
        for gen in ("e0", "e1", "e2"):
            mm._form_group(1, 0, gen)
            assert (mm.backend, dist.get_backend()) == ("nccl", "nccl")
            t = torch.full((4,), 3.0, device=cuda)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            assert t.tolist() == [3.0] * 4
            mm.teardown()
            assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


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

    before = (kernels.lstm_layer.launches, kernels.lstm_point.launches,
              kernels.lstm_layer_bwd.launches)
    got = run(True)
    assert (kernels.lstm_layer.launches - before[0],
            kernels.lstm_point.launches - before[1],
            kernels.lstm_layer_bwd.launches - before[2]) == (2, 0, 2)
    want = run(False)
    for a, w in zip(got, want):
        tol = 1e-5 * max(1.0, float(w.detach().abs().max()))
        assert float((a - w).detach().abs().max()) <= tol


#: bf16 layer kernels against their plain loops on the card, of each
#: output's largest magnitude: the product's f32 sums run in another order
#: than cuBLAS's, so a bf16 rounding of hw (or dh) can fall one ulp apart,
#: and the steps carry it (the CPU tests' bf16 bound, two ulps at the top)
TOL_LAYER_BF16 = 2.0 ** -6


def _bf16_layer_inputs(dev, t, b, h, seed):
    x, h0, c0, wx, wh, bias = _layer_inputs(dev, t, b, h, h, seed)
    bf = torch.bfloat16
    xw = (x.to(bf).reshape(t * b, h) @ wx.to(bf)).reshape(t, b, 4 * h)
    return xw, h0.to(bf), c0.to(bf), wh.to(bf), bias.to(bf)


def _close_of_max(a, w, tol):
    w = w.detach().float()
    return float((a.detach().float() - w).abs().max()) <= \
        tol * max(float(w.abs().max()), 1e-30)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b", [1, 5, 32])
@pytest.mark.parametrize("h", [8, 200, 650])
def test_lstm_layer_bf16_kernel_matches_plain(cuda, h, b, reverse):
    """The bf16 layer kernel (tensor-core product) against its plain step
    loop on the same xw and b at T 35: hs, cs and the f32 gates within
    ``TOL_LAYER_BF16`` of each one's largest magnitude, two launches
    bit-identical, one launch a call; H 8 (clusters of 8 blocks), 200 (Wh
    in shared memory) and 650 (Wh from L2)."""
    t = 35
    xw, h0, c0, wh, bias = _bf16_layer_inputs(cuda, t, b, h, seed=b + h)
    before = kernels.lstm_layer.launches
    got = kernels.lstm_layer(xw, h0, c0, wh, reverse, b=bias)
    again = kernels.lstm_layer(xw, h0, c0, wh, reverse, b=bias)
    assert kernels.lstm_layer.launches == before + 2
    want = kernels.lstm_layer_plain(xw, h0, c0, wh, reverse, b=bias)
    torch.cuda.synchronize()
    for a, a2, w in zip(got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, a2)
        assert _close_of_max(a, w, TOL_LAYER_BF16)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(35, 32, 200), (35, 32, 650),
                                   (9, 33, 200), (5, 3, 7), (35, 1, 8)])
def test_lstm_layer_bwd_kernel_matches_plain(cuda, t, b, h, dtype, reverse):
    """The BPTT kernel against its plain loop on the forward kernel's own
    gates and cs, with seeded outside gradients: dG, dh0 and dc0 within
    1e-5 (f32: sums in another order) or ``TOL_LAYER_BF16`` (bf16) of each
    one's largest magnitude, two launches bit-identical, one launch a
    call."""
    if dtype == torch.float32:
        x, h0, c0, wx, wh, bias = _layer_inputs(cuda, t, b, h, h, seed=t * h)
        xw = (x.reshape(t * b, h) @ wx + bias).reshape(t, b, 4 * h)
        _, cs, gates = kernels.lstm_layer(xw, h0, c0, wh, reverse)
        tol = 1e-5
    else:
        xw, h0, c0, wh, bias = _bf16_layer_inputs(cuda, t, b, h, seed=t * h)
        _, cs, gates = kernels.lstm_layer(xw, h0, c0, wh, reverse, b=bias)
        tol = TOL_LAYER_BF16
    g = torch.Generator(device=cuda).manual_seed(b)
    dhs, dcs = (torch.randn(t, b, h, generator=g, device=cuda).to(dtype)
                for _ in range(2))
    before = kernels.lstm_layer_bwd.launches
    got = kernels.lstm_layer_bwd(gates, cs, c0, wh, dhs, dcs, reverse)
    again = kernels.lstm_layer_bwd(gates, cs, c0, wh, dhs, dcs, reverse)
    assert kernels.lstm_layer_bwd.launches == before + 2
    want = kernels.lstm_layer_bwd_plain(gates, cs, c0, wh, dhs, dcs, reverse)
    torch.cuda.synchronize()
    for a, a2, w in zip(got, again, want):
        assert a.dtype == w.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, a2)
        assert _close_of_max(a, w, tol)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_bf16_gradients_match_the_step_path(cuda, reverse):
    """``ops.rnn.lstm`` in bf16 through the layer kernels (2 forward, 2
    backward launches, no pointwise launch) against the per-step path (the
    fused cell a step, autograd) at the PTB width, two layers: outputs,
    final states and the gradients of x, h0, c0 and every weight within
    2^-5 of each one's largest magnitude (``TOL_BILSTM`` of
    ``chip_smoke.py``: the two paths round the bf16 sums in other
    orders)."""
    from dt_tpu_torch.ops import rnn
    t, b, h = 35, 32, 200
    bf = torch.bfloat16
    x, h0, c0, wx, wh, bias = (a.to(bf) for a in
                               _layer_inputs(cuda, t, b, h, h, seed=4))
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
        loss = sum((o.float() * c).sum() for o, c in zip(out, cots))
        return list(out) + list(torch.autograd.grad(loss, leaves))

    before = (kernels.lstm_layer.launches, kernels.lstm_point.launches,
              kernels.lstm_layer_bwd.launches)
    got = run(True)
    assert (kernels.lstm_layer.launches - before[0],
            kernels.lstm_point.launches - before[1],
            kernels.lstm_layer_bwd.launches - before[2]) == (2, 0, 2)
    want = run(False)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype == bf
        assert _close_of_max(a, w, 2.0 ** -5)


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


def test_module_fit_on_card_matches_cpu(cuda, monkeypatch):
    """A 2-epoch f32 ``Module.fit`` of ``resnet20`` (the port's own init,
    SGD momentum, shuffled batches through ``DevicePrefetchIter`` on the
    card) against the same fit on the CPU: per-epoch train cross-entropy
    within 1e-4 relative (f32 sums in another order; TF32 off), one
    ``bn_stats`` launch a BatchNorm a step, and the eval scores alike.

    Both sides are pinned (``tests/torch_fit_variance.py`` shows why):
    cuDNN runs its deterministic algorithms (with the default ones the
    card's fits differ from run to run, and a fit that scored 2.1215440
    against the CPU's 2.1223911 failed this test), and the CPU runs one
    thread (eight threads sum its convolutions in another order, 5.6e-6
    off the one-thread score, which the card's matches)."""
    from dt_tpu_torch.data import io
    from dt_tpu_torch.training.module import Module
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    threads = torch.get_num_threads()
    rng = np.random.RandomState(8)
    x = rng.uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    curves, scores = {}, {}
    torch.set_num_threads(1)
    try:
        for dev in (cuda, torch.device("cpu")):
            mod = Module(models.create("resnet20", device=dev,
                                       num_classes=10),
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
            scores[dev.type] = dict(mod.score(io.NDArrayIter(x, y, 32),
                                              "ce"))
    finally:
        torch.set_num_threads(threads)
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


def test_hbm_gauges_read_the_allocator(cuda, monkeypatch, tmp_path):
    """The device plane's ``device.hbm_*`` gauges: bytes in use equal to
    ``torch.cuda.memory_allocated`` of the worker's device, a peak at
    least that, the capacity ``mem_get_info``'s total."""
    from dt_tpu_torch.obs import device as obs_device
    from dt_tpu_torch.obs import metrics as obs_metrics
    obs_device._reset_for_tests()
    obs_device.set_enabled(True)
    try:
        obs_device.register_device(cuda)
        x = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
        reg = obs_metrics.MetricsRegistry(enabled=True)
        snap = obs_device.sample_into(reg)
        (d,) = snap["devices"]
        assert d["bytes_in_use"] == torch.cuda.memory_allocated(cuda)
        assert d["peak_bytes_in_use"] >= d["bytes_in_use"] >= x.numel()
        assert d["bytes_limit"] == torch.cuda.mem_get_info(cuda)[1]
        gauges = {g[0]: g[2] for g in reg.gauges_export()}
        assert gauges["device.hbm_bytes"] == d["bytes_in_use"]
        assert 0 < gauges["device.hbm_bytes"] <= \
            gauges["device.hbm_limit_bytes"]
        del x
    finally:
        obs_device._reset_for_tests()
        obs_device.set_enabled(None)


def test_oom_leaves_a_census_bundle(cuda, monkeypatch, tmp_path):
    """A deliberately oversized ``torch.empty`` raises
    ``torch.cuda.OutOfMemoryError``; with the device and blackbox planes
    armed its bundle's census names the largest live tensors first."""
    import json

    from dt_tpu_torch.obs import blackbox, device as obs_device
    monkeypatch.setenv("DT_BLACKBOX_DIR", str(tmp_path))
    for m in (obs_device, blackbox):
        m._reset_for_tests()
        m.set_enabled(True)
    try:
        big = torch.empty(3, 1 << 30, dtype=torch.uint8, device=cuda)
        small = torch.empty(1 << 20, dtype=torch.float32, device=cuda)
        total = torch.cuda.mem_get_info(cuda)[1]
        with pytest.raises(torch.cuda.OutOfMemoryError) as e:
            torch.empty(2 * total, dtype=torch.uint8, device=cuda)
        path = obs_device.maybe_oom_bundle(e.value, host="w0")
        b = json.load(open(path))
        assert blackbox.validate_bundle(b) == [] and b["trigger"] == "oom"
        census = b["extra"]["census"]
        assert census[0]["shape"] == "(3, 1073741824)" and \
            census[0]["bytes"] >= big.numel()
        assert [g["bytes"] for g in census] == \
            sorted((g["bytes"] for g in census), reverse=True)
        assert any(g["shape"] == "(1048576,)" for g in census)
        del big, small
    finally:
        for m in (obs_device, blackbox):
            m._reset_for_tests()
            m.set_enabled(None)


def test_gateway_on_card_matches_direct_predict(cuda):
    """One replica on the card (``resnet18``, 10 classes, 32x32, f32,
    buckets 1-8) behind the port's scheduler: concurrent ``InferClient``
    requests of 1-4 rows are coalesced, each answer within 1e-4 of a
    direct ``Predictor.predict`` of its rows (another bucket may take
    another cuDNN algorithm; TF32 off), and ``fused_bn_inference`` launches
    20 times a batch the gateway ran."""
    import threading

    from dt_tpu_torch.elastic.scheduler import Scheduler
    from dt_tpu_torch.predictor import Predictor
    from dt_tpu_torch.serve import InferClient, Replica
    torch.backends.cudnn.allow_tf32 = False
    model = models.create("resnet18", device=cuda, num_classes=10)
    pred = Predictor.from_fn(lambda m, _s, x: m(x), model, max_batch=8,
                             device=cuda)
    pred.warmup(feature_shape=(32, 32, 3))
    rng = np.random.RandomState(0)
    xs = [rng.uniform(-1, 1, (int(rng.randint(1, 5)), 32, 32, 3))
          .astype(np.float32) for _ in range(24)]
    want = [pred.predict(x) for x in xs]
    sched = Scheduler(initial_workers=[])
    rep = None
    try:
        rep = Replica(pred, "s0", f"127.0.0.1:{sched.port}",
                      heartbeat_s=0.1, advertise_host="127.0.0.1")
        client = InferClient(scheduler=f"127.0.0.1:{sched.port}")
        outs = [None] * len(xs)
        before = kernels.bn_act.launches

        def ask(i0):
            for i in range(i0, len(xs), 4):
                outs[i] = client.infer(xs[i])

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        launches = kernels.bn_act.launches - before
        st = rep.gateway.stats()
        assert st["requests"] == len(xs) and st["shed"] == 0
        assert st["batches"] < st["requests"]
        assert launches == 20 * st["batches"]  # resnet18 v1: 20 BNs
        for out, w in zip(outs, want):
            assert out["weights_step"] == 0
            np.testing.assert_allclose(out["y"], w, rtol=1e-4, atol=1e-4)
    finally:
        if rep is not None:
            rep.close()
        sched.close()


def test_parallel_collectives_on_a_one_rank_nccl_group(cuda):
    """The parallel layer's NCCL branch on one card (multi-rank NCCL needs
    two): over a one-rank NCCL group every collective of
    ``parallel.collectives`` runs on device tensors, none staged through
    the host, and ring attention, Ulysses and the pipeline over it equal
    their one-process versions."""
    import torch.distributed as dist

    from dt_tpu_torch.parallel import collectives as coll
    from dt_tpu_torch.parallel.mesh import Mesh
    from dt_tpu_torch.parallel.pipeline import pipeline_run
    from dt_tpu_torch.parallel.ring_attention import (full_attention,
                                                      ring_attention)
    from dt_tpu_torch.parallel.ulysses import ulysses_attention
    from torch_mesh_job import free_port
    assert not dist.is_initialized()
    store = dist.TCPStore("127.0.0.1", free_port(), is_master=True,
                          wait_for_workers=False)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        world = dist.group.WORLD
        g = torch.Generator(device=cuda).manual_seed(0)
        q, k, v = (torch.randn(2, 64, 4, 16, generator=g, device=cuda)
                   .requires_grad_() for _ in range(3))
        assert not coll._staged(q.device, world)
        got = coll.exchange([q.detach()], world, send_to=0, recv_from=0)[0]
        assert got.is_cuda and torch.equal(got, q.detach())
        assert torch.equal(coll.all_to_all(q, world, 2, 1), q)
        assert torch.equal(coll.gather(coll.split(q, world, 1), world, 1), q)
        assert torch.equal(coll.reduce_from(coll.copy_to(q, world), world), q)
        mesh = Mesh(0, 1, None, cuda, model=1, model_group=world)
        for fn in (ring_attention, ulysses_attention):
            for causal in (False, True):
                out = fn(q, k, v, mesh, axis_name="model", causal=causal)
                want = full_attention(q, k, v, causal=causal)
                torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
                out.sum().backward()
                assert q.grad.isfinite().all()
                q.grad = None
        lin = torch.nn.Linear(16, 16).to(cuda)
        x = torch.randn(4, 3, 16, generator=g, device=cuda)
        y = pipeline_run(lambda h: torch.tanh(lin(h)),
                         list(lin.parameters()), x, world)
        torch.testing.assert_close(y, torch.tanh(lin(x)))
        y.sum().backward()
        assert lin.weight.grad is not None
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


def _parallel_inputs(case: str) -> dict:
    """The inputs of ``tests/torch_parallel_worker.py``'s ``case`` at a
    2-rank world, weights from the port's own seeded init."""
    from torch_parallel_worker import flat
    rng = np.random.RandomState(1)
    toks = rng.randint(0, 64, (16, 16)).astype(np.int32)
    cfg = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
               max_len=16)
    d = dict(x=toks, y=np.roll(toks, -1, 1), toks=toks[:8],
             batch=np.int64(8))
    if case == "pipe":
        cfg.update(num_stages=2, num_micro=2)
        d.update(w=rng.normal(0, 0.5, (2, 8, 8)).astype(np.float32),
                 b=rng.normal(0, 0.1, (2, 8)).astype(np.float32),
                 x_toy=rng.normal(0, 1, (4, 2, 8)).astype(np.float32))
        name = "transformer_lm_pipelined"
    else:
        d.update({n: rng.normal(0, 1, (2, 32, 4, 8)).astype(np.float32)
                  for n in ("q", "k", "v", "g")})
        name = "transformer_lm"
    model = models.init_params(models.create(name, device="cpu", **cfg), 0)
    d.update(flat(export_jax_variables(model)["params"], "init"))
    d.update({f"cfg/{k}": np.int64(v) for k, v in cfg.items()})
    return d


@pytest.mark.parametrize("case", ["ring", "ulysses", "pipe"])
def test_parallel_layer_on_two_gloo_ranks_of_the_card(cuda, tmp_path, case):
    """Two ranks on the card over gloo (the ring's K/V hops, Ulysses'
    all-to-alls and the pipeline's sends staged through pinned host
    memory) against the same world on the CPU: every output, gradient and
    trained param within 1e-4 (TF32 off in the workers)."""
    from torch_parallel_worker import run_world
    d = _parallel_inputs(case)
    for sub in ("card", "cpu"):
        (tmp_path / sub).mkdir()
    card = run_world(str(tmp_path / "card"), case, d, world=2, timeout=240,
                     device="cuda")
    cpu = run_world(str(tmp_path / "cpu"), case, d, world=2, timeout=240)
    for c, h in zip(card, cpu):
        assert set(c) == set(h)
        for key in h:
            np.testing.assert_allclose(c[key], h[key], rtol=1e-4, atol=1e-4,
                                       err_msg=key)


#: every optimizer of the port on the card against the same code on the
#: CPU, normwise per leaf: the elementwise rules run the same f32 ops, a
#: last bit apart where one device divides by a scalar as a product with
#: its reciprocal (1e-6); ftrl's soft threshold cancels and lbsgd's and
#: lamb's norms sum in another order on each device (1e-5)
_CARD_RULES = {
    "sgd": dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4),
    "nag": {}, "adam": dict(weight_decay=1e-4), "adagrad": {},
    "rmsprop": dict(centered=True, momentum=0.9), "adadelta": {},
    "ftrl": {}, "adamax": {}, "nadam": {}, "signum": {}, "signsgd": {},
    "ftml": {}, "dcasgd": dict(momentum=0.9), "lbsgd": dict(eta=0.01),
    "lamb": dict(weight_decay=1e-4), "sgld": {}}
_CARD_TOL = {"ftrl": 1e-5, "lbsgd": 1e-5, "lamb": 1e-5}


def _card_params(dev, seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"conv.weight": (64, 32, 3, 3), "dense.weight": (100, 64),
              "dense.bias": (100,), "pos": (16, 64)}
    out = {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
           for k, s in shapes.items()}
    out["pos"] = out["pos"].to(torch.bfloat16)
    return {k: v.to(dev) for k, v in out.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
@pytest.mark.parametrize("name", sorted(_CARD_RULES))
def test_optimizer_rules_on_card_match_cpu(cuda, name, mp):
    """3 updates of each rule (and under multi_precision) on the card and
    on the CPU from the same params (a bf16 leaf among them) and
    gradients: params and every state leaf within the rule's tolerance;
    sgld's key stream equal, its noise another stream of the same law."""
    from dt_tpu_torch import optim
    sides = []
    for dev in (cuda, torch.device("cpu")):
        tx = optim.create(name, multi_precision=mp, **_CARD_RULES[name])
        params = _card_params(dev)
        state = tx.init(params)
        rng = np.random.RandomState(1)
        for _ in range(3):
            grads = {k: torch.from_numpy(rng.normal(0, 1, p.shape).astype(
                np.float32)).to(dev).to(p.dtype) for k, p in params.items()}
            state = tx.update(grads, state, params)
        sides.append((params, _leaves(state)))
    (pc, sc), (pk, sk) = sides
    assert sorted(sc) == sorted(sk)
    tol = _CARD_TOL.get(name, 1e-6)
    for k, v in sk.items():
        a = sc[k]
        if isinstance(v, torch.Tensor):
            assert a.dtype == v.dtype, k
            if name == "sgld" and not k.endswith("mom"):
                continue
            err = float((a.cpu().double() - v.double()).abs().max())
            assert err <= tol * max(float(v.double().abs().max()), 1e-30) \
                + (2.0 ** -7 * float(v.double().abs().max())
                   if v.dtype == torch.bfloat16 else 0.0), (k, err)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(v),
                                          err_msg=k)
    for k, v in pk.items():
        if name == "sgld":  # noise of N(0, lr) a step on each side
            assert float((pc[k].cpu().float() - v.float()).abs().max()) \
                <= 6 * np.sqrt(2 * 3 * 0.01) + 0.1, k
            continue
        bf = v.dtype == torch.bfloat16
        scale = float(v.double().abs().max())
        err = float((pc[k].cpu().double() - v.double()).abs().max())
        assert err <= (2.0 ** -7 if bf else tol) * scale, (k, err)


def test_multi_precision_fit_on_card_matches_cpu(cuda, monkeypatch):
    """The resnet20 fit of :func:`test_module_fit_on_card_matches_cpu` with
    SGD momentum under multi_precision (f32 masters beside f32 params):
    per-epoch train cross-entropy within 1e-4 relative of the CPU's, and
    the optimizer state ``{"master", "inner"}`` with the masters on the
    card."""
    from dt_tpu_torch.data import io
    from dt_tpu_torch.training.module import Module
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    threads = torch.get_num_threads()
    rng = np.random.RandomState(8)
    x = rng.uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    curves = {}
    torch.set_num_threads(1)
    try:
        for dev in (cuda, torch.device("cpu")):
            mod = Module(models.create("resnet20", device=dev,
                                       num_classes=10),
                         optimizer="sgd", optimizer_params=dict(
                             learning_rate=0.1, momentum=0.9,
                             multi_precision=True), device=dev, seed=1)
            ce = []
            mod.fit(io.NDArrayIter(x, y, batch_size=32, shuffle=True),
                    eval_metric="ce", num_epoch=2,
                    epoch_end_callback=lambda e, s, m: ce.append(m.get()[1]))
            curves[dev.type] = ce
            master = next(iter(mod.state.opt_state["master"].values()))
            assert master.device.type == dev.type
            assert master.dtype == torch.float32
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(curves["cuda"], curves["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b), curves


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bidirectional_lstm_kernels_match_the_plain_cell(cuda, dtype):
    """``ops.rnn.bidirectional_lstm`` at the PTB width (T 35, B 32, E = H
    = 200, 2 layers) through the kernels (both dtypes: the layer kernel, 4
    launches, its backward 4, no pointwise launch) against ``fused=False`` on
    the card: outputs, hT, cT and the gradients of x, h0, c0 and every
    direction's wx, wh, b within 1e-5 (f32) or 2^-5 (bf16) of each one's
    largest magnitude (as ``chip_smoke.py``'s ``TOL_BILSTM``)."""
    from dt_tpu_torch.ops import rnn
    t, b, e, h, layers = 35, 32, 200, 200, 2
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    g = torch.Generator(device=cuda).manual_seed(3)
    ws = []
    for _ in range(2):
        ws += rnn.init_lstm_weights(g, 1, e, h, dtype, cuda)
        ws += rnn.init_lstm_weights(g, 1, 2 * h, h, dtype, cuda)
    x = torch.randn(t, b, e, generator=g, device=cuda).to(dtype)
    h0, c0 = ((0.1 * torch.randn(2 * layers, b, h, generator=g,
                                 device=cuda)).to(dtype) for _ in range(2))
    cots = [torch.randn(s, generator=g, device=cuda) for s in
            ((t, b, 2 * h), (2 * layers, b, h), (2 * layers, b, h))]

    def run(fused):
        leaves = [a.clone().requires_grad_() for a in
                  (x, h0, c0, *[p for w in ws for p in w])]
        lw = [rnn.LSTMWeights(*leaves[3 + 3 * i:6 + 3 * i])
              for i in range(4)]
        outs = rnn.bidirectional_lstm(leaves[0], leaves[1], leaves[2],
                                      lw[:2], lw[2:], fused=fused)
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
        return list(outs) + list(torch.autograd.grad(loss, leaves))

    before = (kernels.lstm_layer.launches, kernels.lstm_point.launches,
              kernels.lstm_layer_bwd.launches)
    got = run(None)
    launched = (kernels.lstm_layer.launches - before[0],
                kernels.lstm_point.launches - before[1],
                kernels.lstm_layer_bwd.launches - before[2])
    assert launched == (4, 0, 4)
    want = run(False)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        w = w.detach().float()
        err = float((a.detach().float() - w).abs().max())
        assert err <= tol * float(w.abs().max())


def test_stochastic_depth_step_on_card_matches_cpu(cuda, monkeypatch):
    """One ``Module.fit`` epoch (2 steps) of ``resnet20`` with
    ``stochastic_depth=0.5`` in f32, one keep pattern forced on both
    devices (``models.resnet.draw_keep`` replaced), card against CPU: the
    per-epoch cross-entropy within 1e-4 relative; then the card's own
    draws: two train forwards from one generator seed equal, from others
    not always, eval repeated equal."""
    from dt_tpu_torch.data import io
    from dt_tpu_torch.models import resnet
    from dt_tpu_torch.training.module import Module
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    keeps = [True, False, True, True, False, True, False]
    real = resnet.draw_keep
    count = [0]

    def forced(p, generator, device):
        count[0] += 1
        return torch.tensor(keeps[(count[0] - 1) % 7], device=device)

    monkeypatch.setattr(resnet, "draw_keep", forced)
    rng = np.random.RandomState(9)
    x = rng.uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ce, mods = {}, {}
    try:
        for dev in (cuda, torch.device("cpu")):
            count[0] = 0
            mod = Module(models.create("resnet20", device=dev, num_classes=10,
                                       stochastic_depth=0.5),
                         optimizer="sgd", optimizer_params=dict(
                             learning_rate=0.05, momentum=0.9), device=dev,
                         seed=1)
            out = []
            mod.fit(io.NDArrayIter(x, y, batch_size=32, shuffle=True),
                    eval_metric="ce", num_epoch=1,
                    epoch_end_callback=lambda e, s, m: out.append(m.get()[1]))
            assert count[0] == 2 * 7
            ce[dev.type], mods[dev.type] = out[0], mod
    finally:
        torch.set_num_threads(threads)
    assert abs(ce["cuda"] - ce["cpu"]) <= 1e-4 * abs(ce["cpu"]), ce
    monkeypatch.setattr(resnet, "draw_keep", real)
    model = mods["cuda"].model
    xb = torch.from_numpy(x[:16]).to(cuda).permute(0, 3, 1, 2)

    def train(seed):
        with torch.no_grad():
            return model(xb, training=True, generator=torch.Generator(
                device=cuda).manual_seed(seed))

    assert torch.equal(train(1), train(1))
    assert any(not torch.equal(train(1), train(s)) for s in (2, 3, 4))
    with torch.no_grad():
        assert torch.equal(model(xb), model(xb))


def test_rec_fed_fit_on_card_matches_cpu(cuda, monkeypatch, tmp_path):
    """A ``.rec`` of 48 raw u8 32x32x3 records through ``ImageRecordIter``
    (``cifar_train_augmenter``, 4 decode threads) behind
    ``PrefetchingIter`` and ``ResizeIter`` into a two-step f32 ``resnet20``
    ``Module.fit``, card against CPU (the batches are the same bytes on
    both): per-step cross-entropy within 1e-4 relative, 19 ``bn_stats``
    launches a step on the card; and a ``DataLoader`` of 2 workers forked
    after those launches gives the in-process loader's batches."""
    from dt_tpu_torch import data
    from dt_tpu_torch.data import augment, io
    from dt_tpu_torch.training.module import Module
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    rng = np.random.RandomState(4)
    path = str(tmp_path / "train.rec")
    with data.RecordIOWriter(path) as w:
        for i in range(48):
            img = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
            w.write(data.pack_label(img.tobytes(), i % 10, rec_id=i))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    curves = {}
    try:
        for dev in (cuda, torch.device("cpu")):
            it = data.ImageRecordIter(
                path, (32, 32, 3), 16, shuffle=True, seed=2,
                augmenter=augment.cifar_train_augmenter(),
                num_decode_threads=4)
            mod = Module(models.create("resnet20", device=dev,
                                       num_classes=10),
                         optimizer="sgd", optimizer_params=dict(
                             learning_rate=0.1, momentum=0.9), device=dev,
                         seed=1)
            cum = []
            before = kernels.bn_stats.launches
            mod.fit(io.ResizeIter(io.PrefetchingIter(it), 2),
                    eval_metric="ce", num_epoch=1,
                    batch_end_callback=lambda p: cum.append(
                        p.eval_metric.get()[1]))
            if dev.type == "cuda":
                assert kernels.bn_stats.launches - before == 19 * 2
            curves[dev.type] = cum
            it.close()
    finally:
        torch.set_num_threads(threads)
    assert len(curves["cuda"]) == 2
    for a, b in zip(curves["cuda"], curves["cpu"]):
        assert np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b), curves
    xs = rng.uniform(0, 1, (20, 4)).astype(np.float32)
    ys = np.arange(20, dtype=np.int32)
    with data.DataLoader(data.ArrayDataset(xs, ys), batch_size=6,
                         shuffle=True, num_workers=2) as forked:
        got = [(b.data, b.label) for b in forked]
        procs = list(forked._it._pool._pool)
    want = [(b.data, b.label) for b in data.DataLoader(
        data.ArrayDataset(xs, ys), batch_size=6, shuffle=True)]
    assert len(got) == len(want) == 4
    for (a, la), (b, lb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    for p in procs:
        p.join(timeout=10)
        assert not p.is_alive()


def _zoo_model(name, size, dev, **kw):
    if models.takes_image_size(name):
        kw["image_size"] = size
    return models.create(name, device=dev, **kw)


@pytest.mark.parametrize("name,size", ZOO)
def test_zoo_eval_on_card_matches_cpu(cuda, name, size, monkeypatch):
    """Each family's f32 eval forward (TF32 off) on the card, every BN
    through ``fused_bn_inference``, against the port on the CPU, with the
    running means away from 0: logits within 1e-4."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = models.init_params(_zoo_model(name, size, "cpu", num_classes=10),
                             seed=2)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for n, b in cpu.named_buffers():
            if n.endswith(".mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
    card = _zoo_model(name, size, cuda, num_classes=10)
    card.load_state_dict(cpu.state_dict())
    n_bn = sum(isinstance(m, models.common.FusedBatchNorm)
               for m in card.modules())
    x = torch.rand(2, 3, size, size, generator=g).sub(0.5).contiguous(
        memory_format=torch.channels_last)
    before = kernels.bn_act.launches
    with torch.inference_mode():
        got = card(x.to(cuda)).cpu()
        want = cpu(x)
    assert kernels.bn_act.launches - before == n_bn
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _zoo_bn_shapes(name, size, dev):
    """Every distinct (C, H, W) of a BN input in one forward of ``name``,
    with whether its ReLU is fused in."""
    from dt_tpu_torch.models.common import FusedBatchNorm
    seen = set()

    def hook(mod, args):
        seen.add((*args[0].shape[1:], mod.relu))

    model = _zoo_model(name, size, dev)
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, FusedBatchNorm)]
    with torch.inference_mode():
        model(torch.zeros(1, 3, size, size, device=dev).contiguous(
            memory_format=torch.channels_last))
    for h in hooks:
        h.remove()
    return sorted(seen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,size", [z for z in ZOO if z[0] not in (
    "alexnet", "squeezenet", "googlenet")])
def test_zoo_bn_kernels_at_every_shape_of_the_model(cuda, name, size,
                                                    dtype):
    """Pass 1 and pass 2 at every (rows, C) a BN family gives them at batch
    32 (Inception-v3's C 80 ... 2048 over 8·8·32 rows, DenseNet's
    concatenations, MobileNet-v2's C 16 and 24 ...): pass 1 within 1e-5
    of E[x^2] of its plain version, pass 2 and the fused training forward
    bit-equal to ``bn_act_plain``, the inference kernel too."""
    shapes = _zoo_bn_shapes(name, size, cuda)
    assert shapes
    for c, h, w, relu in shapes:
        x = _bn_input((32, c, h, w), dtype, cuda)
        gamma = torch.rand(c, device=cuda) + 0.5
        beta = torch.randn(c, device=cuda)
        mean, var = kernels.bn_stats(x)
        x2 = kernels.rows_view(x)
        pm, pv = kernels.bn_stats_plain(x2)
        ex2 = float((x2.float() ** 2).mean(0).max())
        torch.testing.assert_close(mean, pm, rtol=0, atol=1e-5 * ex2)
        torch.testing.assert_close(var, pv, rtol=0, atol=1e-5 * ex2)
        rm, rv = torch.zeros(c, device=cuda), torch.ones(c, device=cuda)
        y, _, _ = kernels.fused_bn_train(x, gamma, beta, rm, rv, relu=relu)
        scale, bias = kernels.bn_scale_bias(gamma, beta, mean, var, 1e-5,
                                            dtype)
        assert torch.equal(kernels.rows_view(y),
                           kernels.bn_act_plain(x2, scale, bias, relu)), \
            (c, h, w)
        y = kernels.fused_bn_inference(x, gamma, beta, rm, rv, relu=relu)
        scale, bias = kernels.bn_scale_bias(gamma, beta, rm, rv, 1e-5, dtype)
        assert torch.equal(kernels.rows_view(y),
                           kernels.bn_act_plain(x2, scale, bias, relu)), \
            (c, h, w)


def test_bn_kernels_refuse_float64_on_the_card(cuda):
    """float64 runs the plain versions on the CPU only: on the card the
    wrappers raise rather than fall back."""
    x = torch.zeros(4, 8, dtype=torch.float64, device=cuda)
    ones = torch.ones(8, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float64 on the CPU"):
        kernels.bn_stats(x)
    with pytest.raises(TypeError, match="float64 on the CPU"):
        kernels.bn_act(x, ones, ones)


# --- the detectors (SSD, FasterRCNNMini) and the NMS scan kernel -----------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,size,batch,kw", DETECTORS)
def test_detector_bn_kernels_at_every_convbn_shape(cuda, name, size, batch,
                                                   kw, dtype):
    """Pass 1 and pass 2 at every (rows, C) a detector's ConvBNs give them
    at its card batch (SSD at 300: C 32 over 150^2 x 32 rows down to C 128
    over 3^2 x 32; FasterRCNNMini at 512: C 32 over 256^2 x 8 ...): pass 1
    within 1e-5 of E[x^2] of its plain version, pass 2 (ReLU fused) and the
    inference kernel bit-equal to ``bn_act_plain``."""
    for c, h, w in DETECTOR_BN_CHW[name]:
        x = _bn_input((batch, c, h, w), dtype, cuda)
        gamma = torch.rand(c, device=cuda) + 0.5
        beta = torch.randn(c, device=cuda)
        mean, var = kernels.bn_stats(x)
        x2 = kernels.rows_view(x)
        pm, pv = kernels.bn_stats_plain(x2)
        ex2 = float((x2.float() ** 2).mean(0).max())
        torch.testing.assert_close(mean, pm, rtol=0, atol=1e-5 * ex2)
        torch.testing.assert_close(var, pv, rtol=0, atol=1e-5 * ex2)
        rm, rv = torch.zeros(c, device=cuda), torch.ones(c, device=cuda)
        y, _, _ = kernels.fused_bn_train(x, gamma, beta, rm, rv, relu=True)
        scale, bias = kernels.bn_scale_bias(gamma, beta, mean, var, 1e-5,
                                            dtype)
        assert torch.equal(kernels.rows_view(y),
                           kernels.bn_act_plain(x2, scale, bias, True)), \
            (c, h, w)
        y = kernels.fused_bn_inference(x, gamma, beta, rm, rv, relu=True)
        scale, bias = kernels.bn_scale_bias(gamma, beta, rm, rv, 1e-5, dtype)
        assert torch.equal(kernels.rows_view(y),
                           kernels.bn_act_plain(x2, scale, bias, True)), \
            (c, h, w)


def _sorted_boxes(g, b, n, classes, dev, kind="clustered"):
    """``b`` images of ``n`` clustered boxes (many overlaps), sorted best
    score first, with labels in that order: uniform over ``classes``, or
    (``kind``) one label holding 90 % of the boxes, or -5 and 100,000."""
    centers = torch.rand(b, 12, 2, generator=g) * 0.8 + 0.1
    pick = torch.randint(0, 12, (b, n), generator=g)
    c = torch.gather(centers, 1, pick[..., None].expand(b, n, 2)) \
        + torch.randn(b, n, 2, generator=g) * 0.03
    wh = torch.rand(b, n, 2, generator=g) * 0.2 + 0.05
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
    scores = torch.rand(b, n, generator=g)
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
    labels = torch.randint(0, classes, (b, n), generator=g,
                           dtype=torch.int32)
    if kind == "one_label_90":
        labels = torch.where(torch.rand(b, n, generator=g) < 0.9,
                             torch.full_like(labels, classes // 2), labels)
    elif kind == "extreme_labels":
        labels = torch.where(labels % 2 == 0, torch.full_like(labels, -5),
                             torch.full_like(labels, 100000))
    return boxes.contiguous().to(dev), labels.to(dev)


# (B, N, classes, labelled, kind, threshold): SSD300's call and smaller
# ones; one label holding 90 % of SSD300's anchors; a single run of more
# than 2,048 boxes (its removed words in shared memory); labels -5 and
# 100,000; a labelled threshold < 0 (two labels' boxes suppress each
# other: one run, labels compared); FasterRCNNMini's unlabelled proposals
_NMS_CASES = [(4, n, classes, labelled, "clustered", thr)
              for n, classes, labelled in [
                  (7756, 20, True), (7756, 1, False), (256, 1, False),
                  (65, 3, True), (1, 2, True), (64, 4, True)]
              for thr in (0.45, 0.7)] + [
    (4, 7756, 20, True, "one_label_90", 0.45),
    (4, 7756, 20, True, "one_label_90", 0.7),
    (4, 3000, 1, True, "clustered", 0.45),
    (4, 500, 2, True, "extreme_labels", 0.45),
    (4, 7756, 20, True, "clustered", -0.1),
    (4, 500, 2, True, "extreme_labels", -0.1),
    (8, 256, 1, False, "clustered", 0.7)]


@pytest.mark.parametrize("b,n,classes,labelled,kind,thr", _NMS_CASES)
def test_nms_scan_kernel_matches_plain(cuda, b, n, classes, labelled, kind,
                                       thr):
    """The scan kernel's keep mask equals its plain version's on the same
    sorted boxes, exactly (the same correctly rounded IoU), with counts
    that stop short, at 0 and at every box; one launch a call."""
    g = torch.Generator().manual_seed(n + classes)
    boxes, labels = _sorted_boxes(g, b, n, classes, cuda, kind)
    counts = torch.tensor(([n, n // 2, 0, max(n - 1, 0)] * 2)[:b],
                          dtype=torch.int32, device=cuda)
    lab = labels if labelled else None
    before = kernels.nms_keep.launches
    keep = kernels.nms_keep(boxes, lab, counts, thr)
    assert kernels.nms_keep.launches == before + 1
    want = kernels.nms_keep_plain(boxes.cpu(), None if lab is None
                                  else lab.cpu(), counts.cpu(), thr)
    assert torch.equal(keep.cpu(), want)
    assert not keep[2].any() and keep[0].any()
    if kind == "clustered" and labelled and n == 3000:  # one long run
        assert int(want[0].sum()) > 1 and n > 2048


def test_nms_scan_kernel_waits_for_no_host_sync(cuda):
    """The whole card path (the label reorder and both kernels) at
    SSD300's call runs under ``set_sync_debug_mode("error")``, which
    raises on any op that waits for the card; the result is then held
    against the plain version."""
    g = torch.Generator().manual_seed(5)
    boxes, labels = _sorted_boxes(g, 32, 7756, 20, cuda)
    counts = torch.randint(0, 7757, (32,), generator=g,
                           dtype=torch.int32).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keep = kernels.nms_keep(boxes, labels, counts, 0.45)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = kernels.nms_keep_plain(boxes.cpu(), labels.cpu(), counts.cpu(),
                                  0.45)
    assert torch.equal(keep.cpu(), want)


def test_nms_scan_scratch_is_a_window(cuda):
    """One unlabelled call at SSD300's (32, 7,756) (no reorder) allocates
    its mask window of 32 words a row and ``keep``, no more: the
    allocator's peak over the call, against what was allocated before it,
    with 2 MiB of the allocator's rounding."""
    g = torch.Generator().manual_seed(11)
    boxes, _ = _sorted_boxes(g, 32, 7756, 1, cuda)
    counts = torch.full((32,), 7756, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    keep = kernels.nms_keep(boxes, None, counts, 0.45)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    window = 32 * 32 * 7756 * 8
    assert window <= peak <= window + keep.numel() + 2 ** 21, peak


def test_nms_label_runs_on_card_matches_cpu(cuda):
    """The label reorder on the card gives the CPU's permutation, boxes
    and labels (a stable sort has one answer)."""
    g = torch.Generator().manual_seed(9)
    boxes, labels = _sorted_boxes(g, 4, 7756, 20, torch.device("cpu"),
                                  "one_label_90")
    counts = torch.tensor([7756, 3000, 0, 1], dtype=torch.int32)
    want = kernels.nms_label_runs(boxes, labels, counts)
    got = kernels.nms_label_runs(boxes.to(cuda), labels.to(cuda),
                                 counts.to(cuda))
    for w, x in zip(want, got):
        assert torch.equal(x.cpu(), w)


def test_nms_scan_kernel_refuses_float64_on_the_card(cuda):
    boxes = torch.zeros(1, 4, 4, dtype=torch.float64, device=cuda)
    counts = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        kernels.nms_keep(boxes, None, counts, 0.5)


def test_detection_stages_on_card_match_cpu(cuda):
    """``ssd_detect`` at SSD300's 7,756 anchors (batch 4, 21 classes) and
    ``rcnn_detect`` on the same seeded model outputs on the card and on the
    CPU: labels equal, scores and boxes within 1e-6 of the largest."""
    g = torch.Generator().manual_seed(5)
    from dt_tpu_torch.ops.detection import multibox_prior
    anchors = torch.cat([multibox_prior((s, s), (0.2, 0.3), (1.0, 2.0, 0.5))
                         for s in (38, 19, 10, 5, 3)])
    cls = torch.randn(4, anchors.shape[0], 21, generator=g) * 2
    box = torch.randn(4, anchors.shape[0], 4, generator=g) * 0.5
    rois = torch.rand(4, 32, 2, generator=g) * 400
    out = {"rois": torch.cat([rois, rois + 20 + torch.rand(
        4, 32, 2, generator=g) * 80], -1),
        "cls_scores": torch.randn(4, 32, 4, generator=g),
        "box_deltas": torch.randn(4, 32, 4, generator=g) * 0.2}
    for got, want in (
            (models.ssd_detect(cls.to(cuda), box.to(cuda), anchors.to(cuda)),
             models.ssd_detect(cls, box, anchors)),
            (models.rcnn_detect({k: v.to(cuda) for k, v in out.items()}),
             models.rcnn_detect(out))):
        assert torch.equal(got[0].cpu(), want[0])
        assert (want[0] >= 0).any() and (want[0] < 0).any()
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("name,size,batch,kw", DETECTORS)
def test_detector_eval_on_card_matches_cpu(cuda, name, size, batch, kw,
                                           monkeypatch):
    """Each detector's f32 eval forward (TF32 off) at 96x96, batch 2, on
    the card against the CPU: every output within 1e-4 of its largest."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = models.init_params(models.create(name, device="cpu", **kw), seed=1)
    card = models.create(name, device=cuda, **kw)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(2, 3, 96, 96, generator=torch.Generator().manual_seed(2)
                   ).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        got, want = card(x.to(cuda)), cpu(x)
    if name == "ssd":
        got, want = dict(enumerate(got)), dict(enumerate(want))
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0,
                                   atol=1e-4 * float(want[k].abs().max()))


# --- the int8 convolution kernel (csrc/qconv.cu) -----------------------------

#: (batch, H, W, C, kh, kw, N, stride, pads): ResNet-50 v1's stem, a 3x3,
#: 1x1 and strided 1x1 of its blocks, the head as a 1x1, the quantize
#: example's MLP (M 1024: 64 -> 128 and its 4-column head), ragged shapes
#: (C and N off 16, K tails, M tails), and the edges of the wgmma tiling:
#: M tails past 128-pixel tiles, N tails at BN 64 and 128, K not a
#: multiple of 32 or 128 (C 16 x 9 taps, C 48), C 1, 3 and 4 (padded to
#: 16), a strided 1x1 on the gather route
_QCONV_CASES = [
    (2, 224, 224, 3, 7, 7, 64, (2, 2), ((2, 3), (2, 3))),
    (2, 56, 56, 64, 3, 3, 64, (1, 1), ((1, 1), (1, 1))),
    (2, 56, 56, 256, 1, 1, 128, (2, 2), ((0, 0), (0, 0))),
    (2, 14, 14, 256, 3, 3, 256, (1, 1), ((1, 1), (1, 1))),
    (32, 1, 1, 2048, 1, 1, 1000, (1, 1), ((0, 0), (0, 0))),
    (256, 1, 1, 64, 1, 1, 128, (1, 1), ((0, 0), (0, 0))),
    (256, 1, 1, 128, 1, 1, 4, (1, 1), ((0, 0), (0, 0))),
    (3, 9, 11, 5, 3, 2, 7, (2, 1), ((1, 0), (0, 2))),
    (1, 1, 1, 133, 1, 1, 17, (1, 1), ((0, 0), (0, 0))),
    (5, 6, 6, 48, 5, 5, 80, (1, 1), ((2, 2), (2, 2))),
    (1024, 1, 1, 64, 1, 1, 128, (1, 1), ((0, 0), (0, 0))),
    (1024, 1, 1, 128, 1, 1, 4, (1, 1), ((0, 0), (0, 0))),
    (1, 1, 129, 48, 1, 1, 65, (1, 1), ((0, 0), (0, 0))),
    (4, 64, 66, 32, 1, 1, 200, (1, 1), ((0, 0), (0, 0))),
    (2, 9, 15, 16, 3, 3, 136, (1, 1), ((1, 1), (1, 1))),
    (2, 7, 5, 1, 3, 3, 9, (1, 1), ((1, 1), (1, 1))),
    (3, 8, 8, 4, 2, 2, 24, (2, 2), ((0, 0), (0, 0))),
    (4, 10, 10, 64, 1, 1, 136, (2, 2), ((0, 0), (0, 0))),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _QCONV_CASES)
def test_qconv_kernel_matches_plain_bitwise(cuda, case, dtype):
    b, h, w, c, kh, kw, n, stride, pads = case
    g = torch.Generator(device="cpu").manual_seed(sum(case[:7]))
    x = torch.randint(-127, 128, (b, h, w, c), generator=g,
                      dtype=torch.int8).to(cuda)
    wt = torch.randint(-127, 128, (kh, kw, c, n), generator=g,
                       dtype=torch.int8).to(cuda)
    bias = torch.randn(n, generator=g).to(cuda)
    d = torch.full((), 0.0123, dtype=torch.float32, device=cuda)
    route = kernels.qconv_plan(x.shape, wt.shape, stride, pads, dtype).route
    for bb in (None, bias):
        before = kernels.qconv.launches
        routed = kernels.qconv.routes[route]
        got = kernels.qconv(x, wt, stride, pads, d, bb, dtype)
        again = kernels.qconv(x, wt, stride, pads, d, bb, dtype)
        assert kernels.qconv.launches == before + 2
        assert kernels.qconv.routes[route] == routed + 2
        want = kernels.qconv_plain(x, wt, stride, pads, d, bb, dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want) and torch.equal(got, again)
    # the accumulator alone: divisor 1, float32 (exact below 2^24 here)
    acc = kernels.qconv(x, wt, stride, pads, torch.ones((), device=cuda))
    ref = kernels.qconv_acc_plain(x, wt, stride, pads).float()
    assert torch.equal(acc, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qconv_epilogue_division_is_exact(cuda, dtype):
    """The epilogue's division is the correctly rounded one at every
    divisor a quantized model meets (x_scale * w_scale from 1e-9 to 1e9,
    either sign, and reciprocals exact in binary) and at accumulators
    from 0 to ~1e6: bit-equal to the plain version's ``acc / divisor``."""
    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randint(-127, 128, (8, 32, 32, 256), generator=g,
                      dtype=torch.int8)
    x[:, :4] = 0  # whole rows of zero accumulators
    x[:, 4:8, :, 1:] = 0  # small ones: a single product
    x = x.to(cuda)
    wt = torch.randint(-127, 128, (1, 1, 256, 64), generator=g,
                       dtype=torch.int8).to(cuda)
    nopad = ((0, 0), (0, 0))
    rng = np.random.RandomState(12)
    divisors = [float(v) for v in np.geomspace(1e-9, 1e9, 37)
                * rng.uniform(1, 2, 37)] + [0.25, 3.0, 1.0, 2.0 ** -20]
    for dv in divisors + [-v for v in divisors[::6]]:
        d = torch.full((), dv, dtype=torch.float32, device=cuda)
        got = kernels.qconv(x, wt, (1, 1), nopad, d, None, dtype)
        want = kernels.qconv_plain(x, wt, (1, 1), nopad, d, None, dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, want), dv


@pytest.mark.parametrize("c", [3, 16, 40])
def test_qconv_pack_matches_plain(cuda, c):
    """``dt_qconv_pack`` against ``qconv_pack_plain`` (the narrow route's
    layout at C 3): one launch a weight, none for a second call on a fresh
    view of it."""
    g = torch.Generator(device="cpu").manual_seed(c)
    wt = torch.randint(-127, 128, (3, 3, c, 72), generator=g,
                       dtype=torch.int8).to(cuda)
    cp, kwp = (4, 8) if c <= 4 else (-(-c // 16) * 16, 3)
    before = kernels.qconv_pack.launches
    got = kernels.qconv_pack(wt.reshape(3, 3, c, 72), cp, kwp)
    again = kernels.qconv_pack(wt.reshape(3, 3, c, 72), cp, kwp)
    assert kernels.qconv_pack.launches == before + 1 and again is got
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.qconv_pack_plain(wt, cp, kwp))


def test_qconv_pack_cache_never_serves_a_stale_weight(cuda):
    """The packed copy is made anew after an in-place write to the weight
    (through a fresh view, as ``quantized_dense`` makes one every call),
    and a weight freed and another allocated at its address gets its own
    copy: each call equals the plain version on the weight it was given."""
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randint(-127, 128, (2, 4, 4, 40), generator=g,
                      dtype=torch.int8).to(cuda)
    d = torch.full((), 0.25, device=cuda)
    nopad = ((0, 0), (0, 0))

    def call(wt):
        packs = kernels.qconv_pack.launches
        got = kernels.qconv(x, wt.reshape(1, 1, 40, 24), (1, 1), nopad, d)
        want = kernels.qconv_plain(x, wt.reshape(1, 1, 40, 24), (1, 1),
                                   nopad, d)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        return kernels.qconv_pack.launches - packs

    wt = torch.randint(-127, 128, (40, 24), generator=g,
                       dtype=torch.int8).to(cuda)
    assert call(wt) == 1 and call(wt) == 0
    wt.reshape(1, 1, 40, 24)[0, 0, 3, 5] = -wt[3, 5] - 1  # in place
    assert call(wt) == 1 and call(wt) == 0
    ptr = wt.data_ptr()
    del wt
    wt2 = torch.randint(-127, 128, (40, 24), generator=g,
                        dtype=torch.int8).to(cuda)
    assert wt2.data_ptr() == ptr  # the allocator's freed block, reused
    assert call(wt2) == 1


def test_qconv_kernel_misaligned_and_sliced_inputs(cuda):
    """A batch slice starting off a 16-byte boundary (the wrapper copies it
    to an aligned tensor with its channels padded to 64) and a
    non-contiguous weight view (packed from a contiguous copy)."""
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randint(-127, 128, (3, 5, 5, 48), generator=g,
                      dtype=torch.int8).to(cuda)
    big = torch.randint(-127, 128, (1, 1, 48, 64), generator=g,
                        dtype=torch.int8).to(cuda)
    xs = x.reshape(-1)[1:1 + 2 * 5 * 5 * 48].reshape(2, 5, 5, 48)
    assert xs.data_ptr() % 16 != 0
    ws = big[:, :, :, ::2]
    d = torch.full((), 0.5, device=cuda)
    got = kernels.qconv(xs, ws, (1, 1), ((0, 0), (0, 0)), d)
    want = kernels.qconv_plain(xs.contiguous(), ws.contiguous(), (1, 1),
                               ((0, 0), (0, 0)), d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_quantized_ops_on_card_match_cpu(cuda):
    """``quantize`` (weak and float32 scales, bfloat16 input),
    ``quantized_conv2d`` and ``quantized_dense`` on the card against the
    same functions on the CPU, bit for bit; one kernel launch a call."""
    from dt_tpu_torch.ops import quantization as Q
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.normal(0, 1, (4, 15, 13, 32))
                         .astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.2, (3, 3, 32, 40))
                         .astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 1, 40).astype(np.float32))
    for lo, hi in [(-2.5, 2.5), (torch.tensor(-2.5), torch.tensor(2.5))]:
        for dt in (torch.float32, torch.bfloat16):
            qc, sc = Q.quantize(x.to(cuda, dt), lo, hi)
            qh, sh = Q.quantize(x.to(dt), lo, hi)
            assert torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh)
    wq, ws = Q.quantize(w, -float(w.abs().max()), float(w.abs().max()))
    xq, xs = Q.quantize(x, -2.5, 2.5)
    for dt in (torch.float32, torch.bfloat16):
        for pad in ("SAME", "VALID", ((0, 1), (2, 1))):
            before = kernels.qconv.launches
            got = Q.quantized_conv2d(xq.to(cuda), wq.to(cuda), xs.to(cuda),
                                     ws.to(cuda), 2, pad, bias.to(cuda), dt)
            assert kernels.qconv.launches == before + 1
            want = Q.quantized_conv2d(xq, wq, xs, ws, 2, pad, bias, dt)
            assert torch.equal(got.cpu(), want)
        got = Q.quantized_dense(xq.reshape(-1, 32).to(cuda),
                                wq[0, 0].to(cuda), xs, ws, bias.to(cuda), dt)
        want = Q.quantized_dense(xq.reshape(-1, 32), wq[0, 0], xs, ws, bias,
                                 dt)
        assert torch.equal(got.cpu(), want)


def test_onnx_predictor_on_card_matches_cpu(cuda):
    """A port-exported ResNet-18 (batch 2) served by ``Predictor.from_onnx``
    on the card and on the CPU, within 1e-4 of the largest logit."""
    from dt_tpu_torch import onnx as tonnx
    from dt_tpu_torch.predictor import Predictor
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = models.create("resnet18", device="cpu", num_classes=10)
    rng = np.random.RandomState(3)
    for p in cpu.parameters():
        p.data = torch.from_numpy(rng.normal(0, 0.1, p.shape)
                                  .astype(np.float32)).to(
            memory_format=torch.channels_last if p.dim() == 4 else
            torch.contiguous_format)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    blob = tonnx.export_onnx(cpu, x)
    card = Predictor.from_onnx(blob, batch_buckets=[2], device=cuda)
    host = Predictor.from_onnx(blob, batch_buckets=[2], device="cpu")
    req = rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    got, want = card.predict(req), host.predict(req)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
