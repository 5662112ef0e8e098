"""The int8 convolution kernel's layouts and launch plan, on the CPU.

``csrc/qconv.cu`` reads the weight packed K-major (``qconv_pack``, made
once and cached on the card), x with its channels padded to a multiple of
16 (to 4 on the narrow route, the stem's), and launches with the tile and
route that ``qconv_plan`` picks.  The
kernel runs only on the card (``tests/test_torch_cuda.py`` holds it
against ``qconv_plain`` there); here the plain packing is held against the
HWIO weight reshaped, the padding against the unpadded product, the plan
against the card's limits, and the pack cache's key against the views and
writes it must see, at every distinct convolution of ResNet-50 v1
(224x224, batch 32) and the ragged shapes of the card tests.
"""

import functools
import weakref

import numpy as np
import pytest
import torch

from dt_tpu_torch import models
from dt_tpu_torch.models.common import Conv, Dense
from dt_tpu_torch.ops import kernels
from dt_tpu_torch.ops import nn as nn_ops

_NO_PAD = ((0, 0), (0, 0))

#: (x NHWC, w HWIO, stride, pads, calls in a forward): every distinct
#: convolution of ResNet-50 v1 at 224x224, batch 32, and its dense head as a
#: 1x1 (``chip_smoke.py`` phase 26 (a)'s shapes)
RESNET50_QCONV = [
    ((32, 224, 224, 3), (7, 7, 3, 64), (2, 2), ((3, 3), (3, 3)), 1),
    ((32, 56, 56, 64), (1, 1, 64, 64), (1, 1), _NO_PAD, 1),
    ((32, 56, 56, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1)), 3),
    ((32, 56, 56, 64), (1, 1, 64, 256), (1, 1), _NO_PAD, 4),
    ((32, 56, 56, 256), (1, 1, 256, 64), (1, 1), _NO_PAD, 2),
    ((32, 56, 56, 256), (1, 1, 256, 128), (1, 1), _NO_PAD, 1),
    ((32, 56, 56, 128), (3, 3, 128, 128), (2, 2), ((0, 1), (0, 1)), 1),
    ((32, 28, 28, 128), (1, 1, 128, 512), (1, 1), _NO_PAD, 4),
    ((32, 56, 56, 256), (1, 1, 256, 512), (2, 2), _NO_PAD, 1),
    ((32, 28, 28, 512), (1, 1, 512, 128), (1, 1), _NO_PAD, 3),
    ((32, 28, 28, 128), (3, 3, 128, 128), (1, 1), ((1, 1), (1, 1)), 3),
    ((32, 28, 28, 512), (1, 1, 512, 256), (1, 1), _NO_PAD, 1),
    ((32, 28, 28, 256), (3, 3, 256, 256), (2, 2), ((0, 1), (0, 1)), 1),
    ((32, 14, 14, 256), (1, 1, 256, 1024), (1, 1), _NO_PAD, 6),
    ((32, 28, 28, 512), (1, 1, 512, 1024), (2, 2), _NO_PAD, 1),
    ((32, 14, 14, 1024), (1, 1, 1024, 256), (1, 1), _NO_PAD, 5),
    ((32, 14, 14, 256), (3, 3, 256, 256), (1, 1), ((1, 1), (1, 1)), 5),
    ((32, 14, 14, 1024), (1, 1, 1024, 512), (1, 1), _NO_PAD, 1),
    ((32, 14, 14, 512), (3, 3, 512, 512), (2, 2), ((0, 1), (0, 1)), 1),
    ((32, 7, 7, 512), (1, 1, 512, 2048), (1, 1), _NO_PAD, 3),
    ((32, 14, 14, 1024), (1, 1, 1024, 2048), (2, 2), _NO_PAD, 1),
    ((32, 7, 7, 2048), (1, 1, 2048, 512), (1, 1), _NO_PAD, 2),
    ((32, 7, 7, 512), (3, 3, 512, 512), (1, 1), ((1, 1), (1, 1)), 2),
    ((32, 1, 1, 2048), (1, 1, 2048, 1000), (1, 1), _NO_PAD, 1),
]

#: the ragged shapes of ``tests/test_torch_cuda.py``'s ``_QCONV_CASES``
#: (C and N off 16, K tails, M tails, C 1, 3 and 4, the MLP's head)
RAGGED_QCONV = [
    ((3, 9, 11, 5), (3, 2, 5, 7), (2, 1), ((1, 0), (0, 2))),
    ((1, 1, 1, 133), (1, 1, 133, 17), (1, 1), _NO_PAD),
    ((5, 6, 6, 48), (5, 5, 48, 80), (1, 1), ((2, 2), (2, 2))),
    ((256, 1, 1, 128), (1, 1, 128, 4), (1, 1), _NO_PAD),
    ((2, 7, 5, 1), (3, 3, 1, 9), (1, 1), ((1, 1), (1, 1))),
    ((3, 8, 8, 4), (2, 2, 4, 24), (2, 2), _NO_PAD),
]

_ALL = [c[:4] for c in RESNET50_QCONV] + RAGGED_QCONV
_ID = [f"{x}x{w}s{s}" for x, w, s, _ in _ALL]


def _int8(shape, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))


def test_resnet50_list_is_the_models_convolutions():
    """The shape list is the port's ResNet-50 v1: its convolutions (HWIO,
    NHWC, at batch 32) and its head, each distinct shape once, with its
    count in a forward."""
    model = models.create("resnet50", device="cpu").eval()
    seen = {}

    def hook(mod, args):
        x = args[0]
        if isinstance(mod, Conv):
            kh, kw = mod.weight.shape[2:]
            key = ((32, *x.shape[2:], x.shape[1]),
                   tuple(mod.weight.permute(2, 3, 1, 0).shape),
                   tuple(mod.strides),
                   nn_ops._pads(mod.padding, tuple(x.shape[2:]), (kh, kw),
                                mod.strides))
        else:
            key = ((32, 1, 1, x.shape[-1]), (1, 1, *mod.weight.t().shape),
                   (1, 1), _NO_PAD)
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    with torch.inference_mode():
        model(torch.zeros(1, 3, 224, 224))
    for h in hooks:
        h.remove()
    assert [(*k, n) for k, n in seen.items()] == RESNET50_QCONV
    assert sum(c[4] for c in RESNET50_QCONV) == 54


@pytest.mark.parametrize("case", _ALL, ids=_ID)
def test_pack_plain_is_hwio_reshaped(case):
    """Row n of the packed weight is w[:, :, :, n] over (ky, kx, c), the
    filter's rows padded by zero taps to KWp and its channels by zeros to
    Cp: the kernel's k order, (ky * KWp + kx) * Cp + c."""
    x_shape, w_shape, stride, pads = case
    kh, kw, c, n = w_shape
    wq = _int8(w_shape, sum(w_shape))
    plan = kernels.qconv_plan(x_shape, w_shape, stride, pads, torch.float32)
    cp, kwp = plan.cp, plan.kwp
    if plan.route == "narrow":
        assert (cp, kwp) == (4, 8) and c <= 4 and kw <= 8
    else:
        assert cp % 16 == 0 and c <= cp < c + 16 and kwp == kw
    packed = kernels.qconv_pack_plain(wq, cp, kwp)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (n, kh * kwp * cp)
    taps = packed.reshape(n, kh, kwp, cp)
    assert torch.equal(taps[:, :, :kw, :c], wq.permute(3, 0, 1, 2))
    assert not taps[:, :, kw:].any() and not taps[:, :, :, c:].any()
    if (cp, kwp) == (c, kw):
        assert torch.equal(packed, wq.reshape(kh * kw * c, n).t())
    # the CPU wrapper is the plain version, and counts no launch
    before = kernels.qconv_pack.launches
    assert torch.equal(kernels.qconv_pack(wq, cp, kwp), packed)
    assert kernels.qconv_pack.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _ALL, ids=_ID)
def test_plan_fits_the_card(case, dtype):
    """The plan's tile fits a block's shared memory, two blocks an SM; its
    grid covers the output; its route is the tma one exactly for 1x1,
    stride-1, unpadded layers; its stores are 16 bytes wide exactly where a
    row of the output is whole 16-byte chunks."""
    x_shape, w_shape, stride, pads = case
    kh, kw, c, n = w_shape
    plan = kernels.qconv_plan(x_shape, w_shape, stride, pads, dtype)
    oh, ow = kernels.qconv_out_hw(x_shape[1:3], (kh, kw), stride, pads)
    m = x_shape[0] * oh * ow
    assert plan.bn in (64, 128)
    # a block's limit on the H100: 227 KB of dynamic shared memory
    assert plan.smem == kernels.qconv_smem(plan.bn) <= 232_448
    # two blocks an SM: 228 KB, less 1 KB the card reserves a block
    assert 2 * (plan.smem + 1024) <= 228 * 1024
    assert plan.grid == -(-m // 128) * -(-n // plan.bn) > 0
    assert plan.kwp == (8 if plan.route == "narrow" else kw) >= kw
    one_by_one = (kh, kw) == (1, 1) and stride == (1, 1) and pads == _NO_PAD
    assert plan.route == ("tma" if one_by_one else "narrow"
                          if c <= 4 and kw <= 8 else "gather")
    esize = 4 if dtype == torch.float32 else 2
    assert plan.vec_out == (n * esize % 16 == 0)
    if n > 64 and plan.bn == 64:  # only where 128 would not fill the card
        assert -(-m // 128) * -(-n // 128) < kernels.QCONV_SMS


def test_resnet50_routes_and_tiles():
    """ResNet-50's forward: 13 of its 24 shapes (34 of 54 calls) on the tma
    route, the stem on the narrow one (2 steps of K where 16 channels would
    take 7), every output in 16-byte rows, BN 128 where N > 64 and 128-wide
    tiles still give the card's 132 SMs a block each (the 56^2 and 28^2
    layers past 64 channels), else 64 (the stem, the 64-channel layers, the
    14^2 and 7^2 layers of 256-512 channels and the head)."""
    plans = [(kernels.qconv_plan(x, w, s, p, torch.float32), calls)
             for x, w, s, p, calls in RESNET50_QCONV]
    assert sum(p.route == "tma" for p, _ in plans) == 13
    assert sum(calls for p, calls in plans if p.route == "tma") == 34
    assert all(p.vec_out for p, _ in plans)
    assert sum(p.bn == 128 for p, _ in plans) == 13
    assert [p.grid for p, _ in plans][:4] == [3136, 784, 784, 1568]
    stem = plans[0][0]
    assert (stem.route, stem.cp, stem.kwp) == ("narrow", 4, 8)
    assert 7 * stem.kwp * stem.cp <= 2 * 128  # 2 steps of K
    assert sum(p.route == "gather" for p, _ in plans) == 10
    assert plans[-1][0].bn == 64 and plans[-1][0].grid == 16  # the head


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    ((2, 30, 30, 3), (7, 7, 3, 64), (2, 2), ((3, 3), (3, 3)))]
    + RAGGED_QCONV, ids=lambda c: f"{c[0]}x{c[1]}")
def test_padded_channels_are_exact(case, dtype, bias):
    """``qconv_plain`` on x and w with their channels padded by zeros to Cp
    (as the kernel reads them) is bit-equal to the unpadded call."""
    x_shape, w_shape, stride, pads = case
    xq, wq = _int8(x_shape, 1), _int8(w_shape, 2)
    cp = kernels.qconv_plan(x_shape, w_shape, stride, pads, dtype).cp
    xp = kernels.qconv_pad_channels(xq, cp)
    assert xp.shape == (*x_shape[:3], cp) and xp.is_contiguous()
    assert torch.equal(xp[..., :x_shape[3]], xq) and not xp[...,
                                                             x_shape[3]:].any()
    wp = torch.nn.functional.pad(wq, (0, 0, 0, cp - w_shape[2]))
    d = torch.tensor(0.0173, dtype=torch.float32)
    b = torch.from_numpy(np.random.RandomState(3).normal(
        0, 1, w_shape[3]).astype(np.float32)) if bias else None
    want = kernels.qconv_plain(xq, wq, stride, pads, d, b, dtype)
    got = kernels.qconv_plain(xp, wp, stride, pads, d, b, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def test_pad_channels_keeps_an_aligned_tensor():
    xq = _int8((2, 4, 4, 32), 0)
    assert kernels.qconv_pad_channels(xq, 32) is xq
    view = xq.reshape(-1)[1:1 + 2 * 4 * 4 * 16].reshape(2, 4, 4, 16)
    copy = kernels.qconv_pad_channels(view, 16)  # off a 16-byte boundary
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


def test_pack_key_survives_views_and_sees_writes():
    """Fresh ``reshape`` views of one weight share a key and an owner (the
    base every view's version counter belongs to); a write through any view
    moves the version; another view of the storage has another key; an
    inference tensor, whose writes cannot be seen, has none."""
    w = _int8((64, 16), 0)
    k1, o1, v1 = kernels._pack_key(w.reshape(1, 1, 64, 16), 64, 1)
    k2, o2, v2 = kernels._pack_key(w.reshape(1, 1, 64, 16), 64, 1)
    assert k1 == k2 and o1 is w and o2 is w and v1 == v2
    assert kernels._pack_key(w.reshape(1, 1, 64, 16), 80, 1)[0] != k1
    assert kernels._pack_key(w.reshape(1, 1, 64, 16), 64, 8)[0] != k1
    assert kernels._pack_key(w[:32].reshape(1, 1, 32, 16), 32, 1)[0] != k1
    w.reshape(1, 1, 64, 16)[0, 0, 0, 0] += 1
    assert kernels._pack_key(w.reshape(1, 1, 64, 16), 64, 1)[2] > v1
    with torch.inference_mode():
        frozen = _int8((64, 16), 1).clone()
    assert kernels._pack_key(frozen.reshape(1, 1, 64, 16), 64, 1) == (
        None, None, None)


def test_pack_cache_entry_dies_with_its_owner():
    """An entry is dropped when its owner is freed, so a weight allocated
    later at the same address cannot be served the old copy."""
    w = _int8((1, 1, 32, 8), 4)
    key, owner, version = kernels._pack_key(w, 32, 1)
    kernels._QCONV_PACKS[key] = (
        weakref.ref(owner, functools.partial(kernels._drop_pack, key)),
        version, kernels.qconv_pack_plain(w, 32, 1))
    assert key in kernels._QCONV_PACKS
    del w, owner
    assert key not in kernels._QCONV_PACKS
