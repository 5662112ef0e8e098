"""The port's augmenters against the JAX package's, on the CPU.

Every augmenter, both recipes and the detection chain get the same seeded
u8 and f32 images and a ``RandomState`` of the same seed, call after call
(and, where it has one, its own seeded stream): the outputs must be equal
bit for bit, dtype included.  The JAX package runs ``Resize("native")`` and
``FusedCropMirrorNormalize`` through its native layer (``dt_tpu.native``,
built here); the port computes both in numpy and is also held against the
native functions directly, on odd sizes, upscales and downscales.
"""

import numpy as np
import pytest

from dt_tpu import native
from dt_tpu.data import augment as jaug
from dt_tpu_torch.data import augment as taug
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

CALLS = 6  # calls of each augmenter, each with the stream's next draws

_SAMPLERS = [{"min_scale": 0.5, "max_scale": 1.0, "min_overlap": 0.3,
              "trials": 10}, {"min_scale": 0.3, "max_scale": 0.9,
                              "max_overlap": 0.8, "trials": 5}]

#: name -> a constructor taking the augment module (same arguments both)
CLASSIFY = {
    "compose": lambda m: m.Compose(m.RandomCrop((9, 11), seed=1),
                                   m.RandomMirror(seed=2)),
    "random_crop": lambda m: m.RandomCrop((10, 12), seed=3),
    "random_crop_pad": lambda m: m.RandomCrop((16, 16), pad=3, seed=3),
    "center_crop": lambda m: m.CenterCrop((7, 9)),
    "random_mirror": lambda m: m.RandomMirror(seed=4),
    "resize_pil_down": lambda m: m.Resize((9, 7)),
    "resize_pil_up": lambda m: m.Resize((23, 31)),
    "resize_native_down": lambda m: m.Resize((9, 7), backend="native"),
    "resize_native_up": lambda m: m.Resize((29, 37), backend="native"),
    "normalize": lambda m: m.Normalize([123.68, 116.779, 103.939],
                                       [58.393, 57.12, 57.375]),
    "color_jitter": lambda m: m.ColorJitter(0.4, 0.3, 0.5, seed=5),
    "random_resized_crop": lambda m: m.RandomResizedCrop((11, 13), seed=6),
    "pca_lighting": lambda m: m.PCALighting(0.1, seed=7),
    "hsl_jitter": lambda m: m.HSLJitter(36, 50, 50, seed=8),
    "fused": lambda m: m.FusedCropMirrorNormalize(
        (12, 14), [120.0, 110.0, 100.0], [60.0, 55.0, 50.0], seed=9),
    "fused_pad": lambda m: m.FusedCropMirrorNormalize(
        (17, 19), [127.5], [127.5], pad=2, mirror_prob=0.7, seed=9),
    "cifar_recipe": lambda m: m.cifar_train_augmenter(seed=10),
    "imagenet_recipe": lambda m: m.imagenet_train_augmenter(size=12,
                                                            seed=11),
    "imagenet_recipe_full": lambda m: m.imagenet_train_augmenter(
        size=12, seed=12, random_resized_crop=True, pca_noise=0.1,
        random_h=36, random_s=50, random_l=50),
}

DETECT = {
    "det_compose": lambda m: m.DetCompose(m.DetRandomMirror(seed=1),
                                          m.DetRandomPad(prob=0.8, seed=2)),
    "det_image_only": lambda m: m.DetImageOnly(m.ColorJitter(0.3, seed=3)),
    "det_random_mirror": lambda m: m.DetRandomMirror(prob=0.6, seed=4),
    "det_random_pad": lambda m: m.DetRandomPad(prob=0.9, max_pad_scale=3.0,
                                               fill_value=100, seed=5),
    "det_random_crop": lambda m: m.DetRandomCrop(prob=1.0, seed=6),
    "det_random_crop_overlap": lambda m: m.DetRandomCrop(
        samplers=_SAMPLERS, prob=0.9, emit_mode="overlap",
        emit_overlap_thresh=0.2, seed=7),
    "det_color_distort": lambda m: m.DetColorDistort(
        max_random_hue=18, random_hue_prob=0.7, max_random_saturation=32,
        random_saturation_prob=0.7, max_random_illumination=32,
        random_illumination_prob=0.7, max_random_contrast=0.3,
        random_contrast_prob=0.7, seed=8),
    "ssd_recipe": lambda m: m.ssd_train_augmenter(seed=9),
}


def _images(dtype, n=CALLS, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = rng.randint(0, 256, (36, 40, 3))
        out.append(img.astype(np.uint8) if dtype == "u8"
                   else (img + rng.uniform(0, 1, img.shape))
                   .astype(np.float32))
    return out


def _boxes(rng):
    k = rng.randint(1, 5)
    x0 = rng.uniform(0, 0.6, (k, 2))
    return np.concatenate([rng.randint(0, 4, (k, 1)), x0,
                           x0 + rng.uniform(0.05, 0.4, (k, 2))],
                          1).astype(np.float32)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("name", sorted(CLASSIFY) + sorted(DETECT))
def test_augmenter_matches_bit_for_bit(name, dtype):
    """A shared ``RandomState`` stream (the iterators' per-record path) and
    then each augmenter's own seeded stream (``rng=None``)."""
    det = name in DETECT
    make = DETECT[name] if det else CLASSIFY[name]
    jm, tm = make(jaug), make(taug)
    jr, tr = np.random.RandomState(21), np.random.RandomState(21)
    brng = np.random.RandomState(5)
    for own in (False, True):
        for img in _images(dtype):
            if det:
                boxes = _boxes(brng)
                ji, jb = jm(img.copy(), boxes.copy(), None if own else jr)
                ti, tb = tm(img.copy(), boxes.copy(), None if own else tr)
                _same(np.asarray(ti), np.asarray(ji))
                _same(np.asarray(tb), np.asarray(jb))
            else:
                _same(np.asarray(tm(img.copy(), None if own else tr)),
                      np.asarray(jm(img.copy(), None if own else jr)))
    # both streams consumed the same draws
    assert tr.rand() == jr.rand()


@pytest.mark.parametrize("src", [(1, 1), (5, 7), (20, 24), (31, 17),
                                 (64, 48)])
@pytest.mark.parametrize("dst", [(1, 1), (3, 5), (13, 11), (24, 20),
                                 (97, 61)])
def test_resize_native_equals_the_native_kernel(src, dst):
    img = np.random.RandomState(sum(src) + sum(dst)).randint(
        0, 256, src + (3,)).astype(np.uint8)
    want = native.resize_bilinear(img, *dst)
    assert want is not None  # the native layer is built here
    _same(taug.resize_bilinear(img, *dst), want)
    _same(taug.Resize(dst, backend="native")(img), want)


@pytest.mark.parametrize("pad", [0, 4])
@pytest.mark.parametrize("mean,std", [([127.5], [127.5]),
                                      ([123.68, 116.779, 103.939],
                                       [58.393, 57.12, 57.375])])
def test_fused_crop_mirror_normalize_equals_the_native_kernel(pad, mean,
                                                              std):
    rng = np.random.RandomState(pad)
    aug = taug.FusedCropMirrorNormalize((16, 18), mean, std, pad=pad)
    for i in range(8):
        img = rng.randint(0, 256, (21, 25, 3)).astype(np.uint8)
        draws = np.random.RandomState(i)
        got = aug(img, rng=np.random.RandomState(i))
        src = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
        y = draws.randint(0, src.shape[0] - 16 + 1)
        x = draws.randint(0, src.shape[1] - 18 + 1)
        mirror = draws.rand() < 0.5
        want = native.crop_mirror_norm(src, y, x, 16, 18, mirror, aug.mean,
                                       aug.std)
        assert want is not None
        _same(got, want)
