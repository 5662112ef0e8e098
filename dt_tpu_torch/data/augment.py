"""Host-side image augmentation (numpy, HWC uint8/float), the counterpart
of ``dt_tpu/data/augment.py``: the same augmenters drawing in the same
order from the ``RandomState`` they are given, so one record gives the same
pixels in both packages.

The JAX package runs two of them through its native layer
(``dt_tpu/native/augment.cc``) where that is built; the port computes both
in numpy with the native arithmetic: ``FusedCropMirrorNormalize`` (the
native kernel and the JAX package's numpy fallback agree byte for byte) and
``Resize(backend="native")`` (:func:`resize_bilinear`, the native
half-pixel bilinear with its float32 operation order and its rounding to
u8).  ``Resize(backend="pil")``, and so ``RandomResizedCrop`` and
``imagenet_train_augmenter``, need PIL, imported at the call; without it
they raise ``ImportError`` naming PIL (no switch to the other resample
convention, whose pixels differ).

Reference: ``src/io/image_aug_default.cc:1`` (DefaultImageAugmenter: resize,
random-resized crop ``:357-407``, random crop, random mirror, HSL jitter
``:495-520``, PCA lighting ``:522-545``, mean/std normalize) and the Python
augmenters in ``python/mxnet/image/image.py``.  Detection-side (image +
boxes transformed together): ``src/io/image_det_aug_default.cc`` —
IoU-constrained random crop samplers (``GenerateCropBox``/``TryCrop``),
random pad, mirror, color distortion.  Augmentation runs on host (like the
reference's OMP decode threads); normalization math mirrors the reference's
``mean_r/g/b``/``std_r/g/b`` params.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class Augmenter:
    """Composable augmenter: call with HWC array -> HWC array.

    Every stochastic augmenter draws from ``rng`` when given one and from
    its own seeded ``RandomState`` otherwise.  The explicit-``rng`` form is
    what lets :class:`dt_tpu_torch.data.recordio.ImageRecordIter` run the chain
    INSIDE its decode pool with a per-record stream (seed = record
    position), matching the reference's decode+augment-in-one-parallel-
    region design (``iter_image_recordio_2.cc:335,364``) while keeping the
    draws independent of thread scheduling.
    """

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        raise NotImplementedError


class Compose(Augmenter):
    def __init__(self, *augs: Augmenter):
        self.augs = augs

    def __call__(self, img, rng=None):
        for a in self.augs:
            img = a(img, rng)
        return img


class RandomCrop(Augmenter):
    """Pad-then-random-crop (the reference CIFAR recipe: pad 4, crop 32)."""

    def __init__(self, size: Tuple[int, int], pad: int = 0, seed: int = 0):
        self.size = size
        self.pad = pad
        self._rng = np.random.RandomState(seed)

    def __call__(self, img, rng=None):
        rng = self._rng if rng is None else rng
        if self.pad:
            img = np.pad(img, ((self.pad, self.pad), (self.pad, self.pad),
                               (0, 0)), mode="reflect")
        h, w = img.shape[:2]
        th, tw = self.size
        y = rng.randint(0, h - th + 1)
        x = rng.randint(0, w - tw + 1)
        return img[y:y + th, x:x + tw]


class CenterCrop(Augmenter):
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, img, rng=None):
        h, w = img.shape[:2]
        th, tw = self.size
        y = (h - th) // 2
        x = (w - tw) // 2
        return img[y:y + th, x:x + tw]


class RandomMirror(Augmenter):
    """Horizontal flip with p=0.5 (reference ``rand_mirror``)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.RandomState(seed)

    def __call__(self, img, rng=None):
        rng = self._rng if rng is None else rng
        if rng.rand() < 0.5:
            return img[:, ::-1]
        return img


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("Resize(backend='pil') needs PIL (Pillow), which "
                          "this host lacks; Resize(backend='native') "
                          "resizes u8 HWC-3 images without it") from e
    return Image


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Bilinear u8 HWC-3 resize with half-pixel centers (OpenCV
    ``INTER_LINEAR``), ``dt_tpu/native/augment.cc``
    ``dtaug_resize_bilinear`` in numpy: the same float32 operations in the
    same order, each rounded to float32 as the C code's are (no fused
    multiply-add), and the result truncated from ``v + 0.5``."""
    sh, sw = img.shape[:2]
    if sh <= 0 or sw <= 0 or dh <= 0 or dw <= 0:
        raise ValueError(f"bad resize {img.shape} -> ({dh},{dw})")
    f32 = np.float32

    def axis(d, s):
        f = (np.arange(d, dtype=f32) + f32(0.5)) * (f32(s) / f32(d)) \
            - f32(0.5)
        lo = f.astype(np.int64)  # (int) truncates toward zero
        neg = f < 0
        f[neg] = 0
        lo[neg] = 0
        return lo, np.minimum(lo + 1, s - 1), f - lo.astype(f32)

    y0, y1, wy = axis(dh, sh)
    x0, x1, wx = axis(dw, sw)
    src = img.astype(f32)
    r0, r1 = src[y0], src[y1]
    wx = wx[None, :, None]
    wy = wy[:, None, None]
    top = r0[:, x0] * (f32(1) - wx) + r0[:, x1] * wx
    bot = r1[:, x0] * (f32(1) - wx) + r1[:, x1] * wx
    v = top * (f32(1) - wy) + bot * wy
    return (v + f32(0.5)).astype(np.uint8)


class Resize(Augmenter):
    """Bilinear resize (reference ``resize`` augmenter).

    ``backend='pil'`` (default) keeps PIL's filtered resample;
    ``'native'`` is the half-pixel bilinear of :func:`resize_bilinear`
    (OpenCV INTER_LINEAR convention, numerically different from PIL's
    area-averaged downscale) for u8 HWC-3 inputs, and PIL for other
    inputs, as the JAX package's native backend does."""

    def __init__(self, size: Tuple[int, int], backend: str = "pil"):
        if backend not in ("pil", "native"):
            raise ValueError(backend)
        self.size = size
        self.backend = backend

    def __call__(self, img, rng=None):
        if self.backend == "native" and img.dtype == np.uint8 \
                and img.ndim == 3 and img.shape[2] == 3:
            return resize_bilinear(img, self.size[0], self.size[1])
        Image = _pil_image()
        mode = Image.fromarray(img.astype(np.uint8))
        return np.asarray(mode.resize((self.size[1], self.size[0]),
                                      Image.BILINEAR), img.dtype)


class Normalize(Augmenter):
    """(img - mean) / std per channel (reference mean_r/g/b, std_r/g/b)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, rng=None):
        return (img.astype(np.float32) - self.mean) / self.std


class ColorJitter(Augmenter):
    """Random brightness/contrast/saturation (reference
    ``random_color_jitter``)."""

    def __init__(self, brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, seed: int = 0):
        self.b, self.c, self.s = brightness, contrast, saturation
        self._rng = np.random.RandomState(seed)

    def __call__(self, img, rng=None):
        rng = self._rng if rng is None else rng
        img = img.astype(np.float32)
        if self.b:
            img = img * (1.0 + rng.uniform(-self.b, self.b))
        if self.c:
            coef = np.array([0.299, 0.587, 0.114], np.float32)
            alpha = 1.0 + rng.uniform(-self.c, self.c)
            gray_mean = (img * coef).sum(-1, keepdims=True).mean()
            img = img * alpha + gray_mean * (1 - alpha)
        if self.s:
            coef = np.array([0.299, 0.587, 0.114], np.float32)
            alpha = 1.0 + rng.uniform(-self.s, self.s)
            gray = (img * coef).sum(-1, keepdims=True)
            img = img * alpha + gray * (1 - alpha)
        return img


class RandomResizedCrop(Augmenter):
    """Area/aspect-sampled crop resized to ``size`` — the standard ImageNet
    ResNet preprocessing (reference ``random_resized_crop``,
    ``image_aug_default.cc:357-407``): sample an area fraction and an
    aspect ratio, randomly swap the crop's H/W (the reference's 0.5 swap),
    retry up to ``attempts`` times, else fall back to a center crop."""

    def __init__(self, size: Tuple[int, int],
                 area: Tuple[float, float] = (0.08, 1.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                 attempts: int = 10, seed: int = 0):
        self.size = size
        self.area = area
        self.ratio = ratio
        self.attempts = attempts
        self._rng = np.random.RandomState(seed)

    def __call__(self, img, rng=None):
        rng = self._rng if rng is None else rng
        h, w = img.shape[:2]
        area = float(h * w)
        for _ in range(self.attempts):
            target = area * rng.uniform(*self.area)
            r = rng.uniform(*self.ratio)
            ch = int(round(np.sqrt(target / r)))
            cw = int(round(np.sqrt(target * r)))
            if rng.rand() > 0.5:
                ch, cw = cw, ch
            if ch <= h and cw <= w:
                y = rng.randint(0, h - ch + 1)
                x = rng.randint(0, w - cw + 1)
                return Resize(self.size)(img[y:y + ch, x:x + cw])
        # fallback: largest center crop at the target aspect
        th, tw = self.size
        scale = min(h / th, w / tw)
        ch, cw = int(th * scale), int(tw * scale)
        return Resize(self.size)(CenterCrop((ch, cw))(img))


# The ImageNet RGB principal components, stored pre-scaled by their
# eigenvalues as the reference does (``image_aug_default.cc:555-559``,
# after Krizhevsky et al. 2012).  Rows = R,G,B output channels.
_PCA_EIGVEC_SCALED = np.array(
    [[55.46 * -0.5675, 4.794 * 0.7192, 1.148 * 0.4009],
     [55.46 * -0.5808, 4.794 * -0.0045, 1.148 * -0.8140],
     [55.46 * -0.5836, 4.794 * -0.6948, 1.148 * 0.4203]], np.float32)


class PCALighting(Augmenter):
    """AlexNet-style PCA color noise (reference ``pca_noise``,
    ``image_aug_default.cc:522-545``): one N(0, std) alpha per principal
    component, a single RGB shift for the whole image, clipped to u8."""

    def __init__(self, noise_std: float, seed: int = 0):
        self.std = float(noise_std)
        self._rng = np.random.RandomState(seed)

    def __call__(self, img, rng=None):
        rng = self._rng if rng is None else rng
        alpha = rng.normal(0.0, self.std, 3).astype(np.float32)
        shift = _PCA_EIGVEC_SCALED @ alpha  # (3,) RGB
        out = img.astype(np.float32) + shift
        if np.issubdtype(img.dtype, np.integer):
            return np.clip(out, 0, 255).astype(img.dtype)
        return np.clip(out, 0.0, 255.0)


def _rgb_to_hls_u8(img: np.ndarray) -> np.ndarray:
    """RGB u8 HWC -> HLS in OpenCV's u8 convention (H in [0,180),
    L/S in [0,255]), float32 for lossless round-tripping."""
    rgb = img.astype(np.float32) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    vmax = rgb.max(-1)
    vmin = rgb.min(-1)
    l = (vmax + vmin) / 2
    diff = vmax - vmin
    denom = np.where(l <= 0.5, vmax + vmin, 2.0 - vmax - vmin)
    s = np.where(diff > 0, diff / np.maximum(denom, 1e-12), 0.0)
    safe = np.maximum(diff, 1e-12)
    h = np.select(
        [vmax == r, vmax == g],
        [60 * (g - b) / safe, 120 + 60 * (b - r) / safe],
        240 + 60 * (r - g) / safe)
    h = np.where(diff > 0, np.mod(h, 360.0), 0.0)
    return np.stack([h / 2.0, l * 255.0, s * 255.0], axis=-1)


def _hls_to_rgb_u8(hls: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_rgb_to_hls_u8`; returns u8 RGB HWC."""
    h = (hls[..., 0] * 2.0) / 360.0
    l = hls[..., 1] / 255.0
    s = hls[..., 2] / 255.0
    m2 = np.where(l <= 0.5, l * (1 + s), l + s - l * s)
    m1 = 2 * l - m2

    def channel(hue):
        hue = np.mod(hue, 1.0)
        return np.select(
            [hue < 1 / 6, hue < 1 / 2, hue < 2 / 3],
            [m1 + (m2 - m1) * 6 * hue, m2,
             m1 + (m2 - m1) * (2 / 3 - hue) * 6],
            m1)

    rgb = np.stack([channel(h + 1 / 3), channel(h), channel(h - 1 / 3)],
                   axis=-1)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


class HSLJitter(Augmenter):
    """Additive jitter in HLS space (reference ``random_h/s/l``,
    ``image_aug_default.cc:495-520``): offsets drawn with the reference's
    pseudo-gaussian ``(u + 4u)/5`` scheme, added in OpenCV's u8 HLS ranges
    and clamped to their limits (H at [0,180], L/S at [0,255] — the
    reference saturates rather than wraps), converted back to RGB u8."""

    def __init__(self, random_h: int = 0, random_s: int = 0,
                 random_l: int = 0, seed: int = 0):
        self.random_h, self.random_s, self.random_l = \
            int(random_h), int(random_s), int(random_l)
        self._rng = np.random.RandomState(seed)

    def _offset(self, mag: int, rng) -> float:
        r = (rng.rand() + 4 * rng.rand()) / 5
        return r * mag * 2 - mag

    def __call__(self, img, rng=None):
        rng = self._rng if rng is None else rng
        if not (self.random_h or self.random_s or self.random_l):
            return img
        hls = _rgb_to_hls_u8(np.clip(img, 0, 255).astype(np.uint8))
        dh, ds, dl = (self._offset(self.random_h, rng),
                      self._offset(self.random_s, rng),
                      self._offset(self.random_l, rng))
        # reference clamps H at its [0,180] limit rather than wrapping
        hls[..., 0] = np.clip(hls[..., 0] + dh, 0, 180)
        hls[..., 1] = np.clip(hls[..., 1] + dl, 0, 255)
        hls[..., 2] = np.clip(hls[..., 2] + ds, 0, 255)
        out = _hls_to_rgb_u8(hls)
        return out if np.issubdtype(img.dtype, np.integer) \
            else out.astype(img.dtype)


class FusedCropMirrorNormalize(Augmenter):
    """The hot tail of every classification chain — (reflect-)pad +
    random crop + p=0.5 mirror + per-channel normalize — as ONE op.

    numpy with the arithmetic of the JAX package's native kernel
    (``dt_tpu/native/augment.cc`` ``dtaug_crop_mirror_norm``: the same
    subtraction and division in float32, so the outputs are byte-equal).
    Draw order: crop y, crop x, mirror, from one stream."""

    def __init__(self, size: Tuple[int, int], mean: Sequence[float],
                 std: Sequence[float], pad: int = 0,
                 mirror_prob: float = 0.5, seed: int = 0):
        self.size = size
        self.pad = pad
        self.mirror_prob = mirror_prob
        # per channel, as the JAX package broadcasts them for its kernel
        self.mean = np.broadcast_to(
            np.asarray(mean, np.float32), (3,)).copy()
        self.std = np.broadcast_to(
            np.asarray(std, np.float32), (3,)).copy()
        self._rng = np.random.RandomState(seed)

    def __call__(self, img, rng=None):
        rng = self._rng if rng is None else rng
        if self.pad:
            img = np.pad(img, ((self.pad, self.pad), (self.pad, self.pad),
                               (0, 0)), mode="reflect")
        h, w = img.shape[:2]
        th, tw = self.size
        y = rng.randint(0, h - th + 1)
        x = rng.randint(0, w - tw + 1)
        mirror = rng.rand() < self.mirror_prob
        crop = img[y:y + th, x:x + tw]
        if mirror:
            crop = crop[:, ::-1]
        return (crop.astype(np.float32) - self.mean) / self.std


def cifar_train_augmenter(seed: int = 0) -> Augmenter:
    """The reference's CIFAR-10 training recipe (``train_cifar10.py``:
    pad 4 + crop 32 + mirror, /255 normalize) as the fused op."""
    return FusedCropMirrorNormalize((32, 32), [127.5] * 3, [127.5] * 3,
                                    pad=4, seed=seed)


def imagenet_train_augmenter(size: int = 224, seed: int = 0,
                             random_resized_crop: bool = False,
                             pca_noise: float = 0.0,
                             random_h: int = 0, random_s: int = 0,
                             random_l: int = 0) -> Augmenter:
    """ImageNet training recipe, matching ``fit.py`` defaults; pass
    ``random_resized_crop=True, pca_noise=0.1, random_h=36, random_s=50,
    random_l=50`` for the reference's full ResNet recipe
    (``train_imagenet.py`` ``--random-crop/--pca-noise/--max-random-h/s/l``)."""
    crop = (RandomResizedCrop((size, size), seed=seed)
            if random_resized_crop else
            Compose(Resize((size + 32, size + 32)),
                    RandomCrop((size, size), seed=seed)))
    augs = [crop, RandomMirror(seed=seed + 1)]
    if random_h or random_s or random_l:
        augs.append(HSLJitter(random_h, random_s, random_l, seed=seed + 2))
    if pca_noise:
        augs.append(PCALighting(pca_noise, seed=seed + 3))
    augs.append(Normalize([123.68, 116.779, 103.939],
                          [58.393, 57.12, 57.375]))
    return Compose(*augs)


# ----------------------------------------------------------------------
# Detection augmenters: image + (k, 5+) boxes [class, x0, y0, x1, y1, ...]
# with CORNER COORDINATES NORMALIZED to [0, 1] (the reference det-record
# label convention, image_det_aug_default.cc ImageDetObject).
# ----------------------------------------------------------------------


class DetAugmenter:
    """Box-aware augmenter: ``(img, boxes) -> (img, boxes)``; same
    optional-``rng`` contract as :class:`Augmenter` (pass a per-record
    stream to run the chain inside the decode pool)."""

    def __call__(self, img: np.ndarray, boxes: np.ndarray,
                 rng=None) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class DetCompose(DetAugmenter):
    def __init__(self, *augs: DetAugmenter):
        self.augs = augs

    def __call__(self, img, boxes, rng=None):
        for a in self.augs:
            img, boxes = a(img, boxes, rng)
        return img, boxes


class DetImageOnly(DetAugmenter):
    """Lift an image-only augmenter (color jitter etc.) into the det chain
    — anything geometric would desynchronize the boxes, so only use with
    photometric transforms."""

    def __init__(self, aug: Augmenter):
        self.aug = aug

    def __call__(self, img, boxes, rng=None):
        return self.aug(img, rng), boxes


class DetRandomMirror(DetAugmenter):
    """Horizontal flip of image AND boxes (reference ``rand_mirror_prob`` +
    ``TryMirror``)."""

    def __init__(self, prob: float = 0.5, seed: int = 0):
        self.prob = prob
        self._rng = np.random.RandomState(seed)

    def __call__(self, img, boxes, rng=None):
        rng = self._rng if rng is None else rng
        if rng.rand() < self.prob:
            img = img[:, ::-1]
            if len(boxes):
                boxes = boxes.copy()
                x0 = boxes[:, 1].copy()
                boxes[:, 1] = 1.0 - boxes[:, 3]
                boxes[:, 3] = 1.0 - x0
        return img, boxes


class DetRandomPad(DetAugmenter):
    """Zoom-out: place the image on a larger filled canvas and rescale the
    boxes (reference ``rand_pad_prob``/``max_pad_scale`` +
    ``GeneratePadBox``/``TryPad``)."""

    def __init__(self, prob: float = 0.5, max_pad_scale: float = 4.0,
                 fill_value: int = 127, seed: int = 0):
        self.prob = prob
        self.max_scale = float(max_pad_scale)
        self.fill = fill_value
        self._rng = np.random.RandomState(seed)

    def __call__(self, img, boxes, rng=None):
        rng = self._rng if rng is None else rng
        if rng.rand() >= self.prob or self.max_scale <= 1.05:
            return img, boxes
        scale = rng.uniform(1.0, self.max_scale)
        if scale < 1.05:
            return img, boxes
        h, w = img.shape[:2]
        nh, nw = int(round(h * scale)), int(round(w * scale))
        y0 = rng.randint(0, nh - h + 1)
        x0 = rng.randint(0, nw - w + 1)
        canvas = np.full((nh, nw) + img.shape[2:], self.fill, img.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = img
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, 1] = (boxes[:, 1] * w + x0) / nw
            boxes[:, 3] = (boxes[:, 3] * w + x0) / nw
            boxes[:, 2] = (boxes[:, 2] * h + y0) / nh
            boxes[:, 4] = (boxes[:, 4] * h + y0) / nh
        return canvas, boxes


def _box_iou(crop: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU between one crop rect [x0,y0,x1,y1] and (k,4) gt rects."""
    ix0 = np.maximum(crop[0], boxes[:, 0])
    iy0 = np.maximum(crop[1], boxes[:, 1])
    ix1 = np.minimum(crop[2], boxes[:, 2])
    iy1 = np.minimum(crop[3], boxes[:, 3])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    area_c = (crop[2] - crop[0]) * (crop[3] - crop[1])
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(area_c + area_b - inter, 1e-12)


class DetRandomCrop(DetAugmenter):
    """IoU-constrained random crop — the SSD data-augmentation core
    (reference ``num_crop_sampler`` samplers + ``GenerateCropBox`` +
    ``TryCrop``, ``image_det_aug_default.cc:477-495,290-360``).

    ``samplers`` is a list of dicts with keys ``min_scale``/``max_scale``
    (crop linear scale), ``min_ratio``/``max_ratio`` (aspect),
    ``min_overlap``/``max_overlap`` (IoU gate vs at least one gt box) and
    ``trials``.  On call: samplers are tried in random order (reference
    shuffle), each up to ``trials`` crop draws; the first crop satisfying
    its sampler's constraint wins.  Ground truths are kept by crop-center
    containment (``crop_emit_mode='center'``) or overlap threshold
    (``'overlap'``), then projected into crop coordinates."""

    def __init__(self, samplers: Optional[Sequence[dict]] = None,
                 prob: float = 0.857, emit_mode: str = "center",
                 emit_overlap_thresh: float = 0.3, seed: int = 0):
        if samplers is None:
            samplers = ssd_crop_samplers()
        self.samplers = list(samplers)
        self.prob = prob
        if emit_mode not in ("center", "overlap"):
            raise ValueError(f"bad emit_mode {emit_mode!r}")
        self.emit_mode = emit_mode
        self.emit_thresh = emit_overlap_thresh
        self._rng = np.random.RandomState(seed)

    def _draw_crop(self, s: dict, img_ar: float,
                   rng) -> Optional[np.ndarray]:
        scale = rng.uniform(s.get("min_scale", 0.3),
                            s.get("max_scale", 1.0)) + 1e-12
        min_r = max(s.get("min_ratio", 0.5) / img_ar, scale * scale)
        max_r = min(s.get("max_ratio", 2.0) / img_ar,
                    1.0 / (scale * scale))
        if min_r > max_r:
            return None
        ratio = np.sqrt(rng.uniform(min_r, max_r))
        cw = min(1.0, scale * ratio)
        ch = min(1.0, scale / ratio)
        x0 = rng.uniform(0, 1 - cw)
        y0 = rng.uniform(0, 1 - ch)
        return np.array([x0, y0, x0 + cw, y0 + ch], np.float32)

    def _emit(self, crop: np.ndarray,
              boxes: np.ndarray) -> Optional[np.ndarray]:
        """Project gt boxes into crop coords, dropping emitted ones; None
        when every box is emitted (the crop is rejected)."""
        if self.emit_mode == "center":
            cx = (boxes[:, 1] + boxes[:, 3]) / 2
            cy = (boxes[:, 2] + boxes[:, 4]) / 2
            keep = ((cx >= crop[0]) & (cx < crop[2]) &
                    (cy >= crop[1]) & (cy < crop[3]))
        else:
            r = boxes[:, 1:5]
            inter_w = np.clip(np.minimum(crop[2], r[:, 2]) -
                              np.maximum(crop[0], r[:, 0]), 0, None)
            inter_h = np.clip(np.minimum(crop[3], r[:, 3]) -
                              np.maximum(crop[1], r[:, 1]), 0, None)
            cover = inter_w * inter_h / np.maximum(
                (r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1]), 1e-12)
            keep = cover > self.emit_thresh
        if not keep.any():
            return None
        out = boxes[keep].copy()
        cw, ch = crop[2] - crop[0], crop[3] - crop[1]
        out[:, 1] = np.clip((out[:, 1] - crop[0]) / cw, 0, 1)
        out[:, 3] = np.clip((out[:, 3] - crop[0]) / cw, 0, 1)
        out[:, 2] = np.clip((out[:, 2] - crop[1]) / ch, 0, 1)
        out[:, 4] = np.clip((out[:, 4] - crop[1]) / ch, 0, 1)
        return out

    def __call__(self, img, boxes, rng=None):
        rng = self._rng if rng is None else rng
        if rng.rand() >= self.prob or not len(boxes):
            return img, boxes
        h, w = img.shape[:2]
        order = rng.permutation(len(self.samplers))
        for idx in order:
            s = self.samplers[idx]
            for _ in range(int(s.get("trials", 25))):
                crop = self._draw_crop(s, w / h, rng)
                if crop is None:
                    continue
                lo = s.get("min_overlap", 0.0)
                hi = s.get("max_overlap", 1.0)
                if lo > 0.0 or hi < 1.0:
                    iou = _box_iou(crop, boxes[:, 1:5])
                    if not ((iou >= lo) & (iou <= hi)).any():
                        continue
                new_boxes = self._emit(crop, boxes)
                if new_boxes is None:
                    continue
                x0 = int(round(crop[0] * w))
                y0 = int(round(crop[1] * h))
                x1 = max(x0 + 1, int(round(crop[2] * w)))
                y1 = max(y0 + 1, int(round(crop[3] * h)))
                return img[y0:y1, x0:x1], new_boxes
        return img, boxes  # every sampler failed: original sample


def ssd_crop_samplers() -> list:
    """The canonical SSD sampler bank (min-IoU 0.1/0.3/0.5/0.7/0.9 plus an
    unconstrained one — the reference SSD example's train.py settings)."""
    bank = [{"min_scale": 0.3, "max_scale": 1.0,
             "min_ratio": 0.5, "max_ratio": 2.0, "trials": 25}]
    for min_iou in (0.1, 0.3, 0.5, 0.7, 0.9):
        bank.append({"min_scale": 0.3, "max_scale": 1.0,
                     "min_ratio": 0.5, "max_ratio": 2.0,
                     "min_overlap": min_iou, "trials": 25})
    return bank


class DetColorDistort(DetAugmenter):
    """The det-pipeline color distortion
    (``image_det_aug_default.cc:536-567``): per-channel offsets drawn
    ``uniform(-1,1) * max_random_{hue,saturation,illumination}``, each
    zeroed unless its own ``*_prob`` gate passes, added in OpenCV-u8 HLS
    ranges (H clamped to [0,180], L/S to [0,255]); then an independent
    contrast term ``c ~ uniform(-1,1) * max_random_contrast`` (same gate
    scheme) applied as ``img * (1 + c)``.  The reference draws all four
    offsets BEFORE evaluating any gate — the draw order is reproduced so a
    seeded stream matches."""

    def __init__(self, max_random_hue: int = 0, random_hue_prob: float = 0.0,
                 max_random_saturation: int = 0,
                 random_saturation_prob: float = 0.0,
                 max_random_illumination: int = 0,
                 random_illumination_prob: float = 0.0,
                 max_random_contrast: float = 0.0,
                 random_contrast_prob: float = 0.0, seed: int = 0):
        self.max_h, self.p_h = int(max_random_hue), float(random_hue_prob)
        self.max_s, self.p_s = (int(max_random_saturation),
                                float(random_saturation_prob))
        self.max_l, self.p_l = (int(max_random_illumination),
                                float(random_illumination_prob))
        self.max_c, self.p_c = (float(max_random_contrast),
                                float(random_contrast_prob))
        self._rng = np.random.RandomState(seed)

    def __call__(self, img, boxes, rng=None):
        rng = self._rng if rng is None else rng
        if not (self.p_h or self.p_s or self.p_l or self.p_c):
            return img, boxes
        # reference order: draw h, s, l, c first, then the 4 prob gates
        h = int(rng.uniform(-1, 1) * self.max_h)
        s = int(rng.uniform(-1, 1) * self.max_s)
        l = int(rng.uniform(-1, 1) * self.max_l)
        c = rng.uniform(-1, 1) * self.max_c
        h = h if rng.rand() < self.p_h else 0
        s = s if rng.rand() < self.p_s else 0
        l = l if rng.rand() < self.p_l else 0
        c = c if rng.rand() < self.p_c else 0.0
        if h or s or l:
            hls = _rgb_to_hls_u8(np.clip(img, 0, 255).astype(np.uint8))
            hls[..., 0] = np.clip(hls[..., 0] + h, 0, 180)
            hls[..., 1] = np.clip(hls[..., 1] + l, 0, 255)
            hls[..., 2] = np.clip(hls[..., 2] + s, 0, 255)
            out = _hls_to_rgb_u8(hls)
            img = out if np.issubdtype(img.dtype, np.integer)                 else out.astype(img.dtype)
        if abs(c) > 1e-3:
            out = img.astype(np.float32) * (1.0 + c)
            img = (np.clip(out, 0, 255).astype(img.dtype)
                   if np.issubdtype(img.dtype, np.integer) else out)
        return img, boxes


def ssd_train_augmenter(seed: int = 0) -> DetAugmenter:
    """The reference SSD training chain in ``image_det_aug_default.cc``
    Process order — color distortion, mirror, zoom-out pad,
    IoU-constrained crop (``:536,570,578,597``); resize-to-data_shape
    happens in the det iterator.  Color settings follow the SSD example's
    train.py (hue 18 / saturation 32 / illumination 32 at p=0.5 each,
    contrast 0.3 at p=0.5)."""
    return DetCompose(
        DetColorDistort(max_random_hue=18, random_hue_prob=0.5,
                        max_random_saturation=32,
                        random_saturation_prob=0.5,
                        max_random_illumination=32,
                        random_illumination_prob=0.5,
                        max_random_contrast=0.3, random_contrast_prob=0.5,
                        seed=seed),
        DetRandomMirror(prob=0.5, seed=seed + 1),
        DetRandomPad(prob=0.5, max_pad_scale=4.0, seed=seed + 2),
        DetRandomCrop(seed=seed + 3),
    )
