"""CTAugment, the FixMatch augmentation policy learner (counterpart of
`icl_tpu/data/ctaugment.py`), without PIL.

The JAX package builds its 19 ops on PIL 'L' images. Here each op works on
a uint8 array [H, W] in numpy and gives PIL's pixels exactly:
  * blends (`Image.blend`, and so every `ImageEnhance` factor) in float32,
    in1 + float32(alpha) * (in2 - in1), truncated, clipped only when alpha
    lies outside [0, 1];
  * autocontrast, equalize, invert, posterize and solarize through PIL's
    256-entry tables;
  * SMOOTH (3x3 / 13) and BLUR (5x5 / 16) as PIL's float32 filter: the sum
    from 0.5 in PIL's order, truncated, the 1- or 2-pixel border copied;
  * rotate, shear and translate through PIL's nearest affine paths: the
    16.16 fixed-point walk where the matrix rotates or shears, the float64
    running sums of its scaling path where it does not;
  * rescale: the crop box through Python's `round`, then PIL's separable
    resample for LANCZOS, BICUBIC, BILINEAR, BOX and HAMMING (float64
    coefficients normalised per output pixel, 22-bit fixed point,
    horizontal pass first) and the scaling path for NEAREST.

Images enter and leave `cta_apply` as float [0, 1], through uint8 exactly
as the JAX `to_pil` / `from_pil` do.

`cutout` is the one deliberate difference. The JAX op draws its centre from
an unseeded `np.random.default_rng()` when `cta_apply` gives it none
(always), so no two JAX runs agree and an image and its label get
different squares. Here `cta_apply` takes a generator and passes it to
`cutout`; the image and the label still draw separately. The reference's
bounds (`integers(w // 2, w)`, `integers(w // 2, h)`) and its
`arr[x0:x1, y0:y1]` indexing are kept.

`CTAugment` is the JAX learner, draw for draw: one seed gives the JAX
package's policy stream, and `save` / `restore` read and write the same
`cta_state.json`.
"""
from __future__ import annotations

import functools
import json
import math
import os
from collections import OrderedDict, namedtuple
from typing import Dict, List, Optional, Tuple

import numpy as np

OP = namedtuple("OP", ("f", "bins"))
OPS: Dict[str, OP] = {}


def _register(*bins):
    def wrap(f):
        OPS[f.__name__] = OP(f, bins)
        return f

    return wrap


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0, 1] -> uint8, as the JAX `to_pil`."""
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def from_uint8(arr: np.ndarray) -> np.ndarray:
    """uint8 -> float32 [0, 1], as the JAX `from_pil`."""
    return np.asarray(arr, np.float32) / 255.0


# ---- PIL's arithmetic --------------------------------------------------------
def _blend(in1: np.ndarray, in2: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(in1, in2, alpha)`, alpha a C float."""
    a = np.float32(alpha)
    out = in1.astype(np.float32) + a * (in2.astype(np.float32) - in1.astype(np.float32))
    if 0.0 <= a <= 1.0:
        return out.astype(np.uint8)
    return np.where(out <= 0, 0, np.where(out >= 255, 255, out)).astype(np.uint8)


def _lut(x: np.ndarray, table) -> np.ndarray:
    """`Image.point(table)`: the table's entries clipped to [0, 255]."""
    return np.clip(np.asarray(table, np.int64), 0, 255).astype(np.uint8)[x]


def _histogram(x: np.ndarray) -> list:
    return np.bincount(x.ravel(), minlength=256).tolist()


def _filter(x: np.ndarray, kernel, divisor: float) -> np.ndarray:
    """`Image.filter` with a 3x3 or 5x5 kernel, offset 0: float32 weights
    k / divisor, the sum from 0.5 over the kernel's rows (from the bottom
    row of the window up, each row left to right), truncated; the border
    of (size - 1) / 2 pixels copied from the input."""
    n = int(math.isqrt(len(kernel)))
    r = n // 2
    h, w = x.shape
    if h < n or w < n:
        raise ValueError(f"a {n}x{n} filter needs an image of at least {n}x{n}, got {x.shape}")
    k = np.asarray(kernel, np.float32) / np.float32(divisor)
    f = x.astype(np.float32)
    ss = np.full((h - 2 * r, w - 2 * r), 0.5, np.float32)
    for row in range(n):
        dy = r - row  # PIL's kernel row 0 multiplies the row below the centre
        src = f[r + dy:h - r + dy]
        t = src[:, 0:w - 2 * r] * k[row * n]
        for col in range(1, n):
            t = t + src[:, col:w - 2 * r + col] * k[row * n + col]
        ss = ss + t
    out = x.copy()
    out[r:h - r, r:w - r] = np.where(ss <= 0, 0, np.where(ss >= 255, 255, ss)).astype(np.uint8)
    return out


_SMOOTH = ((1, 1, 1, 1, 5, 1, 1, 1, 1), 13)
_BLUR = ((1, 1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 1, 1, 1), 16)


def _coord(v: np.ndarray) -> np.ndarray:
    """PIL's COORD: -1 below 0, else truncation."""
    return np.where(v < 0.0, -1, np.trunc(np.maximum(v, 0.0))).astype(np.int64)


def _running(start: float, step: float, n: int) -> np.ndarray:
    """start, start + step, ... summed one by one in float64, as PIL's loops do."""
    return np.add.accumulate(np.concatenate([[start], np.full(n - 1, step)]))[:n]


def _scale_affine(x: np.ndarray, a, out_shape) -> np.ndarray:
    """PIL's nearest affine transform where a[1] == a[3] == 0
    (ImagingScaleAffine): running float64 coordinates from the pixel
    centres, outside pixels 0."""
    h_out, w_out = out_shape
    h, w = x.shape
    xin = _coord(_running(a[2] + a[0] * 0.5, a[0], w_out))
    yin = _coord(_running(a[5] + a[4] * 0.5, a[4], h_out))
    ok = (yin[:, None] >= 0) & (yin[:, None] < h) & (xin[None] >= 0) & (xin[None] < w)
    return np.where(ok, x[np.clip(yin, 0, h - 1)[:, None], np.clip(xin, 0, w - 1)[None]], 0) \
        .astype(np.uint8)


def _affine(x: np.ndarray, a) -> np.ndarray:
    """`Image.transform(size, AFFINE, a)` with NEAREST, output = input size:
    the scaling path where a[1] == a[3] == 0, else PIL's 16.16 fixed-point
    walk (ImagingTransformAffine / affine_fixed)."""
    if a[1] == 0 and a[3] == 0:
        return _scale_affine(x, a, x.shape)
    h, w = x.shape
    for cx, cy in ((0, 0), (w, h), (0, h), (w, 0)):
        if not (abs(a[0] * cx + a[1] * cy + a[2]) < 32768.0
                and abs(a[3] * cx + a[4] * cy + a[5]) < 32768.0):
            raise ValueError(f"an affine map this far off ({a}) leaves PIL's fixed-point range")

    def fix(v: float) -> int:
        return math.floor(v * 65536.0 + 0.5)

    a0, a1, a3, a4 = fix(a[0]), fix(a[1]), fix(a[3]), fix(a[4])
    a2 = fix(a[2] + a[0] * 0.5 + a[1] * 0.5)
    a5 = fix(a[5] + a[3] * 0.5 + a[4] * 0.5)
    yy, xx = np.arange(h, dtype=np.int64)[:, None], np.arange(w, dtype=np.int64)[None]
    xin = (a2 + yy * a1 + xx * a0) >> 16
    yin = (a5 + yy * a4 + xx * a3) >> 16
    ok = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    return np.where(ok, x[np.clip(yin, 0, h - 1), np.clip(xin, 0, w - 1)], 0).astype(np.uint8)


def _box_filter(x: float) -> float:
    return 1.0 if -0.5 < x <= 0.5 else 0.0


def _bilinear_filter(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _hamming_filter(x: float) -> float:
    x = abs(x)
    if x == 0.0:
        return 1.0
    if x >= 1.0:
        return 0.0
    x = x * math.pi
    # PIL's constants are C floats: 0.54f, 0.46f
    return math.sin(x) / x * (float(np.float32(0.54)) + float(np.float32(0.46)) * math.cos(x))


def _bicubic_filter(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos_filter(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


# name -> (filter, support), PIL's resample filters
_RESAMPLE = {"lanczos": (_lanczos_filter, 3.0), "bicubic": (_bicubic_filter, 2.0),
             "bilinear": (_bilinear_filter, 1.0), "box": (_box_filter, 0.5),
             "hamming": (_hamming_filter, 1.0)}
_PRECISION_BITS = 22


@functools.lru_cache(maxsize=64)
def _coeffs(in_size: int, out_size: int, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PIL's precompute_coeffs over the box [0, in_size), in 22-bit fixed
    point: (first input index [out], taps [out], weights [out, ksize]
    int64, zero past each pixel's taps), read-only. Cached: one policy
    rescales every sample of a batch, and its label, alike."""
    filt, support = _RESAMPLE[name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    one = float(1 << _PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :xmax] = [int(-0.5 + v * one) if v < 0 else int(0.5 + v * one) for v in w]
        first[xx], taps[xx] = xmin, xmax
    for a in (first, taps, kk):
        a.setflags(write=False)
    return first, taps, kk


def _resample_axis(x: np.ndarray, first: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One pass along the last axis: the taps summed from 1 << 21, >> 22,
    clipped to [0, 255]."""
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), x.shape[-1] - 1)
    acc = (x[..., idx].astype(np.int64) * kk).sum(-1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize(x: np.ndarray, out_shape, method: str) -> np.ndarray:
    """`Image.resize((w, h), method)` of the whole image."""
    h_out, w_out = out_shape
    h, w = x.shape
    if (h, w) == (h_out, w_out):
        return x.copy()
    if method == "nearest":
        return _scale_affine(x, (w / w_out, 0.0, 0.0, 0.0, h / h_out, 0.0), out_shape)
    first_v, taps_v, kk_v = _coeffs(h, h_out, method)
    if w != w_out:
        # over the rows that the vertical pass reads
        y0, y1 = int(first_v[0]), int(first_v[-1] + taps_v[-1])
        first_h, _, kk_h = _coeffs(w, w_out, method)
        x = _resample_axis(x[y0:y1], first_h, kk_h)
        first_v = first_v - y0
    if h != h_out:
        x = np.ascontiguousarray(_resample_axis(x.T, first_v, kk_v).T)
    return x


# ---- strong ops (the first 11) ---------------------------------------------
@_register(17)
def autocontrast(x, level):
    h = _histogram(x)
    lo = next((i for i in range(256) if h[i]), 255)
    hi = next((i for i in range(255, -1, -1) if h[i]), 0)
    if hi <= lo:
        table = list(range(256))
    else:
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        table = [min(max(int(i * scale + offset), 0), 255) for i in range(256)]
    return _blend(x, _lut(x, table), level)


def _enhance_factor(level: float) -> float:
    return 0.1 + 1.9 * level


@_register(17)
def brightness(x, level):
    return _blend(np.zeros_like(x), x, _enhance_factor(level))


@_register(17)
def color(x, level):
    # ImageEnhance.Color of an 'L' image blends it with itself
    return _blend(x, x, _enhance_factor(level))


@_register(17)
def contrast(x, level):
    mean = int(float(sum(i * n for i, n in enumerate(_histogram(x)))) / x.size + 0.5)
    return _blend(np.full_like(x, mean), x, _enhance_factor(level))


@_register(17)
def equalize(x, level):
    h = _histogram(x)
    histo = [n for n in h if n]
    table = list(range(256))
    if len(histo) > 1:
        step = (sum(histo) - histo[-1]) // 255
        if step:
            table, n = [], step // 2
            for i in range(256):
                table.append(n // step)
                n += h[i]
    return _blend(x, _lut(x, table), level)


@_register(17)
def invert(x, level):
    return _blend(x, 255 - x, level)


@_register(8)
def posterize(x, level):
    mask = ~(2 ** (8 - (1 + int(level * 7.999))) - 1)
    return _lut(x, [i & mask for i in range(256)])


@_register(17)
def solarize(x, level):
    threshold = int(level * 255.999)
    return _lut(x, [i if i < threshold else 255 - i for i in range(256)])


@_register(17)
def smooth(x, level):
    return _blend(x, _filter(x, *_SMOOTH), level)


@_register(17)
def blur(x, level):
    return _blend(x, _filter(x, *_BLUR), level)


@_register(17)
def sharpness(x, level):
    return _blend(_filter(x, *_SMOOTH), x, _enhance_factor(level))


# ---- weak ops ----------------------------------------------------------------
@_register(17)
def cutout(x, level, rng: np.random.Generator):
    h, w = x.shape
    size = 1 + int(level * min(w, h) * 0.499)
    cy = int(rng.integers(w // 2, w))
    cx = int(rng.integers(w // 2, h))
    arr = x.copy()
    y0, x0 = max(0, cy - size // 2), max(0, cx - size // 2)
    y1, x1 = min(w, cy + size // 2), min(h, cx + size // 2)
    arr[x0:x1, y0:y1] = 0
    return arr


@_register()
def identity(x):
    return x


_RESCALE_METHODS = ("lanczos", "bicubic", "bilinear", "box", "hamming", "nearest")


@_register(17, 6)
def rescale(x, scale, method):
    h, w = x.shape
    scale *= 0.25
    x0, y0, x1, y1 = (int(round(v)) for v in (scale * w, scale * h, w * (1 - scale),
                                              h * (1 - scale)))
    return _resize(x[y0:y1, x0:x1], (h, w), _RESCALE_METHODS[int(method * 5.99)])


@_register(17)
def rotate(x, level):
    angle = int(np.round((2 * level - 1) * 45)) % 360.0
    if angle == 0:
        return x.copy()
    h, w = x.shape
    center = (w / 2, h / 2)
    rad = -math.radians(angle)
    a = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    a[2] = a[0] * -center[0] + a[1] * -center[1] + a[2] + center[0]
    a[5] = a[3] * -center[0] + a[4] * -center[1] + a[5] + center[1]
    return _affine(x, a)


@_register(17)
def shear_x(x, level):
    return _affine(x, (1, (2 * level - 1) * 0.3, 0, 0, 1, 0))


@_register(17)
def shear_y(x, level):
    return _affine(x, (1, 0, 0, (2 * level - 1) * 0.3, 1, 0))


@_register(17)
def translate_x(x, level):
    return _affine(x, (1, 0, (2 * level - 1) * 0.3, 0, 1, 0))


@_register(17)
def translate_y(x, level):
    return _affine(x, (1, 0, 0, 0, 1, (2 * level - 1) * 0.3))


NUM_STRONG_OPS = 11


class CTAugment:
    """The policy learner: per op one float32 rate vector per bin, all 1 at
    the start. A rate update at the chosen bin is rate * decay + proximity
    * (1 - decay); a bin is drawn with probability rate + (1 - decay),
    normalised by the largest, zero below `th`. `policy` draws `depth` ops,
    strong (the first 11) or weak (the rest), from a numpy Generator seeded
    with `seed`, in the JAX package's order."""

    def __init__(self, depth: int = 2, th: float = 0.85, decay: float = 0.99,
                 seed: Optional[int] = None):
        self.depth = depth
        self.th = th
        self.decay = decay
        self.rng = np.random.default_rng(seed)
        self.rates = {k: tuple(np.ones(b, np.float32) for b in op.bins) for k, op in OPS.items()}

    def _rate_to_p(self, rate: np.ndarray) -> np.ndarray:
        p = rate + (1 - self.decay)
        p = p / p.max()
        p[p < self.th] = 0
        return p

    def policy(self, probe: bool, weak: bool) -> List[Tuple[str, List[float]]]:
        """[(op name, its arguments in [0, 1))] * depth. A probe policy
        draws each argument uniformly; otherwise each bin is drawn from the
        rates and the argument placed uniformly inside it."""
        keys = list(OPS.keys())
        kl = keys[NUM_STRONG_OPS:] if weak else keys[:NUM_STRONG_OPS]
        out = []
        for _ in range(self.depth):
            k = kl[int(self.rng.integers(len(kl)))]
            bins = self.rates[k]
            rnd = self.rng.uniform(0, 1, len(bins))
            if probe:
                out.append((k, rnd.tolist()))
                continue
            vt = []
            for r, rate in zip(rnd, bins):
                p = self._rate_to_p(rate)
                value = int(self.rng.choice(p.shape[0], p=p / p.sum()))
                vt.append((value + r) / p.shape[0])
            out.append((k, vt))
        return out

    def update_rates(self, policy, proximity: float) -> None:
        for k, bins in policy:
            for b, rate in zip(bins, self.rates[k]):
                idx = int(b * len(rate) * 0.999)
                rate[idx] = rate[idx] * self.decay + proximity * (1 - self.decay)

    def state_dict(self) -> OrderedDict:
        """decay, depth, th and the rates (the live arrays)."""
        return OrderedDict((k, getattr(self, k)) for k in ("decay", "depth", "th", "rates"))

    def load_state_dict(self, state: dict) -> None:
        missing = [k for k in ("decay", "depth", "th", "rates") if k not in state]
        if missing:
            raise KeyError(f"{missing} not in the CTA state {list(state.keys())}")
        for k in ("decay", "depth", "th", "rates"):
            setattr(self, k, state[k])

    def save(self, path: str) -> None:
        """The state as JSON (rates as nested lists), the JAX package's
        `cta_state.json`; written to a temporary name and renamed."""
        sd = self.state_dict()
        sd["rates"] = {k: [np.asarray(r).tolist() for r in bins] for k, bins in sd["rates"].items()}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sd, f)
        os.replace(tmp, path)

    def restore(self, path: str) -> None:
        with open(path) as f:
            sd = json.load(f)
        sd["rates"] = {k: tuple(np.asarray(r, np.float32) for r in bins)
                       for k, bins in sd["rates"].items()}
        self.load_state_dict(sd)

    def stats(self) -> str:
        return "\n".join(
            "%-16s    %s" % (k, " / ".join(" ".join("%.2f" % x for x in self._rate_to_p(rate))
                                          for rate in self.rates[k]))
            for k in sorted(OPS.keys()))


def cta_apply(img: np.ndarray, ops: Optional[List[Tuple[str, List[float]]]],
              rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """A policy applied to a float [0, 1] grayscale image [H, W]: float32
    [0, 1] out, through uint8. `rng` draws `cutout`'s centre; a policy
    with a cutout and no generator raises ValueError. `ops` None returns
    `img` itself."""
    if ops is None:
        return img
    x = to_uint8(img)
    for name, args in ops:
        if name == "cutout":
            if rng is None:
                raise ValueError("cutout draws its centre from a generator: pass rng")
            x = cutout(x, *args, rng=rng)
        else:
            x = OPS[name].f(x, *args)
    return from_uint8(x)
