"""TensorBoard image panels (counterpart of `icl_tpu/utils/visualize.py`,
the reference's `code/utils/visualize.py`): normalised grayscale images
and colour-mapped label maps, channel-first class maps."""
from __future__ import annotations

import numpy as np
import torch

# a categorical palette for up to 16 classes (RGB, 0-255), the JAX package's
PALETTE = np.array(
    [
        [0, 0, 0], [228, 26, 28], [55, 126, 184], [77, 175, 74],
        [152, 78, 163], [255, 127, 0], [255, 255, 51], [166, 86, 40],
        [247, 129, 191], [153, 153, 153], [102, 194, 165], [252, 141, 98],
        [141, 160, 203], [231, 138, 195], [166, 216, 84], [255, 217, 47],
    ],
    np.uint8,
)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def normalize_image(img) -> np.ndarray:
    """The image min-max scaled to [0, 1] in f32."""
    img = _numpy(img).astype(np.float32)
    lo, hi = img.min(), img.max()
    return (img - lo) / max(hi - lo, 1e-8)


def label_to_rgb(label) -> np.ndarray:
    """A label map [H, W] as RGB [H, W, 3] uint8 (classes modulo 16)."""
    return PALETTE[_numpy(label).astype(np.int64) % len(PALETTE)]


def write_prediction_panel(writer, tag: str, image, label, prediction, step: int,
                           feat_maps=None) -> None:
    """Write `tag/image`, `tag/gt` and `tag/pred` (and `tag/aux_scale{i}`,
    the class argmax of the first sample of each channel-first class map
    [B, C, H, W] in `feat_maps`) to the TensorBoard writer of a
    `ScalarWriter` (`writer._tb`: tensorboardX, when it imports); nothing
    when it has none."""
    tb = getattr(writer, "_tb", None)
    if tb is None:
        return
    img = (normalize_image(image) * 255).astype(np.uint8)
    tb.add_image(f"{tag}/image", img[None], step, dataformats="CHW")
    tb.add_image(f"{tag}/gt", label_to_rgb(label), step, dataformats="HWC")
    tb.add_image(f"{tag}/pred", label_to_rgb(prediction), step, dataformats="HWC")
    if feat_maps is not None:
        for i, fm in enumerate(feat_maps):
            cls_map = np.argmax(_numpy(fm), axis=1)
            tb.add_image(f"{tag}/aux_scale{i}", label_to_rgb(cls_map[0]), step, dataformats="HWC")
