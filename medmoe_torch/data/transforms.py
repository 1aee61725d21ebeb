"""Host-side image preprocessing (decode / resize / normalize / augment).

Replaces the reference's ``build_transformation`` (src/utils/utils.py:16-68)
and — crucially — moves ALL image preprocessing out of model.forward into
the input pipeline (the reference runs HF AutoImageProcessor on raw PIL
images inside SWIN.forward, swin.py:131, starving the accelerator).

Output layout is NHWC float32 in [normalized] units, ready for device_put.
"""

from __future__ import annotations

import io
from typing import Optional, Sequence, Tuple

import numpy as np

# normalization stats (reference src/utils/utils.py:28-35)
NORM_STATS = {
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "half": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "slake": ((0.38026, 0.38026, 0.38026), (0.2979, 0.2979, 0.2979)),
    "pmcoa": ((0.48865, 0.48865, 0.48865), (0.27908, 0.27908, 0.27908)),
}


def decode_image(data: bytes) -> np.ndarray:
    """JPEG/PNG bytes → RGB uint8 HWC (nothrow callers catch exceptions)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    return np.asarray(img.convert("RGB"))


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image

    if img.shape[0] == size and img.shape[1] == size:
        return img
    pil = Image.fromarray(img)
    return np.asarray(pil.resize((size, size), Image.BILINEAR))


def resize_pad(img: np.ndarray, size: int) -> np.ndarray:
    """Aspect-preserving resize + zero-pad to square (reference CheXpert
    preprocessing, src/data/components/chexpert.py:47-93)."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    pil = Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    arr = np.asarray(pil)
    out = np.zeros((size, size) + arr.shape[2:], dtype=arr.dtype)
    top, left = (size - nh) // 2, (size - nw) // 2
    out[top:top + nh, left:left + nw] = arr
    return out


def normalize(img: np.ndarray, stats: str = "imagenet") -> np.ndarray:
    mean, std = NORM_STATS[stats]
    x = img.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


class ImageTransform:
    """Configurable eval/train transform (reference build_transformation)."""

    def __init__(self, image_size: int = 224, norm: str = "imagenet",
                 random_crop: bool = False, crop_size: Optional[int] = None,
                 random_horizontal_flip: bool = False,
                 pad_to_square: bool = False,
                 train: bool = False, seed: int = 0,
                 normalize_output: bool = True):
        self.image_size = image_size
        self.norm = norm
        # normalize_output=False emits resized uint8 — pair with the model's
        # on-device normalization (MedMoE._maybe_normalize) to ship 4× fewer
        # bytes to the accelerator
        self.normalize_output = normalize_output
        self.random_crop = random_crop and train
        self.crop_size = crop_size or image_size
        self.random_flip = random_horizontal_flip and train
        self.pad_to_square = pad_to_square
        self.rng = np.random.RandomState(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.pad_to_square:
            img = resize_pad(img, self.image_size)
        else:
            img = resize_bilinear(img, self.image_size)
        if self.random_crop:
            pad = self.image_size - self.crop_size
            if pad > 0:
                top = self.rng.randint(0, pad + 1)
                left = self.rng.randint(0, pad + 1)
                img = img[top:top + self.crop_size, left:left + self.crop_size]
                img = resize_bilinear(img, self.image_size)
        if self.random_flip and self.rng.rand() < 0.5:
            img = img[:, ::-1]
        if not self.normalize_output:
            return np.ascontiguousarray(img)
        return normalize(img, self.norm)
