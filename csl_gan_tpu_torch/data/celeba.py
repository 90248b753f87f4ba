"""CelebA: file-number-indexed JPEGs with a binary attribute label (the
port's copy of the JAX package's data/celeba.py).

Images are ``str(offset + i + 1).zfill(6).jpg`` under the root, resized on
the shorter side to im_size and centre-cropped; the label is one column of
``list_attr_celeba.txt``. When the root directory is missing, the same
deterministic synthetic images and labels as the JAX package's stand in, so
both packages train on identical pixels. ``decoded_cache`` returns the whole
set as one uint8 NHWC array (no flip, no normalisation: the Trainer applies
those on the device after the gather); unlike the JAX package it is built in
memory and not written to disk.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

CELEBA_ATTR = ["Filename", "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive",
               "Bags_Under_Eyes", "Bald", "Bangs", "Big_Lips", "Big_Nose",
               "Black_Hair", "Blond_Hair", "Blurry", "Brown_Hair",
               "Bushy_Eyebrows", "Chubby", "Double_Chin", "Eyeglasses",
               "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones",
               "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes",
               "No_Beard", "Oval_Face", "Pale_Skin", "Pointy_Nose",
               "Receding_Hairline", "Rosy_Cheeks", "Sideburns", "Smiling",
               "Straight_Hair", "Wavy_Hair", "Wearing_Earrings", "Wearing_Hat",
               "Wearing_Lipstick", "Wearing_Necklace", "Wearing_Necktie",
               "Young"]


def parse_attr_file(attr_file: str, attr: str, length: int, offset: int) -> np.ndarray:
    """Binary labels for `attr` over rows [offset, offset+length)."""
    col = CELEBA_ATTR.index(attr)
    labels = np.zeros(length, dtype=np.int64)
    with open(attr_file) as f:
        next(f)
        next(f)
        for i, line in enumerate(f):
            if i < offset:
                continue
            if i >= offset + length:
                break
            labels[i - offset] = 1 if int(line.split()[col]) == 1 else 0
    return labels


class CelebADataset:
    def __init__(self, root: str, im_size: int = 64, length: Optional[int] = None,
                 offset: int = 0, ext: str = "jpg", attr_file: Optional[str] = None,
                 attr: Optional[str] = None):
        self.root = root
        self.im_size = im_size
        self.offset = offset
        self.ext = ext
        self.synthetic = not (root and os.path.isdir(root))
        if self.synthetic:
            print(f"[csl_gan_tpu_torch] CelebA not found under {root!r}; "
                  "using deterministic synthetic images.")
            self.length = length or 2000
        else:
            self.length = length or len(os.listdir(self.root))
        if attr is None:
            self.labels = None
            self.label_true_count = None
        elif self.synthetic or attr_file is None or not os.path.exists(attr_file):
            syn_rng = np.random.default_rng(42 + offset)
            self.labels = (syn_rng.random(self.length) < 0.42).astype(np.int64)
            self.label_true_count = int((self.labels == 1).sum())
        else:
            self.labels = parse_attr_file(attr_file, attr, self.length, self.offset)
            self.label_true_count = int((self.labels == 1).sum())

    def __len__(self):
        return self.length

    def _decode(self, number: int) -> np.ndarray:
        """Decode + resize + centre crop -> HWC float in [0, 1]."""
        if self.synthetic:
            rng = np.random.default_rng(self.offset + number)
            return rng.random((self.im_size, self.im_size, 3)).astype(np.float32)
        from PIL import Image

        fname = str(self.offset + number).zfill(6) + "." + self.ext
        img = Image.open(os.path.join(self.root, fname)).convert("RGB")
        w, h = img.size
        scale = self.im_size / min(w, h)
        img = img.resize((max(self.im_size, round(w * scale)),
                          max(self.im_size, round(h * scale))), Image.BILINEAR)
        w, h = img.size
        left, top = (w - self.im_size) // 2, (h - self.im_size) // 2
        img = img.crop((left, top, left + self.im_size, top + self.im_size))
        return np.asarray(img, dtype=np.float32) / 255.0

    def decoded_cache(self) -> Tuple[np.ndarray, np.ndarray]:
        """(images uint8 [N, im, im, 3], labels int64): every image decoded
        once, rounded as the JAX package's cache rounds it."""
        labels = (self.labels if self.labels is not None
                  else np.zeros(self.length, np.int64))
        arr = np.empty((self.length, self.im_size, self.im_size, 3), np.uint8)
        for i in range(self.length):
            arr[i] = np.clip(self._decode(i + 1) * 255.0 + 0.5, 0, 255)
        return arr, labels
