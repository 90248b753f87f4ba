"""CelebA-shaped training data as the port reads a decoded CelebA set: the
image directory, its decode-once cache ``_decoded_cache/celeba_<size>_0_<n>
.npy`` (uint8 [n, size, size, 3]) and the attribute file
(``list_attr_celeba.txt``: a count line, the 40 attribute names, then one
line per image, its file name and 40 values of +-1). Made once from the
configuration's ``data_seed`` and kept under the checkout's build directory.

Each image is a random 8 x 8 colour field upsampled to 64 x 64 with pixel
noise; the labelled attribute is 1 with the stated ``label_share``.

``files(spec, root)`` returns {"data_path", "label_path", "images",
"attributes"}.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

ATTRIBUTES = ("5_o_Clock_Shadow Arched_Eyebrows Attractive Bags_Under_Eyes Bald Bangs "
              "Big_Lips Big_Nose Black_Hair Blond_Hair Blurry Brown_Hair Bushy_Eyebrows "
              "Chubby Double_Chin Eyeglasses Goatee Gray_Hair Heavy_Makeup High_Cheekbones "
              "Male Mouth_Slightly_Open Mustache Narrow_Eyes No_Beard Oval_Face Pale_Skin "
              "Pointy_Nose Receding_Hairline Rosy_Cheeks Sideburns Smiling Straight_Hair "
              "Wavy_Hair Wearing_Earrings Wearing_Hat Wearing_Lipstick Wearing_Necklace "
              "Wearing_Necktie Young").split()


def files(spec: dict, root: Path) -> dict:
    n, size = spec["rows"], spec["im_size"]
    img_dir = root / "img"
    cache = img_dir / "_decoded_cache" / f"celeba_{size}_0_{n}.npy"
    attrs = root / "list_attr_celeba.txt"
    if not (cache.exists() and attrs.exists()):
        cache.parent.mkdir(parents=True, exist_ok=True)
        rng = np.random.default_rng(spec["data_seed"])
        coarse = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
        k = size // 8
        images = np.empty((n, size, size, 3), np.uint8)
        for lo in range(0, n, 1024):
            block = coarse[lo:lo + 1024].repeat(k, axis=1).repeat(k, axis=2).astype(np.int16)
            block += rng.integers(-24, 25, block.shape, dtype=np.int16)
            images[lo:lo + 1024] = np.clip(block, 0, 255).astype(np.uint8)
        values = np.where(rng.random((n, len(ATTRIBUTES))) < 0.5, 1, -1)
        values[:, ATTRIBUTES.index(spec["label_attr"])] = np.where(
            rng.random(n) < spec["label_share"], 1, -1)
        tmp = attrs.with_name(attrs.name + f".part{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(f"{n}\n{' '.join(ATTRIBUTES)}\n")
            for i in range(n):
                f.write(f"{i + 1:06d}.jpg " + " ".join(f"{v:2d}" for v in values[i]) + "\n")
        os.replace(tmp, attrs)
        tmp = cache.with_name(f"part{os.getpid()}.npy")
        np.save(tmp, images)
        os.replace(tmp, cache)
    return {"data_path": str(img_dir) + "/", "label_path": str(attrs), "images": str(cache),
            "attributes": str(attrs)}
