"""CelebA: file-number-indexed JPEGs with a binary attribute label (the
port's copy of the JAX package's data/celeba.py).

Images are ``str(offset + i + 1).zfill(6).jpg`` under the root, resized on
the shorter side to im_size and centre-cropped; the label is one column of
``list_attr_celeba.txt``. When the root directory is missing, the same
deterministic synthetic images and labels as the JAX package's stand in, so
both packages train on identical pixels.

- ``decoded_cache`` decodes the whole set once into a uint8 NHWC array (no
  flip, no normalisation: the Trainer applies those on the device after
  each gather), saved as ``<cache_dir>/celeba_<size>_<offset>_<len>[_syn].npy``
  and memory-mapped on reuse (JAX data/celeba.py:141-187). Real files go
  through the native decoder (data/native, threaded libjpeg) and PIL
  decodes each image it flags; PIL decodes them all when the decoder
  cannot be built.
- ``get_sample`` / ``__getitem__`` decode one image, flip it with the
  dataset's own generator and normalise it to [-1, 1]: the host loop's
  (``--host_loop``) per-image path, as the JAX package's.
"""

from __future__ import annotations

import os
import tempfile
import time
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
                 attr: Optional[str] = None, rng_seed: int = 0):
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
        # The host loop's flips (JAX CelebADataset._rng).
        self._rng = np.random.default_rng(rng_seed)
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

        img = Image.open(self._path(number)).convert("RGB")
        w, h = img.size
        scale = self.im_size / min(w, h)
        img = img.resize((max(self.im_size, round(w * scale)),
                          max(self.im_size, round(h * scale))), Image.BILINEAR)
        w, h = img.size
        left, top = (w - self.im_size) // 2, (h - self.im_size) // 2
        img = img.crop((left, top, left + self.im_size, top + self.im_size))
        return np.asarray(img, dtype=np.float32) / 255.0

    def _path(self, number: int) -> str:
        return os.path.join(self.root, str(self.offset + number).zfill(6) + "." + self.ext)

    def get_sample(self, number: int) -> Tuple[np.ndarray, int]:
        """1-based sample: decoded, flipped with probability 1/2, normalised
        to [-1, 1] (JAX data/celeba.py:113-121, reference
        datasets.py:48-54, with its labels[number - 1])."""
        x = self._decode(number)
        if self._rng.random() < 0.5:
            x = x[:, ::-1, :]
        x = x * 2.0 - 1.0
        label = 0 if self.labels is None else int(self.labels[number - 1])
        return np.ascontiguousarray(x), label

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        return self.get_sample(index + 1)

    def cache_path(self, cache_dir: Optional[str] = None) -> str:
        """``<cache_dir>/celeba_<size>_<offset>_<len>[_syn].npy``; by default
        ``_decoded_cache`` under the image root, or under the temporary
        directory for synthetic data (JAX data/celeba.py:158-164)."""
        if cache_dir is None:
            cache_dir = os.path.join(self.root if not self.synthetic else tempfile.gettempdir(),
                                     "_decoded_cache")
        tag = f"celeba_{self.im_size}_{self.offset}_{self.length}"
        if self.synthetic:
            tag += "_syn"
        return os.path.join(cache_dir, tag + ".npy")

    def decoded_cache(self, cache_dir: Optional[str] = None,
                      n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """(images uint8 [N, im, im, 3], labels int64): every image decoded
        once, rounded as the JAX package's cache rounds it, and saved to
        ``cache_path(cache_dir)``; a cache already there is memory-mapped
        (``mmap_mode="r"``) and not decoded again. ``n_threads`` is the
        native decoder's thread count (``-nw``; 0: one per CPU).
        ``decode_stats`` then says what ran: the decoder ("native (k
        threads)", "PIL" or "cache"), the images, those PIL decoded, and the
        seconds."""
        labels = (self.labels if self.labels is not None
                  else np.zeros(self.length, np.int64))
        path = self.cache_path(cache_dir)
        t0 = time.perf_counter()
        shape = (self.length, self.im_size, self.im_size, 3)
        if os.path.exists(path):
            try:
                arr = np.load(path, mmap_mode="r")
            except (ValueError, OSError, EOFError):
                arr = None      # a file another process (the JAX package) is still writing
            if arr is not None and arr.shape == shape and arr.dtype == np.uint8:
                self.decode_stats = {"decoder": "cache", "images": self.length, "pil": 0,
                                     "seconds": time.perf_counter() - t0}
                return arr, labels
        os.makedirs(os.path.dirname(path), exist_ok=True)
        arr = np.empty(shape, np.uint8)
        done = np.zeros(self.length, bool)
        decoder = "PIL"
        use_native = False
        if not self.synthetic:
            from csl_gan_tpu_torch.data import native

            use_native = native.available()      # builds the library on first use
        t0 = time.perf_counter()
        if use_native:
            decoder = f"native ({n_threads or os.cpu_count()} threads)"
            chunk = 4096
            for lo in range(0, self.length, chunk):
                hi = min(lo + chunk, self.length)
                out, ok = native.decode_batch([self._path(i + 1) for i in range(lo, hi)],
                                              self.im_size, n_threads=n_threads)
                arr[lo:hi] = out
                done[lo:hi] = ok
        to_pil = np.nonzero(~done)[0]
        for i in to_pil:
            arr[i] = np.clip(self._decode(int(i) + 1) * 255.0 + 0.5, 0, 255)
        self.decode_stats = {"decoder": decoder, "images": self.length, "pil": len(to_pil),
                             "seconds": time.perf_counter() - t0}
        if self.synthetic:
            print(f"[csl_gan_tpu_torch] {self.length} synthetic CelebA images cached in {path}")
        else:
            print(f"[csl_gan_tpu_torch] decoded {self.length} CelebA images into {path} in "
                  f"{time.perf_counter() - t0:.2f} s: decoder {decoder}, "
                  f"{len(to_pil)} image(s) by PIL")
        # Through a temporary file: concurrent runs never read a partial cache.
        tmp = f"{path}.tmp{os.getpid()}.npy"
        np.save(tmp, arr)
        os.replace(tmp, path)
        return np.load(path, mmap_mode="r"), labels
