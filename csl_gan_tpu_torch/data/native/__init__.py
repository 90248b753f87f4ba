"""ctypes loader for the port's native (C++) image pipeline, imageops.cpp.

The library is built with g++ at first use into ``build/`` at the root of
the checkout (``libimageops-<hash>.so``; the hash covers the source and the
flags, so an edited source rebuilds), never next to the source:

    g++ -O3 -fPIC -shared -std=c++17 -pthread imageops.cpp -ljpeg

On a machine without libjpeg's development files it compiles against the
libjpeg API headers in ``jpeg62/`` (libjpeg-turbo's, API version 62) and
links the libjpeg that Pillow ships (``pillow.libs/libjpeg-*.so.62*``, the
library PIL itself decodes with). ``link`` says which one was linked. It
exposes

  decode_batch(paths, im_size, n_threads) -> (uint8 [n, s, s, 3], ok bool [n])
  resample(rgb_hwc_uint8, out_w, out_h)   -> uint8 [out_h, out_w, 3]

``load()`` returns None when g++ or libjpeg is missing and says why once;
data/celeba.py then decodes with PIL. The decode is PIL's (the same
libjpeg, default ISLOW IDCT); the resample is PIL's Resampling.BILINEAR
(a scaled-support triangle filter) to within 1 LSB.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "imageops.cpp"
JPEG62 = SRC.parent / "jpeg62"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
LIBS = ["-ljpeg"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# Why the library is not available ("" while it is or before the first load).
why_unavailable = ""
# The libjpeg the library links: "system" or the path of Pillow's.
link = ""


def target() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS + LIBS).encode())
    return BUILD_DIR / f"libimageops-{h.hexdigest()[:16]}.so"


def _pillow_libjpeg() -> Optional[Path]:
    """The libjpeg of Pillow's package, found without importing PIL."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.origin:
        return None
    found = sorted((Path(spec.origin).resolve().parents[1] / "pillow.libs").glob(
        "libjpeg-*.so.62*"))
    return found[0] if found else None


def _build(so: Path) -> str:
    """Compile the library to ``so`` against the system libjpeg, else
    against Pillow's; returns "" or the reasons it failed."""
    global link
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    pillow = _pillow_libjpeg()
    tries = [("system", [*LIBS])]
    if pillow is not None:
        tries.append((str(pillow), ["-I", str(JPEG62), str(pillow),
                                    f"-Wl,-rpath,{pillow.parent}"]))
    errors = []
    for name, extra in tries:
        cmd = ["g++", *FLAGS, str(SRC), *extra, "-o", str(tmp)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"g++ did not run ({e})"
        if res.returncode == 0:
            so.with_suffix(".link").write_text(name)
            os.replace(tmp, so)
            link = name
            return ""
        errors.append(f"with the {name} libjpeg: {res.stderr.strip()[-400:]}")
    if pillow is None:
        errors.append("no libjpeg in Pillow's package either")
    return "g++ failed " + "; ".join(errors)


def load() -> Optional[ctypes.CDLL]:
    """The ctypes library handle, built if needed, or None."""
    global _lib, _tried, why_unavailable, link
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = target()
        lib = None
        for attempt in range(2):
            if attempt or not so.exists():
                why_unavailable = _build(so)
                if why_unavailable:
                    print(f"[csl_gan_tpu_torch] native image decoder not built: "
                          f"{why_unavailable}")
                    return None
            try:
                lib = ctypes.CDLL(str(so))
                break
            except OSError as e:       # built elsewhere: build it here once
                why_unavailable = f"could not load {so} ({e})"
        if lib is None:
            print(f"[csl_gan_tpu_torch] native image decoder: {why_unavailable}")
            return None
        why_unavailable = ""
        if not link and so.with_suffix(".link").exists():
            link = so.with_suffix(".link").read_text()
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.csl_decode_batch.restype = ctypes.c_int
        lib.csl_decode_batch.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                         u8p, u8p, ctypes.c_int]
        lib.csl_resample.restype = None
        lib.csl_resample.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                     u8p, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def decode_batch(paths, im_size: int, n_threads: int = 0):
    """Decode, resize and centre-crop JPEG files into one uint8 array
    [n, im_size, im_size, 3]; ``ok[i]`` is False where file i failed (its
    slice is then undefined). ``n_threads`` 0 means one per CPU."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native image decoder unavailable: {why_unavailable}")
    n = len(paths)
    out = np.empty((n, im_size, im_size, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    buf = b"\0".join(str(p).encode() for p in paths) + b"\0"
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.csl_decode_batch(buf, n, im_size, out.ctypes.data_as(u8p), ok.ctypes.data_as(u8p),
                         n_threads)
    return out, ok.astype(bool)


def resample(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """PIL-BILINEAR resample of an HWC uint8 RGB image."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native image decoder unavailable: {why_unavailable}")
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"resample takes RGB images, got {c} channels")
    out = np.empty((out_h, out_w, 3), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.csl_resample(img.ctypes.data_as(u8p), w, h, out.ctypes.data_as(u8p), out_w, out_h)
    return out
