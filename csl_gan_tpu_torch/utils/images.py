"""Image files of the port: the JAX package's utils/images.py (sample grids
as torchvision's ``save_image`` draws them: ``nrow`` images a row, 2 px
padding, values clamped to [0, 1] and rounded to 8 bits), with the PNG
written and read by the standard library (``zlib``, ``struct``) instead of
PIL.

``write_png`` writes 8-bit grey or RGB with filter 0 on every row; the
pixels equal those of the PNG PIL writes from the same array.
``read_png`` reads 8-bit grey, grey+alpha, RGB and RGBA PNGs, any of the
five row filters (PIL chooses them adaptively), without interlacing: the
files both packages write.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}       # PNG colour type -> samples a pixel


def denorm_celeba(img):
    """[-1, 1] -> [0, 1] (reference util.py:13-14)."""
    return np.clip((np.asarray(img) + 1.0) / 2.0, 0.0, 1.0)


def _to_uint8(img) -> np.ndarray:
    img = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
    return (img * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(arr: np.ndarray, path: str) -> None:
    """An 8-bit grey ([H, W]) or RGB ([H, W, 3]) uint8 array as a PNG."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 [H, W] or [H, W, 3], got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    colour = 0 if arr.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth)."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    data = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        ftype, line = data[r, 0], data[r, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) % 256
                   ).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[r] = cur
        prev = out[r]
    return out


def read_png(path: str) -> np.ndarray:
    """The pixels of an 8-bit PNG as uint8: [H, W] for grey, [H, W, C]
    otherwise (as ``np.asarray(PIL.Image.open(path))`` gives them)."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    i, header, idat = len(_SIGNATURE), None, []
    while i + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[i:i + 8])
        data = buf[i + 8:i + 8 + n]
        i += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace} cannot be read")
    ch = _CHANNELS[colour]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, ch)


def save_image(img: np.ndarray, path: str) -> None:
    """Save one HWC (or HW1) image in [0, 1]."""
    arr = _to_uint8(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    write_png(arr, path)


def save_image_grid(imgs: np.ndarray, path: str, nrow: int = 8,
                    padding: int = 2) -> None:
    """Tile a batch (NHWC, [0, 1]) into a grid PNG."""
    imgs = np.clip(np.asarray(imgs, dtype=np.float32), 0.0, 1.0)
    n, h, w, c = imgs.shape
    ncol = max(1, nrow)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        top = r * (h + padding) + padding
        left = col * (w + padding) + padding
        grid[top:top + h, left:left + w] = imgs[i]
    save_image(grid, path)
