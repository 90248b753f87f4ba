"""The subset of MessagePack that flax's ``msgpack_serialize`` writes, so the
port reads and writes the JAX package's checkpoints without msgpack or flax.

Encoded: maps (str keys, written in the dict's order), str, int, float
(float64), bool, nil, bytes (bin), lists (arrays), numpy arrays as ext 1 and
numpy scalars as ext 3. An ext payload is itself MessagePack: the array
``[shape, dtype name, C-order bytes]``, as flax's ``_ndarray_to_bytes``
packs it (a numpy scalar is packed as its 0-d array). flax splits a leaf
above 2**30 bytes into chunks; no save of the ported models comes near that,
so such a leaf raises here instead.

Decoding reads a ``memoryview``: array leaves are numpy views of the input
buffer (read-only when it is ``bytes``), not copies.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_LEAF_BYTES = 2 ** 30      # flax's MAX_CHUNK_SIZE


def _uint(n: int, small: int, tags: bytes) -> bytes:
    """Header of a str/bin/array/map of length n: fix form below `small`
    (tags[0] | n; small 0 = none), else the 8/16/32-bit length forms."""
    if n < small:
        return bytes([tags[0] | n])
    if tags[1] and n < 0x100:
        return bytes([tags[1], n])
    if n < 0x10000:
        return bytes([tags[2]]) + struct.pack(">H", n)
    if n < 0x100000000:
        return bytes([tags[3]]) + struct.pack(">I", n)
    raise ValueError(f"msgpack object of length {n} is too long")


_STR = bytes([0xA0, 0xD9, 0xDA, 0xDB])
_BIN = bytes([0x00, 0xC4, 0xC5, 0xC6])
_ARR = bytes([0x90, 0x00, 0xDC, 0xDD])
_MAP = bytes([0x80, 0x00, 0xDE, 0xDF])


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for tag, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                              (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit in 64 bits")


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    if n < 0x100:
        return bytes([0xC7, n, code])
    if n < 0x10000:
        return bytes([0xC8]) + struct.pack(">H", n) + bytes([code])
    return bytes([0xC9]) + struct.pack(">I", n) + bytes([code])


def _ndarray(a: np.ndarray, code: int, out: List) -> None:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"cannot pack an array of dtype {a.dtype}")
    if a.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"array leaf of {a.nbytes} bytes exceeds {MAX_LEAF_BYTES}; "
                         "flax would chunk it, which this encoder does not do")
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    name = a.dtype.name.encode()
    head = (_uint(3, 16, _ARR) + _uint(a.ndim, 16, _ARR)
            + b"".join(_int(int(d)) for d in a.shape)
            + _uint(len(name), 32, _STR) + name + _uint(a.nbytes, 0, _BIN))
    out.append(_ext_header(code, len(head) + a.nbytes))
    out.append(head)
    out.append(memoryview(a.reshape(-1).view(np.uint8)))


def _pack(obj: Any, out: List) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        b = obj.encode()
        out.append(_uint(len(b), 32, _STR))
        out.append(b)
    elif type(obj) is bytes:
        out.append(_uint(len(obj), 0, _BIN))
        out.append(obj)
    elif type(obj) is list:
        out.append(_uint(len(obj), 16, _ARR))
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        out.append(_uint(len(obj), 16, _MAP))
        for k, v in obj.items():
            if type(k) is not str:
                raise TypeError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _ndarray(obj, EXT_NDARRAY, out)
    elif isinstance(obj, np.generic):
        _ndarray(np.asarray(obj), EXT_NPSCALAR, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """MessagePack bytes of `obj`, byte for byte as flax's
    ``msgpack_serialize`` writes the same tree (same key order)."""
    out: List = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, buf):
        self.m = memoryview(buf).cast("B")
        self.i = 0

    def take(self, n: int) -> memoryview:
        j = self.i + n
        if j > len(self.m):
            raise ValueError("truncated msgpack data")
        v = self.m[self.i:j]
        self.i = j
        return v

    def u(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in lens:
            return bytes(self.take(self.u(lens[t])))
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in nums:
            return self.u(nums[t])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in strs:
            return self.str(self.u(strs[t]))
        if t in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.u(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self.map(self.u(">H" if t == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            n = fixext[t]
        elif t in (0xC7, 0xC8, 0xC9):
            n = self.u({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
        else:
            raise ValueError(f"msgpack type byte 0x{t:02x} is outside the subset")
        code = self.take(1)[0]
        return self.ext(code, self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode()

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, data: memoryview):
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is outside the subset")
        r = _Reader(data)
        head = r.take(1)[0]
        if head != 0x93:
            raise ValueError("malformed ndarray ext")
        shape = r.obj()
        name = r.obj()
        t = r.take(1)[0]
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t not in lens:
            raise ValueError("malformed ndarray ext: no bin payload")
        buf = r.take(r.u(lens[t]))
        name = name.decode() if isinstance(name, bytes) else name
        try:
            dtype = np.dtype(name)
        except TypeError:
            dtype = None
        if dtype is None or dtype.kind not in "biufc":      # e.g. bfloat16
            raise ValueError(f"array dtype {name!r} cannot be read")
        a = np.frombuffer(buf, dtype=dtype).reshape(shape)
        return a[()] if code == EXT_NPSCALAR else a


def unpackb(data) -> Any:
    """The tree of MessagePack `data` (bytes, bytearray or memoryview), as
    flax's ``msgpack_restore`` returns it. Raises ValueError on data outside
    the subset or on trailing bytes."""
    r = _Reader(data)
    out = r.obj()
    if r.i != len(r.m):
        raise ValueError(f"{len(r.m) - r.i} trailing bytes after the msgpack object")
    return out
