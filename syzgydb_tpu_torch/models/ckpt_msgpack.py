"""A dependency-free reader and writer for flax msgpack checkpoints.

`flax.serialization.to_bytes` / `from_bytes` write and read a state tree as
msgpack: nested str-keyed maps whose array leaves are msgpack extension
objects.  This module handles the subset those functions emit:

- maps, arrays, str, bin, ints, floats, bool and nil;
- ext type 1: an ndarray, itself the msgpack triple (shape, dtype name,
  C-order bytes);
- ext type 3: a numpy scalar, packed as a 0-d ndarray.

`dumps` writes the same bytes as `flax.serialization.msgpack_serialize` on
the same tree (numpy arrays and scalars as leaves; a bf16 leaf is a
`torch.bfloat16` tensor, numpy having no such dtype).  `loads` returns
numpy arrays (bf16 leaves as `torch.bfloat16` tensors).  Flax splits an
array of more than 2**30 bytes into chunks; no embedder checkpoint holds
one, and a chunked tree is refused with `ChunkedArrayError`.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNK_MARK = "__msgpack_chunked_array__"


class ChunkedArrayError(ValueError):
    """The tree holds an array that flax wrote in chunks (> 2**30 bytes)."""


# -- writer ------------------------------------------------------------------


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif 0xFF < v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x8000 <= v < -0x80:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif -0x80000000 <= v < -0x8000:
        out += b"\xd2" + struct.pack(">i", v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack")


def _sized(out: bytearray, n: int, fix: int | None, fix_max: int,
           heads: tuple) -> None:
    """A length header: the fix form below fix_max, else the 8/16/32-bit
    forms whose lead bytes are `heads` (None where a form does not exist)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for head, limit, fmt in zip(heads, (0xFF, 0xFFFF, 0xFFFFFFFF),
                                (">B", ">H", ">I")):
        if head is not None and n <= limit:
            out += bytes([head]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _bin(out: bytearray, b: bytes) -> None:
    _sized(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
    out += b


def _str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _sized(out, len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
    out += b


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _sized(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack("b", code)
    out += data


def _array_bytes(shape, name: str, raw: bytes) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack (shape, dtype name, bytes)."""
    out = bytearray()
    out.append(0x93)
    _sized(out, len(shape), 0x90, 0x0F, (None, 0xDC, 0xDD))
    for d in shape:
        _int(out, int(d))
    _str(out, name)
    _bin(out, raw)
    return bytes(out)


def _leaf(x) -> tuple:
    """-> (shape, dtype name, C-order bytes) of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (tuple(t.shape), "bfloat16",
                    t.view(torch.int16).numpy().tobytes())
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return x.shape, x.dtype.name, x.tobytes("C")


def _pack(out: bytearray, x) -> None:
    t = type(x)
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif t is int:
        _int(out, x)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif t is str:
        _str(out, x)
    elif t in (bytes, bytearray):
        _bin(out, bytes(x))
    elif t is list:
        _sized(out, len(x), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif t is dict:
        _sized(out, len(x), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _ext(out, EXT_NDARRAY, _array_bytes(*_leaf(x)))
    elif isinstance(x, np.generic):
        _ext(out, EXT_NPSCALAR, _array_bytes(*_leaf(np.asarray(x))))
    else:
        raise TypeError(f"cannot write {t.__name__} to a flax msgpack tree")


def dumps(tree) -> bytes:
    """The msgpack bytes flax writes for `tree` (flax.serialization.to_bytes
    of a tree of dicts with array leaves)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# -- reader ------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def value(self):
        b = self.num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.num((">B", ">H", ">I")[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.num((">B", ">H", ">I")[b - 0xC7])
            return self.ext(n)
        if b == 0xCA:
            return self.num(">f")
        if b == 0xCB:
            return self.num(">d")
        if 0xCC <= b <= 0xD3:
            return self.num((">B", ">H", ">I", ">Q",
                             ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.num((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            n = self.num(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map_(self.num(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNK_MARK in out:
            raise ChunkedArrayError(
                "the checkpoint holds an array that flax wrote in chunks "
                "(over 2**30 bytes); chunked arrays are not supported")
        return out

    def ext(self, n: int):
        code = self.num(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == EXT_NPSCALAR:
            return _array_from_bytes(data)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _array_from_bytes(data: bytes):
    r = _Reader(data)
    triple = r.value()
    if r.pos != len(data) or not (isinstance(triple, list)
                                  and len(triple) == 3):
        raise ValueError("malformed ndarray leaf")
    shape, name, raw = triple
    if name == "bfloat16":
        t = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
        return t.reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def loads(data: bytes):
    """The tree a flax msgpack blob holds (flax.serialization.msgpack_restore),
    with numpy array leaves (bf16 ones as torch.bfloat16 tensors)."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes after the "
                         "msgpack tree")
    return tree
