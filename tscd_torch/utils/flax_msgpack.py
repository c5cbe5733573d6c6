"""Flax's msgpack checkpoints read without flax or msgpack (counterpart of
`flax.serialization.msgpack_restore`, flax 0.12.3 serialization.py:418).

A checkpoint is one msgpack object of nested maps with string keys whose
leaves are numbers, strings or flax's ext types:
  1  ndarray:       msgpack of (shape, dtype name, C-order bytes)
  2  complex:       msgpack of (real, imag)
  3  numpy scalar:  an ndarray of shape (), returned as its scalar
and arrays past 2^30 bytes are stored as `__msgpack_chunked_array__` maps of
flattened chunks. Arrays are read-only views of the file's bytes; bfloat16
arrays come back as torch tensors, since numpy has no bfloat16.
"""

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """`views`: bin objects as memoryviews of the data (else bytes)."""

    def __init__(self, data, views: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.views = views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return self.take(n) if self.views else bytes(self.take(n))
            if b <= 0xC9:
                return self.ext(self.unpack(">b"), n)
            if b <= 0xDB:
                return self.str(n)
            if b <= 0xDD:
                return [self.obj() for _ in range(n)]
            return self.map(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:                  # fixext 1, 2, 4, 8, 16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte {b:#x} is not used by flax checkpoints")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int) -> Any:
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).obj()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not one of flax's")


def _ndarray(data: memoryview):
    shape, dtype, buf = _Reader(data, views=True).obj()
    dtype = dtype if isinstance(dtype, str) else bytes(dtype).decode()
    shape: Tuple[int, ...] = tuple(shape)
    if dtype == "bfloat16":
        raw = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The pytree flax.serialization.msgpack_restore gives for `data`:
    nested dicts with numpy leaves (read-only views of `data`)."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)


def read_msgpack(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
