"""Flax's msgpack checkpoints read and written without flax or msgpack
(counterpart of `flax.serialization.msgpack_restore` and
`msgpack_serialize`, flax 0.12.3 serialization.py:418).

A checkpoint is one msgpack object of nested maps with string keys whose
leaves are numbers, strings or flax's ext types:
  1  ndarray:       msgpack of (shape, dtype name, C-order bytes)
  2  complex:       msgpack of (real, imag)
  3  numpy scalar:  an ndarray of shape (), returned as its scalar
and arrays past 2^30 bytes are stored as `__msgpack_chunked_array__` maps of
flattened chunks. Arrays are read-only views of the file's bytes; bfloat16
arrays come back as torch tensors, since numpy has no bfloat16.
`msgpack_serialize` writes the same types (a torch tensor as the ndarray
of its values, bfloat16 included) in msgpack's shortest encodings, maps
in sorted key order, the bytes flax writes for such a tree; arrays past
2^30 bytes raise (flax would chunk them).
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


def _head(small: int, fix: int, codes: Tuple[int, int, int], n: int) -> bytes:
    """The type byte(s) of a sized object: fix | n below `small`, else the
    8-, 16- or 32-bit length form of `codes` (None where msgpack has
    none)."""
    if n < small:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of {n} entries or bytes")


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    kinds = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xCF, ">Q", 0, 2 ** 64 - 1), (0xD0, ">b", -128, 127),
             (0xD1, ">h", -2 ** 15, 2 ** 15 - 1), (0xD2, ">i", -2 ** 31, 2 ** 31 - 1),
             (0xD3, ">q", -2 ** 63, 2 ** 63 - 1))
    for code, fmt, lo, hi in kinds:
        if (v >= 0) == (lo == 0) and lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    if n in (1, 2, 4, 8, 16):
        head = bytes([0xD4 + n.bit_length() - 1])
    else:
        head = _head(0, 0, (0xC7, 0xC8, 0xC9), n)
    return head + struct.pack(">b", code) + data


def _pack_array(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return _pack((tuple(a.shape), "bfloat16", a.view(torch.int16).numpy().tobytes()))
        a = a.numpy()
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    if a.nbytes > 2 ** 30:
        raise ValueError(f"array of {a.nbytes} bytes: flax stores it chunked")
    return _pack((tuple(int(d) for d in a.shape), a.dtype.name, a.tobytes()))


def _pack(obj: Any) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        b = obj.encode("utf-8")
        return _head(32, 0xA0, (0xD9, 0xDA, 0xDB), len(b)) + b
    if isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        return _head(0, 0, (0xC4, 0xC5, 0xC6), len(b)) + b
    if isinstance(obj, (list, tuple)):
        return _head(16, 0x90, (None, 0xDC, 0xDD), len(obj)) + b"".join(map(_pack, obj))
    if isinstance(obj, dict):
        return _head(16, 0x80, (None, 0xDE, 0xDF), len(obj)) + b"".join(
            _pack(k) + _pack(obj[k]) for k in sorted(obj))
    if isinstance(obj, complex):
        return _pack_ext(_EXT_COMPLEX, _pack((obj.real, obj.imag)))
    if isinstance(obj, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _pack_array(np.asarray(obj)))
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return _pack_ext(_EXT_NDARRAY, _pack_array(obj))
    raise TypeError(f"{type(obj).__name__} is not a flax checkpoint leaf")


def msgpack_serialize(tree: Any) -> bytes:
    """`tree` (nested dicts with string keys; numpy, torch or Python
    leaves) as the bytes flax.serialization.msgpack_restore reads."""
    return _pack(tree)


def write_msgpack(path: str, tree: Any):
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))
