"""Frame input and video output of the demos without OpenCV.

`read_frames(path)` is tools/tscd_demo.py:read_frames for a directory of
JPEG frames, read by the port's `imread`. A video file or a camera needs
cv2.VideoCapture's decoders, which the card's machine lacks: it raises.

`VideoWriter(path, fps, (w, h))` stands where the JAX tools call
`cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))`. The
card's machine has no MPEG-4 Part 2 encoder, so it writes Motion JPEG in an
MP4 (ISO BMFF) file at the same path: one video track at `fps` frames a
second, each sample one frame's `imencode_jpeg` bytes (an `mp4v` sample
entry whose `esds` names object type 0x6C, JPEG, as ffmpeg writes MJPEG in
MP4). The frames are the same; only the codec differs. `read_mp4` parses
such a file back into its samples.
"""

import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..data.image import imencode_jpeg, imread

FRAME_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def read_frames(path: str) -> Iterator[np.ndarray]:
    """The frames of an image directory in file-name order (the JAX demo's
    extensions; JPEG only is decoded, another raises naming the file).
    Anything but a directory raises: reading a video file or a camera needs
    cv2.VideoCapture."""
    if not os.path.isdir(path):
        raise NotImplementedError(
            f"{path!r} is not a directory of frames: reading a video file or a camera "
            "needs cv2.VideoCapture's decoders, which the port does not have; pass a "
            "directory of JPEG frames")
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if os.path.splitext(f)[1].lower() in FRAME_EXTENSIONS)
    for f in files:
        if os.path.splitext(f)[1].lower() not in (".jpg", ".jpeg"):
            raise NotImplementedError(f"{f}: the port decodes JPEG frames only")
        yield imread(f)


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _descriptor(tag: int, body: bytes) -> bytes:
    n = len(body)  # the four-byte length form, as ffmpeg writes it
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
_MJPEG_OTI = 0x6C  # ISO/IEC 14496-1 objectTypeIndication: JPEG


class VideoWriter:
    """Motion JPEG in MP4: `write(frame)` appends a BGR uint8 (h, w, 3)
    frame, `release()` writes the index. The samples go to the file as they
    come; the index (`moov`) follows them."""

    def __init__(self, path: str, fps: int = 25, size: Tuple[int, int] = (0, 0)):
        self.path = path
        self.fps = int(fps)
        self.width, self.height = (int(v) for v in size)
        if self.fps <= 0 or self.width <= 0 or self.height <= 0:
            raise ValueError(f"VideoWriter needs fps and a size > 0, got {fps}, {size}")
        self.sizes: List[int] = []
        self.f = open(path, "wb")
        ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
        self.f.write(ftyp)
        self.mdat_at = len(ftyp)
        self.f.write(struct.pack(">I", 1) + b"mdat" + struct.pack(">Q", 0))  # 64-bit size

    def write(self, frame: np.ndarray) -> None:
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"frame of shape {frame.shape} for a {self.width} x "
                             f"{self.height} video")
        data = imencode_jpeg(frame)
        self.f.write(data)
        self.sizes.append(len(data))

    def _moov(self, chunk_offset: int) -> bytes:
        n, w, h = len(self.sizes), self.width, self.height
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, self.fps, n),
                     struct.pack(">IH", 0x10000, 0x100), bytes(10), _MATRIX, bytes(24),
                     struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIII", 0, 0, 1, 0), struct.pack(">I", n),
                     bytes(8), struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                     struct.pack(">II", w << 16, h << 16))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, self.fps, n),
                     struct.pack(">HH", 0x55C4, 0))  # language "und"
        hdlr = _full(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide", bytes(12),
                     b"VideoHandler\0")
        vmhd = _full(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full(b"url ", 0, 1)))
        biggest = max(self.sizes, default=0)
        dec = _descriptor(4, struct.pack(">BB", _MJPEG_OTI, 0x11) + biggest.to_bytes(3, "big")
                          + struct.pack(">II", 0, 0))
        es = _descriptor(3, struct.pack(">HB", 1, 0) + dec + _descriptor(6, b"\x02"))
        name = b"Motion JPEG"
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                     struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1),
                     bytes([len(name)]) + name + bytes(31 - len(name)),
                     struct.pack(">Hh", 0x18, -1), _full(b"esds", 0, 0, es))
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, 1) if n else struct.pack(">I", 0))
        stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1) if n else struct.pack(">I", 0))
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n), struct.pack(f">{n}I", *self.sizes))
        stco = (_full(b"co64", 0, 0, struct.pack(">IQ", 1, chunk_offset)) if n else
                _full(b"stco", 0, 0, struct.pack(">I", 0)))
        stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)
        minf = _box(b"minf", vmhd, dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)

    def release(self) -> None:
        if self.f is None:
            return
        end = self.f.tell()
        self.f.seek(self.mdat_at + 8)
        self.f.write(struct.pack(">Q", end - self.mdat_at))
        self.f.seek(end)
        self.f.write(self._moov(self.mdat_at + 16))
        self.f.close()
        self.f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def _boxes(data: bytes, lo: int, hi: int) -> Iterator[Tuple[bytes, int, int]]:
    """(kind, body start, box end) of each box in data[lo:hi]."""
    while lo + 8 <= hi:
        size, kind = struct.unpack(">I4s", data[lo:lo + 8])
        head = 8
        if size == 1:
            size = struct.unpack(">Q", data[lo + 8:lo + 16])[0]
            head = 16
        elif size == 0:
            size = hi - lo
        if size < head or lo + size > hi:
            raise ValueError(f"corrupt box {kind!r} at {lo}")
        yield kind, lo + head, lo + size
        lo += size


def _child(data: bytes, lo: int, hi: int, kind: bytes) -> Tuple[int, int]:
    for k, b, e in _boxes(data, lo, hi):
        if k == kind:
            return b, e
    raise ValueError(f"no {kind.decode()} box")


def read_mp4(path: str) -> Dict:
    """Parses an MP4 file's first video track: {"codec": the sample entry's
    four characters, "object_type": its esds objectTypeIndication or None,
    "width", "height", "fps", "samples": [bytes, ...]}."""
    with open(path, "rb") as f:
        data = f.read()
    moov = _child(data, 0, len(data), b"moov")
    for kind, b, e in _boxes(data, *moov):
        if kind != b"trak":
            continue
        mdia = _child(data, b, e, b"mdia")
        hb, _ = _child(data, *mdia, b"hdlr")
        if data[hb + 8:hb + 12] != b"vide":
            continue
        mb, _ = _child(data, *mdia, b"mdhd")
        timescale = struct.unpack(">I", data[mb + 12:mb + 16])[0]
        stbl = _child(data, *_child(data, *mdia, b"minf"), b"stbl")
        sb, _ = _child(data, *stbl, b"stsd")
        entry = next(_boxes(data, sb + 8, stbl[1]))
        codec = entry[0].decode("latin-1")
        width, height = struct.unpack(">HH", data[entry[1] + 24:entry[1] + 28])
        oti = None
        for k, eb, _ in _boxes(data, entry[1] + 78, entry[2]):
            if k == b"esds":
                i = data.index(bytes([4]), eb + 4 + 5 + 3)  # DecoderConfigDescriptor
                oti = data[i + 5]
        tb, _ = _child(data, *stbl, b"stts")
        deltas = []
        for i in range(struct.unpack(">I", data[tb + 4:tb + 8])[0]):
            count, delta = struct.unpack(">II", data[tb + 8 + 8 * i:tb + 16 + 8 * i])
            deltas += [delta] * count
        zb, _ = _child(data, *stbl, b"stsz")
        fixed, count = struct.unpack(">II", data[zb + 4:zb + 12])
        sizes = ([fixed] * count if fixed else
                 list(struct.unpack(f">{count}I", data[zb + 12:zb + 12 + 4 * count])))
        try:
            ob, _ = _child(data, *stbl, b"co64")
            n = struct.unpack(">I", data[ob + 4:ob + 8])[0]
            offsets = list(struct.unpack(f">{n}Q", data[ob + 8:ob + 8 + 8 * n]))
        except ValueError:
            ob, _ = _child(data, *stbl, b"stco")
            n = struct.unpack(">I", data[ob + 4:ob + 8])[0]
            offsets = list(struct.unpack(f">{n}I", data[ob + 8:ob + 8 + 4 * n]))
        cb, _ = _child(data, *stbl, b"stsc")
        runs = [struct.unpack(">III", data[cb + 8 + 12 * i:cb + 20 + 12 * i])
                for i in range(struct.unpack(">I", data[cb + 4:cb + 8])[0])]
        samples, k = [], 0
        for c, off in enumerate(offsets, start=1):
            per = next(r[1] for r in reversed(runs) if r[0] <= c)
            for _ in range(per):
                samples.append(data[off:off + sizes[k]])
                off += sizes[k]
                k += 1
        if k != count:
            raise ValueError(f"{path}: {count} sample sizes for {k} samples in chunks")
        fps = timescale / deltas[0] if deltas and deltas[0] else 0.0
        return {"codec": codec, "object_type": oti, "width": width, "height": height,
                "fps": fps, "samples": samples}
    raise ValueError(f"{path}: no video track")
