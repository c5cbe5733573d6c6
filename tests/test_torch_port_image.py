"""The port's host image ops (tscd_torch/data/image.py, csrc/host/image.cpp)
against OpenCV, bit for bit, on the CPU:

  - BGR -> HSV over all 2^24 colours; HSV -> BGR over all 180 x 256 x 256
    triples, at a row width that is all vector loop and at two with a
    scalar tail (cv2's two paths round differently), and the jitter;
  - INTER_LINEAR resize from 128 x 128, 375 x 500, 720 x 1280 and a
    576 x 576 letterboxed window to the letterbox sizes at 576 and 128 and
    the +-3 x 64 multiscale sizes (exact 2x, upscales, odd sizes), and the
    same on float32, which OpenCV resizes through IPP (the multiscale path);
  - the JPEG decoder on the 16 frames of YOLOX_outputs/validate_ref/vid, on
    the 32 frames of tscd_torch/data/fixtures/vid (and the hashes recorded
    there of cv2's decode and of its letterbox and jitter, which
    chip_smoke.py holds the port to where there is no cv2), and on frames
    cv2.imencode writes at 1 x 1, 17 x 33 and 375 x 500, qualities 50, 75,
    95 and 100, 4:2:0, 4:2:2, 4:4:4 and grayscale, with and without restart
    intervals and optimised Huffman tables;
  - progressive, EXIF-rotated, CMYK and truncated files raise; an EXIF
    orientation of 1 decodes.
"""

import glob
import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest

from tscd_torch.data import image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OLD = os.path.join(REPO, "YOLOX_outputs", "validate_ref", "vid")
NEW = os.path.join(REPO, "tscd_torch", "data", "fixtures", "vid")


def _all_colours():
    c = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)


def _all_hsv():
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    return np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 3)


def test_bgr2hsv_equals_cv2_on_every_colour():
    bgr = _all_colours()
    assert np.array_equal(image.bgr2hsv(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("width", [256, 77, 31])
def test_hsv2bgr_equals_cv2_on_every_triple(width):
    hsv = _all_hsv()
    n = len(hsv) // width * width
    rows = np.ascontiguousarray(hsv[:n].reshape(-1, width, 3))
    assert np.array_equal(image.hsv2bgr(rows), cv2.cvtColor(rows, cv2.COLOR_HSV2BGR))
    if n < len(hsv):                              # the last triples, at their own width
        rest = np.ascontiguousarray(hsv[n:][None])
        assert np.array_equal(image.hsv2bgr(rest), cv2.cvtColor(rest, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("gains", [(5, 30, -30), (-5, -30, 30), (0, 0, 0), (3, 0, 17)])
def test_augment_hsv_equals_the_cv2_jitter(gains):
    rng = np.random.default_rng(sum(gains) + 40)
    img = rng.integers(0, 256, (101, 173, 3), dtype=np.uint8)
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV).astype(np.int16)
    g = np.asarray(gains, np.int16)
    hsv[..., 0] = (hsv[..., 0] + g[0]) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + g[1], 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + g[2], 0, 255)
    want = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)
    got = img.copy()
    image.augment_hsv(got, g)
    assert np.array_equal(got, want)


def _letterbox(h, w, size):
    r = min(size / h, size / w)
    return int(h * r), int(w * r)


_SOURCES = [(128, 128), (375, 500), (720, 1280), (576, 576)]


@pytest.mark.parametrize("src", _SOURCES, ids=[f"{h}x{w}" for h, w in _SOURCES])
def test_resize_equals_cv2_inter_linear(src):
    h, w = src
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    targets = {_letterbox(h, w, 576), _letterbox(h, w, 128), (h // 2, w // 2), (2 * h + 1, w + 3)}
    targets |= {(64 * k, 64 * k) for k in range(6, 13)}
    for th, tw in sorted(targets):
        want = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(image.resize_linear(img, th, tw), want), (th, tw)
    view = img[3:, 5:]                      # rows of another stride
    assert np.array_equal(image.resize_linear(view, 77, 91),
                          cv2.resize(view, (91, 77), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("src", _SOURCES, ids=[f"{h}x{w}" for h, w in _SOURCES])
def test_float_resize_equals_cv2_on_float32(src):
    """The multiscale resize: cv2.resize of the image as float32 (OpenCV's
    IPP path), fractional values equal bit for bit, at the same targets
    plus 8x wider; under 2 px a side or wider than that raises."""
    h, w = src
    img = np.random.default_rng(h + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    targets = {_letterbox(h, w, 576), _letterbox(h, w, 128), (h // 2, w // 2), (2 * h + 1, w + 3),
               (37, 8 * w)}
    targets |= {(64 * k, 64 * k) for k in range(6, 13)}
    for th, tw in sorted(targets):
        want = cv2.resize(img.astype(np.float32), (tw, th), interpolation=cv2.INTER_LINEAR)
        got = image.resize_linear_float(img, th, tw)
        assert got.dtype == np.float32 and np.array_equal(got, want), (th, tw)
    view = img[3:, 5:]
    assert np.array_equal(image.resize_linear_float(view, 77, 91), cv2.resize(
        view.astype(np.float32), (91, 77), interpolation=cv2.INTER_LINEAR))
    with pytest.raises(ValueError):
        image.resize_linear_float(img, h, 8 * w + 1)
    with pytest.raises(ValueError):
        image.resize_linear_float(img[:1], 4, 4)


def _frames(root):
    return sorted(glob.glob(os.path.join(root, "Data", "VID", "val", "*", "*.JPEG")))


@pytest.mark.parametrize("root", [OLD, NEW], ids=["validate_ref", "fixture_720p"])
def test_imread_equals_cv2_on_the_fixture_frames(root):
    paths = _frames(root)
    assert len(paths) == (16 if root == OLD else 32)
    with open(os.path.join(NEW, "frame_sha256.json")) as f:
        recorded = json.load(f)
    sha = lambda a: hashlib.sha256(a.tobytes()).hexdigest()   # noqa: E731
    for p in paths:
        got, want = image.imread(p), cv2.imread(p)
        assert got.shape == want.shape and np.array_equal(got, want), p
        rec = recorded["frames"][os.path.relpath(p, REPO)]
        assert rec["shape"] == list(got.shape) and rec["sha256"] == sha(got), p
        h, w = got.shape[:2]
        boxed = image.resize_linear(got, *_letterbox(h, w, 576))
        image.augment_hsv(boxed, recorded["hsv_gains"])
        assert rec["hsv_jitter_sha256"] == sha(boxed), p
        for size, want in rec["multiscale_sha256"].items():
            th, tw = (int(v) for v in size.split("x"))
            assert want == sha(image.resize_linear_float(_window(boxed), th, tw)), (p, size)
    if root == NEW:
        assert got.shape == (720, 1280, 3)


def _window(boxed):
    """A letterboxed frame in its 576 x 576 window (114 padding), as the
    collate places it."""
    win = np.full((576, 576, 3), 114, np.uint8)
    win[:boxed.shape[0], :boxed.shape[1]] = boxed
    return win


def _scene(h, w, seed):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 17 + y / 29), 128 + 100 * np.cos(x / 23 - y / 11),
                    128 + 90 * np.sin((x + y) / 13)], -1)
    img += np.random.default_rng(seed).normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


_SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "gray": None}


@pytest.mark.parametrize("size", [(1, 1), (17, 33), (375, 500)], ids=["1x1", "17x33", "375x500"])
def test_decoder_equals_cv2_on_encoded_frames(size):
    img = _scene(*size, seed=size[0])
    n = 0
    for q in (50, 75, 95, 100):
        for kind, factor in _SAMPLING.items():
            for rst in (0, 3):
                for opt in (0, 1):
                    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                              cv2.IMWRITE_JPEG_OPTIMIZE, opt]
                    src = img
                    if factor is None:
                        src = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
                    else:
                        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
                    ok, buf = cv2.imencode(".jpg", src, params)
                    assert ok
                    data = buf.tobytes()
                    want = cv2.imdecode(buf, cv2.IMREAD_COLOR)
                    got = image.imdecode(data)
                    assert np.array_equal(got, want), (q, kind, rst, opt)
                    n += 1
    assert n == 4 * 4 * 2 * 2


def _with_exif_orientation(data: bytes, orientation: int) -> bytes:
    """`data` with an APP1 Exif segment whose IFD0 holds only Orientation."""
    tiff = b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
    tiff += struct.pack("<HHII", 0x0112, 3, 1, orientation) + struct.pack("<I", 0)
    seg = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + data[2:]


def test_unsupported_jpegs_raise(tmp_path):
    img = _scene(40, 64, seed=3)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        image.imdecode(prog.tobytes())
    ok, base = cv2.imencode(".jpg", img)
    rotated = _with_exif_orientation(base.tobytes(), 6)
    assert cv2.imdecode(np.frombuffer(rotated, np.uint8), cv2.IMREAD_COLOR).shape == (64, 40, 3)
    with pytest.raises(ValueError, match="orientation 6"):
        image.imdecode(rotated)
    upright = _with_exif_orientation(base.tobytes(), 1)
    assert np.array_equal(image.imdecode(upright),
                          cv2.imdecode(np.frombuffer(upright, np.uint8), cv2.IMREAD_COLOR))
    cmyk = bytearray(base.tobytes())
    sof = cmyk.index(b"\xff\xc0")
    cmyk[sof + 9] = 4                                # the frame's component count
    with pytest.raises(ValueError, match="4-component"):
        image.imdecode(bytes(cmyk))
    with pytest.raises(ValueError, match="not a JPEG"):
        image.imdecode(b"\x89PNG\r\n")
    # a file cut inside its scan: cv2.imread fills the rest in (with a
    # warning); the port does not guess those pixels
    for rst in (0, 2):
        ok, full = cv2.imencode(".jpg", _scene(120, 200, seed=4), [cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        cut = tmp_path / f"cut{rst}.jpg"
        cut.write_bytes(full.tobytes()[:len(full) // 2])
        assert cv2.imread(str(cut)) is not None
        with pytest.raises(ValueError, match="truncated or corrupt"):
            image.imread(str(cut))
