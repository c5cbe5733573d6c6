"""The OpenCV calls of the JAX package's data path, without OpenCV
(tscd_torch/csrc/host/image.cpp, built and loaded by `utils.native`):

    imread(path)                   cv2.imread(path): BGR uint8 (H, W, 3)
    imencode_jpeg(img)             cv2.imencode(".jpg", img)[1].tobytes()
    imwrite(path, img)             cv2.imwrite(path, img) for a .jpg path
    resize_linear(img, h, w)       cv2.resize(img, (w, h), INTER_LINEAR)
    resize_linear_float(img, h, w) the same on img.astype(float32): float32
    bgr2hsv(img) / hsv2bgr(img)    cv2.cvtColor(COLOR_BGR2HSV / _HSV2BGR)
    augment_hsv(img, gains)        transforms.py:augment_hsv with given gains
    warp_affine(img, M, (w, h))    cv2.warpAffine(img, M, (w, h), INTER_LINEAR,
                                   borderValue=(114, 114, 114))
    rotation_matrix_2d(...)        cv2.getRotationMatrix2D, in numpy

Each equals the cv2 5.0.0 call bit for bit, as the x86-64 wheel computes it
(libjpeg-turbo 3.1.2; resize's SSE loops, and IPP's for float32; the HSV
inverse's AVX2 loop; warpAffine's float kernels):
tests/test_torch_port_image.py holds them to cv2. The decoder reads
baseline JPEGs (8-bit, Huffman, one scan; grayscale or YCbCr at 4:4:4,
4:2:2 or 4:2:0) and raises on any other kind, on an EXIF orientation
that cv2.imread would apply, and on a scan that ends early (cv2 fills a
truncated file in). Every call releases the GIL.
"""

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np

from ..utils.native import HostLibrary

_P = ctypes.c_void_p
_L = ctypes.c_int64
_I = ctypes.c_int
_ERR = 512
_NATIVE = HostLibrary(
    "image.cpp",
    # no contraction: the fused multiply-adds the HSV inverse needs are
    # written out as fmaf, and no other operation may fuse. -march=native
    # makes fmaf an instruction; IEEE operations round alike on any ISA.
    ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"], {
        "tscd_bgr2hsv": ([_P, _P, _L], _I),
        "tscd_hsv2bgr": ([_P, _P, _L, _L], _I),
        "tscd_hsv_jitter": ([_P, _L, _L, _I, _I, _I], _I),
        "tscd_resize_linear": ([_P, _I, _I, _L, _P, _I, _I, _I], _I),
        "tscd_resize_linear_f32": ([_P, _I, _I, _L, _P, _I, _I, _I], _I),
        "tscd_warp_affine": ([_P, _I, _I, _L, _P, _I, _I, _P, _I], _I),
        "tscd_jpeg_info": ([_P, _L, _P, _P, ctypes.c_char_p, _I], _I),
        "tscd_jpeg_decode": ([_P, _L, _P, _I, _I, ctypes.c_char_p, _I], _I),
        "tscd_jpeg_encode": ([_P, _I, _I, _L, _P, _L, _P, ctypes.c_char_p, _I], _I),
    })
load_library = _NATIVE.load


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def _bgr(img: np.ndarray, name: str) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{name} takes an (H, W, 3) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def imdecode(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) uint8 BGR, as cv2.imdecode(data,
    IMREAD_COLOR) and cv2.imread give it. Grayscale gives three equal
    channels. Raises ValueError for a kind of JPEG it does not read."""
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    h, w = _I(), _I()
    if lib.tscd_jpeg_info(_ptr(buf), len(buf), ctypes.byref(h), ctypes.byref(w), err, _ERR):
        raise ValueError(err.value.decode())
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.tscd_jpeg_decode(_ptr(buf), len(buf), _ptr(out), h.value, w.value, err, _ERR):
        raise ValueError(err.value.decode())
    return out


def imread(path: str) -> np.ndarray:
    """cv2.imread(path) for a baseline JPEG file. Raises FileNotFoundError
    where the file is missing (cv2 returns None) and ValueError, naming the
    file, for a kind of JPEG it does not read."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return imdecode(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def imencode_jpeg(img: np.ndarray) -> bytes:
    """cv2.imencode(".jpg", img) at cv2's defaults for an (H, W, 3) uint8 BGR
    image: baseline, quality 95, YCbCr 4:2:0, the islow DCT, the standard
    Huffman tables, a JFIF 1.01 header; the same bytes."""
    img = _bgr(img, "imencode_jpeg")
    h, w = img.shape[:2]
    lib = load_library()
    err = ctypes.create_string_buffer(_ERR)
    n = _L()
    cap = 4 * h * w + 4096  # quality 95 on noise stays under 2.5 bytes a pixel
    while True:
        out = np.empty(cap, np.uint8)
        if lib.tscd_jpeg_encode(_ptr(img), h, w, img.strides[0], _ptr(out), cap,
                                ctypes.byref(n), err, _ERR) == 0:
            return out[:n.value].tobytes()
        if n.value <= cap:
            raise ValueError(err.value.decode())
        cap = n.value


def imwrite(path: str, img: np.ndarray) -> None:
    """cv2.imwrite(path, img) for a .jpg/.jpeg path (the bytes of
    `imencode_jpeg`); any other extension raises, naming it."""
    ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
    if ext not in ("jpg", "jpeg"):
        raise ValueError(f"imwrite writes JPEG only (.jpg, .jpeg), not {path!r}")
    data = imencode_jpeg(img)
    with open(path, "wb") as f:
        f.write(data)


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=INTER_LINEAR) for an
    (H, W, 3) uint8 image (an exact 2x downscale is cv2's INTER_AREA fast
    path, as there)."""
    img = _bgr(img, "resize_linear")
    out = np.empty((height, width, 3), np.uint8)
    if load_library().tscd_resize_linear(_ptr(img), img.shape[0], img.shape[1],
                                         img.strides[0], _ptr(out), height, width, 3):
        raise ValueError(f"resize {img.shape} -> {(height, width)}")
    return out


def resize_linear_float(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img.astype(np.float32), (width, height),
    interpolation=INTER_LINEAR) for an (H, W, 3) uint8 image: float32 with
    fractional values, as JAX's trainer resizes its float32 windows
    (OpenCV hands float32 to IPP, whose arithmetic differs from the uint8
    path's). Raises ValueError for a source under 2 px a side or a width
    more than 8x the source's, where IPP's borders are not matched."""
    img = _bgr(img, "resize_linear_float")
    out = np.empty((height, width, 3), np.float32)
    if load_library().tscd_resize_linear_f32(_ptr(img), img.shape[0], img.shape[1],
                                             img.strides[0], _ptr(out), height, width, 3):
        raise ValueError(f"float resize {img.shape} -> {(height, width)}: sources of 2 px "
                         "a side and up to 8x wider only")
    return out


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HSV): H in 0..179."""
    img = _bgr(img, "bgr2hsv")
    out = np.empty_like(img)
    load_library().tscd_bgr2hsv(_ptr(img), _ptr(out), img.shape[0] * img.shape[1])
    return out


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2BGR) for H in 0..179. Which pixels take
    cv2's vector loop depends on the row width, so the result does too: pass
    the image, not a reshaped one."""
    img = _bgr(img, "hsv2bgr")
    out = np.empty_like(img)
    load_library().tscd_hsv2bgr(_ptr(img), _ptr(out), img.shape[0], img.shape[1])
    return out


def augment_hsv(img: np.ndarray, gains: Sequence[int]) -> None:
    """In place: JAX's HSV jitter (tscd_tpu/data/transforms.py:augment_hsv,
    and the collate's copy of it) with the int16 `gains` (h, s, v) already
    drawn: H + h mod 180, S + s and V + v clipped to 0..255, back to BGR."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 \
            or not img.flags.c_contiguous:
        raise ValueError("augment_hsv works in place on a C-contiguous (H, W, 3) "
                         f"uint8 image, got {img.dtype} {img.shape}")
    h, s, v = (int(g) for g in gains)
    load_library().tscd_hsv_jitter(_ptr(img), img.shape[0], img.shape[1], h, s, v)


def warp_affine(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int],
                border: int = 114) -> np.ndarray:
    """cv2.warpAffine(img, M, dsize=(w, h), borderValue=(border,) * 3) for
    an (H, W, 3) uint8 image and a (2, 3) matrix: bilinear, constant border,
    the output pixel (x, y) read at M^-1 (x, y)."""
    img = _bgr(img, "warp_affine")
    m = np.ascontiguousarray(np.asarray(M, np.float64).reshape(2, 3))
    w, h = (int(v) for v in dsize)
    out = np.empty((h, w, 3), np.uint8)
    if load_library().tscd_warp_affine(_ptr(img), img.shape[0], img.shape[1], img.strides[0],
                                       _ptr(out), h, w, _ptr(m), int(border)):
        raise ValueError(f"warp_affine {img.shape} -> {(h, w)}, border {border}")
    return out


def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale): the (2, 3) float64
    matrix of a rotation by `angle` degrees (counter-clockwise) about
    `center` (a float32 point, as cv2's Point2f), scaled by `scale`."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)
