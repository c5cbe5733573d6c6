"""Box drawing (tscd_tpu/utils/visualize.py:vis) without OpenCV: the
rectangles and labels are drawn by the port's host C++
(tscd_torch/csrc/host/draw.cpp, built and loaded by `utils.native`), bit for
bit as cv2 5.0.0 draws them (tests/test_torch_port_draw.py)."""

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from .native import HostLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int
_NATIVE = HostLibrary(
    "draw.cpp", ["-O2", "-std=c++17", "-shared", "-fPIC"], {
        "tscd_rectangle": ([_P, _I, _I, ctypes.c_int64, _I, _I, _I, _I, _P, _I], _I),
        "tscd_text_size": ([ctypes.c_char_p, _P, _P, _P], _I),
        "tscd_put_text": ([_P, _I, _I, ctypes.c_int64, ctypes.c_char_p, _I, _I, _P], _I),
    })

_COLORS = (np.array([
    0.000, 0.447, 0.741, 0.850, 0.325, 0.098, 0.929, 0.694, 0.125,
    0.494, 0.184, 0.556, 0.466, 0.674, 0.188, 0.301, 0.745, 0.933,
    0.635, 0.078, 0.184, 0.300, 0.300, 0.300, 0.600, 0.600, 0.600,
    1.000, 0.000, 0.000, 1.000, 0.500, 0.000, 0.749, 0.749, 0.000,
    0.000, 1.000, 0.000, 0.000, 0.000, 1.000, 0.667, 0.000, 1.000,
    0.333, 0.333, 0.000, 0.333, 0.667, 0.000, 0.333, 1.000, 0.000,
    0.667, 0.333, 0.000, 0.667, 0.667, 0.000, 0.667, 1.000, 0.000,
    1.000, 0.333, 0.000, 1.000, 0.667, 0.000, 1.000, 1.000, 0.000,
    0.000, 0.333, 0.500, 0.000, 0.667, 0.500, 0.000, 1.000, 0.500,
    0.333, 0.000, 0.500, 0.333, 0.333, 0.500, 0.333, 0.667, 0.500,
]).astype(np.float32).reshape(-1, 3))


def _image(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 \
            or img.strides[1:] != (3, 1):
        raise ValueError("draws on an (H, W, 3) uint8 image with contiguous rows, got "
                         f"{img.dtype} {img.shape}")
    return img


def _color(color) -> np.ndarray:
    return np.asarray([int(c) for c in color], np.uint8)


def _text(text: str) -> bytes:
    if not all(" " <= c <= "~" for c in text):
        raise ValueError(f"draws printable ASCII only, got {text!r}")
    return text.encode("ascii")


def rectangle(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color,
              thickness: int) -> np.ndarray:
    """cv2.rectangle(img, p0, p1, color, thickness) in place, for thickness 2
    or -1 (filled); returns img."""
    _image(img)
    c = _color(color)
    if _NATIVE.load().tscd_rectangle(img.ctypes.data, img.shape[0], img.shape[1],
                                     img.strides[0], int(p0[0]), int(p0[1]), int(p1[0]),
                                     int(p1[1]), c.ctypes.data, int(thickness)):
        raise ValueError(f"rectangle draws thickness 2 or -1, not {thickness}")
    return img


def get_text_size(text: str) -> Tuple[Tuple[int, int], int]:
    """cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, 0.4, 1): ((w, h), baseline)."""
    w, h, b = _I(), _I(), _I()
    _NATIVE.load().tscd_text_size(_text(text), ctypes.byref(w), ctypes.byref(h),
                                  ctypes.byref(b))
    return (w.value, h.value), b.value


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], color) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.4, color, 1) in
    place; returns img."""
    _image(img)
    c = _color(color)
    _NATIVE.load().tscd_put_text(img.ctypes.data, img.shape[0], img.shape[1], img.strides[0],
                                 _text(text), int(org[0]), int(org[1]), c.ctypes.data)
    return img


def vis(img: np.ndarray, boxes, scores, cls_ids, conf: float = 0.5,
        class_names: Optional[Sequence[str]] = None) -> np.ndarray:
    """Draws each box whose score is at least `conf`, with its label, into
    `img` (BGR uint8) and returns it, as tscd_tpu/utils/visualize.py:vis."""
    for i in range(len(boxes)):
        if scores[i] < conf:
            continue
        x0, y0, x1, y1 = (int(v) for v in boxes[i][:4])
        cls_id = int(cls_ids[i])
        color = (_COLORS[cls_id % len(_COLORS)] * 255).astype(
            np.uint8).tolist()
        name = (class_names[cls_id] if class_names
                and cls_id < len(class_names) else str(cls_id))
        text = f"{name}:{scores[i] * 100:.1f}%"
        txt_color = ((0, 0, 0) if np.mean(
            _COLORS[cls_id % len(_COLORS)]) > 0.5 else (255, 255, 255))
        txt_size = get_text_size(text)[0]
        rectangle(img, (x0, y0), (x1, y1), color, 2)
        txt_bk = (_COLORS[cls_id % len(_COLORS)] * 255 * 0.7).astype(
            np.uint8).tolist()
        rectangle(img, (x0, y0 + 1),
                  (x0 + txt_size[0] + 1, y0 + int(1.5 * txt_size[1])),
                  txt_bk, -1)
        put_text(img, text, (x0, y0 + txt_size[1]), txt_color)
    return img
