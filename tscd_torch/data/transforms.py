"""Host image transforms of still-image training and eval (counterpart of
tscd_tpu/data/transforms.py; reference yolox/data/data_augment.py), on
HWC uint8 BGR images, through `data.image` (cv2's pixels, no OpenCV).

The JAX package draws from the global `random` and `np.random` modules;
here each transform takes its draws from generators passed in: `rng` a
`random.Random` (JAX's `random.*` calls) and `np_rng` a
`np.random.RandomState` (its `np.random.*` calls), in JAX's order, so
generators seeded as JAX's globals give JAX's draws. Where JAX's code
allows it a draw is split from its use (`perspective_draws` then
`perspective_matrix`; `TrainTransform.prepare` then `render`), so that the
labels and the draws are made in order on one thread and the pixels on
any other.
"""

import math
import random
from typing import NamedTuple, Optional, Tuple

import numpy as np

from . import image


def xyxy2cxcywh(boxes: np.ndarray) -> np.ndarray:
    out = boxes.copy()
    out[:, 2] = boxes[:, 2] - boxes[:, 0]
    out[:, 3] = boxes[:, 3] - boxes[:, 1]
    out[:, 0] = boxes[:, 0] + out[:, 2] * 0.5
    out[:, 1] = boxes[:, 1] + out[:, 3] * 0.5
    return out


def hsv_gains(np_rng: np.random.RandomState, hgain: float = 5, sgain: float = 30,
              vgain: float = 30) -> np.ndarray:
    """augment_hsv's draw (data_augment.py:21): int16 (h, s, v) gains."""
    gains = np_rng.uniform(-1, 1, 3) * [hgain, sgain, vgain]
    gains *= np_rng.randint(0, 2, 3)
    return gains.astype(np.int16)


def augment_hsv(img: np.ndarray, np_rng: np.random.RandomState, hgain: float = 5,
                sgain: float = 30, vgain: float = 30) -> None:
    """In-place HSV jitter of a C-contiguous uint8 image with gains drawn
    from `np_rng`."""
    image.augment_hsv(img, hsv_gains(np_rng, hgain, sgain, vgain))


def mirror_boxes(boxes: np.ndarray, width: int) -> np.ndarray:
    boxes = boxes.copy()
    boxes[:, 0::2] = width - boxes[:, 2::-2]
    return boxes


def mirror(image_: np.ndarray, boxes: np.ndarray, prob: float = 0.5,
           rng: Optional[random.Random] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip with xyxy boxes, with probability `prob`
    (data_augment.py:240)."""
    if (rng or random).random() < prob:
        return np.ascontiguousarray(image_[:, ::-1]), mirror_boxes(boxes, image_.shape[1])
    return image_, boxes


def letterbox_ratio(shape: Tuple[int, int], input_size: Tuple[int, int]) -> float:
    return min(input_size[0] / shape[0], input_size[1] / shape[1])


def letterbox(img: np.ndarray, input_size: Tuple[int, int], dtype=np.float32
              ) -> Tuple[np.ndarray, float]:
    """Min-ratio INTER_LINEAR resize onto a 114-gray canvas, top-left
    anchored (data_augment.py:248): (HWC `dtype`, the ratio)."""
    padded = np.full((input_size[0], input_size[1], 3), 114, np.uint8)
    r = letterbox_ratio(img.shape, input_size)
    rw, rh = int(img.shape[1] * r), int(img.shape[0] * r)
    padded[:rh, :rw] = image.resize_linear(img, rh, rw)
    return np.ascontiguousarray(padded, dtype=dtype), r


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2,
                   ar_thr: float = 20, area_thr: float = 0.2) -> np.ndarray:
    """(4, N) pre- and post-augment xyxy boxes -> keep mask
    (data_augment.py:46)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + 1e-16) > area_thr) & (ar < ar_thr))


class PerspectiveDraws(NamedTuple):
    """random_perspective's uniform draws, in its order."""
    angle: float
    scale: float
    shear_x: float
    shear_y: float
    tx: float        # of [0.5 - translate, 0.5 + translate]
    ty: float


def perspective_draws(rng: random.Random, degrees: float = 10, translate: float = 0.1,
                      scale: Tuple[float, float] = (0.5, 1.5),
                      shear: float = 2.0) -> PerspectiveDraws:
    return PerspectiveDraws(rng.uniform(-degrees, degrees), rng.uniform(scale[0], scale[1]),
                            rng.uniform(-shear, shear), rng.uniform(-shear, shear),
                            rng.uniform(0.5 - translate, 0.5 + translate),
                            rng.uniform(0.5 - translate, 0.5 + translate))


def perspective_matrix(d: PerspectiveDraws, shape: Tuple[int, int],
                       border: Tuple[int, int] = (0, 0)):
    """The (3, 3) affine matrix of random_perspective (data_augment.py:61)
    for an image of `shape` (h, w), and the output size (height, width)."""
    height = shape[0] + border[0] * 2
    width = shape[1] + border[1] * 2
    C = np.eye(3)
    C[0, 2] = -shape[1] / 2
    C[1, 2] = -shape[0] / 2
    R = np.eye(3)
    R[:2] = image.rotation_matrix_2d((0, 0), d.angle, d.scale)
    S = np.eye(3)
    S[0, 1] = math.tan(d.shear_x * math.pi / 180)
    S[1, 0] = math.tan(d.shear_y * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = d.tx * width
    T[1, 2] = d.ty * height
    return T @ S @ R @ C, (height, width)


def perspective_labels(targets: np.ndarray, M: np.ndarray, s: float, height: int,
                       width: int) -> np.ndarray:
    """(N, 5) [x1, y1, x2, y2, cls] through M: the warped corners' box,
    clipped to the output, those box_candidates keeps."""
    n = len(targets)
    if not n:
        return targets
    xy = np.ones((n * 4, 3))
    xy[:, :2] = targets[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
    xy = (xy @ M.T)[:, :2].reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    xy = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
    xy[:, [0, 2]] = xy[:, [0, 2]].clip(0, width)
    xy[:, [1, 3]] = xy[:, [1, 3]].clip(0, height)
    keep = box_candidates(box1=targets[:, :4].T * s, box2=xy.T)
    targets = targets[keep]
    targets[:, :4] = xy[keep]
    return targets


def needs_warp(M: np.ndarray, border: Tuple[int, int]) -> bool:
    return (border[0] != 0) or (border[1] != 0) or bool((M != np.eye(3)).any())


def random_perspective(img: np.ndarray, targets: np.ndarray, degrees: float = 10,
                       translate: float = 0.1, scale: Tuple[float, float] = (0.5, 1.5),
                       shear: float = 2.0, border: Tuple[int, int] = (0, 0),
                       rng: Optional[random.Random] = None,
                       draws: Optional[PerspectiveDraws] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The affine warp after mosaic (data_augment.py:61): `draws` if given,
    else drawn from `rng`."""
    d = draws or perspective_draws(rng or random, degrees, translate, scale, shear)
    M, (height, width) = perspective_matrix(d, img.shape[:2], border)
    if needs_warp(M, border):
        img = image.warp_affine(img, M[:2], (width, height), 114)
    return img, perspective_labels(targets, M, d.scale, height, width)


class TrainDraws(NamedTuple):
    gains: Optional[np.ndarray]    # int16 HSV gains, None without the jitter
    flip: bool
    original: bool                 # no box survived: letterbox the input as it is


class TrainTransform:
    """Still-image train transform (data_augment.py:267): HSV jitter ->
    flip -> letterbox; (HWC float32, (max_labels, 5) [cls, cx, cy, w, h]).
    `prepare(shape, targets, input_dim, rng, np_rng)` makes the draws and
    the labels from the image's shape alone; `render(img, draws,
    input_dim)` the pixels."""

    def __init__(self, max_labels: int = 50, flip_prob: float = 0.5, hsv_prob: float = 1.0):
        self.max_labels = max_labels
        self.flip_prob = flip_prob
        self.hsv_prob = hsv_prob

    def prepare(self, shape: Tuple[int, int], targets: np.ndarray, input_dim,
                rng: random.Random, np_rng: np.random.RandomState):
        padded = np.zeros((self.max_labels, 5), np.float32)
        if len(targets) == 0:
            return None, padded
        boxes = targets[:, :4].copy()
        labels = targets[:, 4].copy()
        targets_o = targets.copy()
        boxes_o = xyxy2cxcywh(targets_o[:, :4])
        labels_o = targets_o[:, 4]
        gains = hsv_gains(np_rng) if rng.random() < self.hsv_prob else None
        flip = rng.random() < self.flip_prob
        if flip:
            boxes = mirror_boxes(boxes, shape[1])
        r = letterbox_ratio(shape, input_dim)
        boxes = xyxy2cxcywh(boxes) * r
        mask = np.minimum(boxes[:, 2], boxes[:, 3]) > 1
        boxes_t, labels_t = boxes[mask], labels[mask]
        original = len(boxes_t) == 0
        if original:
            boxes_t, labels_t = boxes_o * r, labels_o
        targets_t = np.hstack((labels_t[:, None], boxes_t))
        n = min(len(targets_t), self.max_labels)
        padded[:n] = targets_t[:n]
        return TrainDraws(gains, flip, original), padded

    def render(self, img: np.ndarray, draws: Optional[TrainDraws], input_dim) -> np.ndarray:
        if draws is None or draws.original:
            # JAX's fallback letterboxes the copy it made before the jitter
            return letterbox(img, input_dim)[0]
        if draws.gains is not None:
            img = np.array(img, np.uint8, order="C")
            image.augment_hsv(img, draws.gains)
        if draws.flip:
            img = np.ascontiguousarray(img[:, ::-1])
        return letterbox(img, input_dim)[0]

    def __call__(self, img: np.ndarray, targets: np.ndarray, input_dim,
                 rng: Optional[random.Random] = None,
                 np_rng: Optional[np.random.RandomState] = None):
        draws, labels = self.prepare(img.shape[:2], targets, input_dim, rng or random,
                                     np_rng or np.random.mtrand._rand)
        return self.render(img, draws, input_dim), labels


class ValTransform:
    """Letterbox only; (HWC float32, dummy labels)."""

    def __init__(self, legacy: bool = False):
        self.legacy = legacy

    def __call__(self, img, res, input_size):
        img, _ = letterbox(img, input_size)
        if self.legacy:
            img = img[:, :, ::-1].copy()
            img /= 255.0
            img -= np.array([0.485, 0.456, 0.406])
            img /= np.array([0.229, 0.224, 0.225])
        return img, np.zeros((1, 5), np.float32)


class VidValTransform:
    """Video eval transform: the image letterboxed and the gt boxes scaled
    by the same ratio (data_augment.py:351); (img, (N, 5) [cls, xyxy])."""

    def __init__(self, legacy: bool = False):
        self.legacy = legacy

    def __call__(self, img, res, input_size):
        img, r = letterbox(img, input_size)
        if self.legacy:
            img = img[:, :, ::-1].copy()
            img /= 255.0
            img -= np.array([0.485, 0.456, 0.406])
            img /= np.array([0.229, 0.224, 0.225])
        boxes = res[:, :4].copy() * r
        labels = res[:, 4:5].copy()
        return img, np.hstack((labels, boxes)).astype(np.float32)
