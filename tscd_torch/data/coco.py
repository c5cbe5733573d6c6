"""Still-image COCO-format dataset, mosaic and mixup, and the batch loader
(counterpart of tscd_tpu/data/coco.py; reference yolox/data/datasets/
coco.py, mosaicdetection.py:39 and the still-image DataLoader and
InfiniteSampler, dataloading.py:32, samplers.py:30).

Each sample is made in two parts (`MosaicDetection.prepare`): its draws
and labels, from the annotations alone, in JAX's order from the loader's
generators; then its pixels (`render`), which read, resize, warp, blend,
jitter and letterbox through `data.image`'s host C++ (no GIL), so that the
loader renders a batch's images on a pool of threads while the draws stay
in JAX's sequence.
"""

import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..eval.coco_api import COCO
from . import image
from .transforms import (TrainTransform, perspective_draws, perspective_labels,
                         perspective_matrix)

_RENDER_WORKERS = 8      # threads that render a batch's images
_PREFETCH = 2            # batches a loader makes ahead


def load_coco_labels(coco: COCO, id_: int, class_ids: List[int]):
    """Image `id_`'s labels (reference coco.py:load_anno_from_ids): its
    boxes clipped to the image and kept where their area is positive, as
    (N, 5) float32 [x1, y1, x2, y2, index of the class in `class_ids`];
    with (h, w) and the file name."""
    im = coco.loadImgs(id_)[0]
    width, height = im["width"], im["height"]
    rows = []
    for obj in coco.loadAnns(coco.getAnnIds(imgIds=[id_], iscrowd=0)):
        x1 = max(0, obj["bbox"][0])
        y1 = max(0, obj["bbox"][1])
        x2 = min(width, x1 + max(0, obj["bbox"][2]))
        y2 = min(height, y1 + max(0, obj["bbox"][3]))
        if obj.get("area", 0) > 0 and x2 >= x1 and y2 >= y1:
            rows.append([x1, y1, x2, y2, class_ids.index(obj["category_id"])])
    res = np.asarray(rows, np.float32).reshape(-1, 5)
    return res, (height, width), im.get("file_name", f"{id_:012d}.jpg")


class COCODataset:
    """COCO-json detection dataset (reference coco.py). `pull_item(i)` ->
    (img HWC uint8 BGR, (N, 5) [x1, y1, x2, y2, cls] at the image's own
    resolution, (h, w), image id); `annotation(i)` the labels and (h, w)
    without reading the image. Images load from data_dir/name/file_name;
    every method is thread-safe."""

    def __init__(self, json_file: str, data_dir: str = "", name: str = "train2017",
                 img_size=(640, 640)):
        self.data_dir = data_dir
        self.name = name
        self.img_size = tuple(img_size)
        self.coco = COCO(json_file)
        self.ids = sorted(self.coco.getImgIds())
        self.class_ids = sorted(self.coco.getCatIds())
        self.classes = [c["name"] for c in self.coco.loadCats(self.class_ids)]
        self.annotations = [load_coco_labels(self.coco, i, self.class_ids) for i in self.ids]

    def __len__(self):
        return len(self.ids)

    def annotation(self, index: int) -> Tuple[np.ndarray, Tuple[int, int]]:
        res, hw, _ = self.annotations[index]
        return res.copy(), hw

    def load_image(self, index: int) -> np.ndarray:
        """The image, which must have the size its annotation states."""
        _, hw, file_name = self.annotations[index]
        img = image.imread(os.path.join(self.data_dir, self.name, file_name))
        if img.shape[:2] != tuple(hw):
            raise ValueError(f"{file_name}: {img.shape[:2]} pixels, the annotation says {hw}")
        return img

    def pull_item(self, index: int):
        res, hw, _ = self.annotations[index]
        return self.load_image(index), res.copy(), hw, self.ids[index]


def get_mosaic_coordinate(mosaic_index, xc, yc, w, h, input_h, input_w):
    """Tile placement of the 2 x 2 mosaic (mosaicdetection.py:14)."""
    if mosaic_index == 0:
        x1, y1, x2, y2 = max(xc - w, 0), max(yc - h, 0), xc, yc
        s_x1, s_y1, s_x2, s_y2 = w - (x2 - x1), h - (y2 - y1), w, h
    elif mosaic_index == 1:
        x1, y1, x2, y2 = xc, max(yc - h, 0), min(xc + w, input_w * 2), yc
        s_x1, s_y1, s_x2, s_y2 = 0, h - (y2 - y1), min(w, x2 - x1), h
    elif mosaic_index == 2:
        x1, y1, x2, y2 = max(xc - w, 0), yc, xc, min(input_h * 2, yc + h)
        s_x1, s_y1, s_x2, s_y2 = w - (x2 - x1), 0, w, min(y2 - y1, h)
    else:
        x1, y1, x2, y2 = xc, yc, min(xc + w, input_w * 2), min(input_h * 2, yc + h)
        s_x1, s_y1, s_x2, s_y2 = 0, 0, min(w, x2 - x1), min(y2 - y1, h)
    return (x1, y1, x2, y2), (s_x1, s_y1, s_x2, s_y2)


def _fit(img: np.ndarray, scale: float) -> np.ndarray:
    h0, w0 = img.shape[:2]
    return image.resize_linear(img, int(h0 * scale), int(w0 * scale))


class MosaicDetection:
    """Mosaic, random perspective and mixup (reference MosaicDetection,
    mosaicdetection.py:39).

    `prepare(idx, rng, np_rng)` draws in JAX's order (`rng` for JAX's
    `random.*`, `np_rng` for `np.random.*`) and returns (render, labels):
    the (max_labels, 5) [cls, cx, cy, w, h] labels and a function of no
    arguments that makes the HWC image (`dtype`, float32 as JAX's by
    default)."""

    def __init__(self, dataset, img_size, mosaic=True, preproc=None, degrees=10.0,
                 translate=0.1, mosaic_scale=(0.1, 2), mixup_scale=(0.5, 1.5), shear=2.0,
                 enable_mixup=True, mosaic_prob=1.0, mixup_prob=1.0):
        self._dataset = dataset
        self.preproc = preproc or TrainTransform(max_labels=120)
        self.degrees = degrees
        self.translate = translate
        self.scale = mosaic_scale
        self.shear = shear
        self.mixup_scale = mixup_scale
        self.enable_mosaic = mosaic
        self.enable_mixup = enable_mixup
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.img_size = tuple(img_size)

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, idx: int, rng: Optional[random.Random] = None,
                    np_rng: Optional[np.random.RandomState] = None):
        render, labels = self.prepare(idx, rng or random, np_rng or np.random.mtrand._rand)
        return render(), labels

    def prepare(self, idx: int, rng: random.Random, np_rng: np.random.RandomState,
                dtype=np.float32) -> Tuple[Callable[[], np.ndarray], np.ndarray]:
        input_h, input_w = self.img_size
        ds = self._dataset
        if not (self.enable_mosaic and rng.random() < self.mosaic_prob):
            targets, hw = ds.annotation(idx)
            draws, labels = self.preproc.prepare(hw, targets, self.img_size, rng, np_rng)
            return (lambda: self.preproc.render(ds.load_image(idx), draws, self.img_size)
                    .astype(dtype, copy=False)), labels

        yc = int(rng.uniform(0.5 * input_h, 1.5 * input_h))
        xc = int(rng.uniform(0.5 * input_w, 1.5 * input_w))
        tiles, mosaic_labels = [], []
        others = [rng.randint(0, len(ds) - 1) for _ in range(3)]
        for i_m, index in enumerate([idx] + others):
            _labels, (h0, w0) = ds.annotation(index)
            scale = min(1. * input_h / h0, 1. * input_w / w0)
            h, w = int(h0 * scale), int(w0 * scale)
            (l_x1, l_y1, l_x2, l_y2), (s_x1, s_y1, s_x2, s_y2) = get_mosaic_coordinate(
                i_m, xc, yc, w, h, input_h, input_w)
            tiles.append((index, scale, (l_y1, l_y2, l_x1, l_x2), (s_y1, s_y2, s_x1, s_x2)))
            padw, padh = l_x1 - s_x1, l_y1 - s_y1
            labels = _labels.copy()
            if _labels.size > 0:
                labels[:, 0] = scale * _labels[:, 0] + padw
                labels[:, 1] = scale * _labels[:, 1] + padh
                labels[:, 2] = scale * _labels[:, 2] + padw
                labels[:, 3] = scale * _labels[:, 3] + padh
            mosaic_labels.append(labels)
        mosaic_labels = np.concatenate(mosaic_labels, 0)
        np.clip(mosaic_labels[:, 0], 0, 2 * input_w, out=mosaic_labels[:, 0])
        np.clip(mosaic_labels[:, 1], 0, 2 * input_h, out=mosaic_labels[:, 1])
        np.clip(mosaic_labels[:, 2], 0, 2 * input_w, out=mosaic_labels[:, 2])
        np.clip(mosaic_labels[:, 3], 0, 2 * input_h, out=mosaic_labels[:, 3])
        border = (-input_h // 2, -input_w // 2)
        d = perspective_draws(rng, self.degrees, self.translate, self.scale, self.shear)
        M, (height, width) = perspective_matrix(d, (2 * input_h, 2 * input_w), border)
        mosaic_labels = perspective_labels(mosaic_labels, M, d.scale, height, width)
        mix = None
        if self.enable_mixup and len(mosaic_labels) and rng.random() < self.mixup_prob:
            mix, mosaic_labels = self._prepare_mixup(mosaic_labels, (height, width), rng)
        draws, labels = self.preproc.prepare((height, width), mosaic_labels, self.img_size,
                                             rng, np_rng)

        def render():
            mosaic_img = np.full((input_h * 2, input_w * 2, 3), 114, np.uint8)
            for index, scale, (ly1, ly2, lx1, lx2), (sy1, sy2, sx1, sx2) in tiles:
                mosaic_img[ly1:ly2, lx1:lx2] = _fit(ds.load_image(index), scale)[sy1:sy2, sx1:sx2]
            img = image.warp_affine(mosaic_img, M[:2], (width, height), 114)
            if mix is not None:
                img = mix(img)
            return self.preproc.render(img, draws, self.img_size).astype(dtype, copy=False)
        return render, labels

    def _prepare_mixup(self, origin_labels, target_hw, rng):
        """mixup's draws and labels (mosaicdetection.py:167); returns the
        function that blends the image in, and the labels."""
        input_dim = self.img_size
        ds = self._dataset
        jit_factor = rng.uniform(*self.mixup_scale)
        flip = rng.random() > 0.5
        cp_index = rng.randint(0, len(ds) - 1)
        cp_labels, (h0, w0) = ds.annotation(cp_index)
        while len(cp_labels) == 0:
            cp_index = rng.randint(0, len(ds) - 1)
            cp_labels, (h0, w0) = ds.annotation(cp_index)
        cp_scale_ratio = min(input_dim[0] / h0, input_dim[1] / w0)
        jit_h, jit_w = int(input_dim[0] * jit_factor), int(input_dim[1] * jit_factor)
        cp_scale_ratio *= jit_factor
        origin_h, origin_w = jit_h, jit_w
        target_h, target_w = target_hw
        pad_h, pad_w = max(origin_h, target_h), max(origin_w, target_w)
        x_offset, y_offset = 0, 0
        if pad_h > target_h:
            y_offset = rng.randint(0, pad_h - target_h - 1)
        if pad_w > target_w:
            x_offset = rng.randint(0, pad_w - target_w - 1)

        cp_bboxes_origin_np = cp_labels[:, :4].copy() * cp_scale_ratio
        cp_bboxes_origin_np[:, 0::2] = np.clip(cp_bboxes_origin_np[:, 0::2], 0, origin_w)
        cp_bboxes_origin_np[:, 1::2] = np.clip(cp_bboxes_origin_np[:, 1::2], 0, origin_h)
        if flip:
            cp_bboxes_origin_np[:, 0::2] = origin_w - cp_bboxes_origin_np[:, 0::2][:, ::-1]
        cp_bboxes_transformed_np = cp_bboxes_origin_np.copy()
        cp_bboxes_transformed_np[:, 0::2] = np.clip(
            cp_bboxes_transformed_np[:, 0::2] - x_offset, 0, target_w)
        cp_bboxes_transformed_np[:, 1::2] = np.clip(
            cp_bboxes_transformed_np[:, 1::2] - y_offset, 0, target_h)
        labels = np.hstack((cp_bboxes_transformed_np, cp_labels[:, 4:5].copy()))
        origin_labels = np.vstack((origin_labels, labels))

        def blend(origin_img):
            cp_img = np.full((input_dim[0], input_dim[1], 3), 114, np.uint8)
            ratio = min(input_dim[0] / h0, input_dim[1] / w0)
            resized = _fit(ds.load_image(cp_index), ratio)
            cp_img[:resized.shape[0], :resized.shape[1]] = resized
            cp_img = image.resize_linear(cp_img, jit_h, jit_w)
            if flip:
                cp_img = cp_img[:, ::-1, :]
            padded_img = np.zeros((pad_h, pad_w, 3), np.uint8)
            padded_img[:origin_h, :origin_w] = cp_img
            cropped = padded_img[y_offset:y_offset + target_h, x_offset:x_offset + target_w]
            out = 0.5 * origin_img.astype(np.float32) + 0.5 * cropped.astype(np.float32)
            return np.ascontiguousarray(out.astype(np.uint8))
        return blend, origin_labels


class BatchLoader:
    """Infinite shuffled batches with a background thread (the reference's
    DataLoader, InfiniteSampler and YoloBatchSampler): yields {"imgs" (B, H,
    W, 3) `img_dtype`, "labels" (B, M, 5) float32} forever;
    `steps_per_epoch` = len(dataset) // B. The order is shuffled each pass
    by random.Random(seed), as JAX's; a sample's draws come from `rng` and
    `np_rng` in turn, and its pixels are rendered on a pool of threads.
    An error in the worker is raised in the consumer; closing the
    iterator stops the worker."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 rng: Optional[random.Random] = None,
                 np_rng: Optional[np.random.RandomState] = None,
                 img_dtype=np.float32):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rng = rng or random.Random()
        self.np_rng = np_rng or np.random.RandomState()
        self.img_dtype = img_dtype

    @property
    def steps_per_epoch(self) -> int:
        return max(len(self.dataset) // self.batch_size, 1)

    def _batch(self, idxs: List[int], pool) -> dict:
        jobs = [self.dataset.prepare(j, self.rng, self.np_rng, self.img_dtype) for j in idxs]
        imgs = list(pool.map(lambda job: job[0](), jobs))
        return {"imgs": np.stack(imgs), "labels": np.stack([j[1] for j in jobs]).astype(np.float32)}

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()
        order_rng = random.Random(self.seed)

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                order = list(range(len(self.dataset)))
                with ThreadPoolExecutor(_RENDER_WORKERS, thread_name_prefix="coco-render") as pool:
                    while not stop.is_set():
                        if self.shuffle:
                            order_rng.shuffle(order)
                        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                            if stop.is_set():
                                return
                            put(self._batch(order[i:i + self.batch_size], pool))
            except Exception as e:        # handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=worker, name="coco-batch-loader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=30)
