"""ImageNet VID windows (counterpart of tscd_tpu/data/vid.py): the class
map, XML annotations, sequence construction, the dataset, the window
collate and a background-thread window loader, for eval and for
stage-2 training (shuffled windows, cxcywh labels, the window's own
frame index as time, the HSV jitter and horizontal flip), and the
multiscale resize.

Frames are read, letterboxed and jittered by `data.image`, whose host C++
gives cv2's pixels bit for bit without OpenCV. OVIS and Argoverse-HD
video (`OVISVideoDataset`, `ArgoverseVideoDataset`) read per-frame COCO
json grouped into videos by `sid`.
"""

import os
import pickle
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple
from xml.dom import minidom

import numpy as np
import torch

from ..ops.position import get_timing_signal_1d
from . import image

# ILSVRC VID 30-class wnid -> index map (reference vid.py:28-33)
VID_NAME_LIST = [
    'n02691156', 'n02419796', 'n02131653', 'n02834778', 'n01503061',
    'n02924116', 'n02958343', 'n02402425', 'n02084071', 'n02121808',
    'n02503517', 'n02118333', 'n02510455', 'n02342885', 'n02374451',
    'n02129165', 'n01674464', 'n02484322', 'n03790512', 'n02324045',
    'n02509815', 'n02411705', 'n01726692', 'n02355227', 'n02129604',
    'n04468005', 'n01662784', 'n04530566', 'n02062744', 'n02391049']
VID_CLASSES = [
    'airplane', 'antelope', 'bear', 'bicycle', 'bird', 'bus', 'car',
    'cattle', 'dog', 'domestic_cat', 'elephant', 'fox', 'giant_panda',
    'hamster', 'horse', 'lion', 'lizard', 'monkey', 'motorcycle', 'rabbit',
    'red_panda', 'sheep', 'snake', 'squirrel', 'tiger', 'train', 'turtle',
    'watercraft', 'whale', 'zebra']
NAME_NUM = {n: i for i, n in enumerate(VID_NAME_LIST)}
_DECODE_WORKERS = 8      # frame-decode threads a loader (image.py drops the GIL)
_PREFETCH = 2            # windows a loader collates ahead


def parse_vid_xml(xml_path: str, img_size: Tuple[int, int]) -> np.ndarray:
    """One ILSVRC annotation xml -> (N, 5) [x1, y1, x2, y2, cls], scaled by
    the letterbox ratio for img_size (reference get_annotation,
    vid.py:238)."""
    root = minidom.parse(xml_path).documentElement
    width = int(root.getElementsByTagName("width")[0].firstChild.data)
    height = int(root.getElementsByTagName("height")[0].firstChild.data)
    rows = []
    for obj in root.getElementsByTagName("object"):
        name = obj.getElementsByTagName("name")[0].firstChild.data
        if name not in NAME_NUM:
            continue

        def get(tag):
            return int(obj.getElementsByTagName(tag)[0].firstChild.data)

        x1, y1 = max(0, get("xmin")), max(0, get("ymin"))
        x2, y2 = min(width, get("xmax")), min(height, get("ymax"))
        if x2 >= x1 and y2 >= y1:
            rows.append((x1, y1, x2, y2, NAME_NUM[name]))
    res = np.asarray(rows, np.float32).reshape(-1, 5)
    r = min(img_size[0] / height, img_size[1] / width)
    res[:, :4] *= r
    return res


def build_sequences(videos: List[List[str]], lframe: int, gframe: int,
                    mode: str = "random", training: bool = False,
                    local_stride: int = 1, traj_linking: bool = False,
                    formal: bool = False,
                    label_counts: Optional[Dict[str, int]] = None,
                    seq_cap_per_video: int = 15,
                    total_cap: int = 15000, val: bool = False,
                    tnum: int = -1,
                    rng: Optional[random.Random] = None) -> List[List[str]]:
    """Windows of frame paths (reference photo_to_sequence, vid.py:133):
    lframe consecutive local frames plus gframe global frames of the same
    video. Draws from `rng` (the `random` module when None) in the JAX
    package's order, so one seed gives the same windows."""
    rng = rng or random
    res: List[List[str]] = []
    for element in videos:
        element = list(element)
        ele_len = len(element)
        if ele_len < lframe + gframe:
            if formal:
                if lframe == 0:
                    res.append(element)
                else:
                    split_num = ele_len // max(lframe, 1)
                    all_local = element[:split_num * lframe]
                    for i in np.arange(split_num) * lframe:
                        lf = all_local[i:i + lframe]
                        gf = rng.choices(element[:i] + element[i + lframe:],
                                         k=gframe)
                        res.append(lf + gf)
            continue
        if mode == "random":
            if lframe == 0:
                split_num = ele_len // gframe
                rng.shuffle(element)
                for i in range(split_num):
                    res.append(element[i * gframe:(i + 1) * gframe])
                if formal and element[split_num * gframe:]:
                    res.append(element[split_num * gframe:])
            elif local_stride == 1:
                split_num = ele_len // lframe
                all_local = element[:split_num * lframe]
                if training and split_num > seq_cap_per_video:
                    interval = len(all_local) // seq_cap_per_video
                    choice = np.arange(seq_cap_per_video) * interval
                else:
                    choice = np.arange(split_num) * lframe
                for i in choice:
                    if traj_linking and i != 0:
                        lf = all_local[i - 1:i + lframe]
                    else:
                        lf = all_local[i:i + lframe]
                        if training and label_counts is not None:
                            if sum(label_counts.get(p, 0) for p in lf) == 0:
                                continue
                    gf = rng.sample(element[:i] + element[i + lframe:], gframe)
                    res.append(list(lf) + gf)
                if formal and element[split_num * lframe:]:
                    res.append(element[split_num * lframe - 1:] if traj_linking
                               else element[split_num * lframe:])
            else:
                span = lframe * local_stride
                for i in range(ele_len // span):
                    for j in range(local_stride):
                        res.append(element[span * i:span * (i + 1)][j::local_stride])
        elif mode == "uniform":
            split_num = ele_len // gframe
            all_uniform = element[:split_num * gframe]
            for i in range(split_num):
                res.append(all_uniform[i::split_num])
        elif mode == "gl":
            split_num = ele_len // lframe
            all_local = element[:split_num * lframe]
            for i in range(split_num):
                gf = rng.sample(element[:i * lframe] + element[(i + 1) * lframe:],
                                gframe)
                res.append(all_local[i * lframe:(i + 1) * lframe] + gf)
        else:
            raise ValueError(f"unsupported mode {mode}")
    if val:
        return res if tnum == -1 else res[:tnum]
    rng.shuffle(res)
    return res[:total_cap]


def frame_index(path: str) -> int:
    """The frame number in a file name's last `_` field (0 if none)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    digits = "".join(c for c in stem.split("_")[-1] if c.isdigit())
    return int(digits) if digits else 0


class VIDDataset:
    """ImageNet VID sequence dataset (reference VIDDataset, vid.py:48).
    `file_path` is the train_seq.npy or val_seq.npy list of videos; XML
    annotations load up front (into the pickle `cache_file` if given).
    `training` caps the windows a video and skips windows without labels
    (photo_to_sequence)."""

    def __init__(self, file_path: str, img_size=(576, 576), lframe=1,
                 gframe=31, val=True, mode="random", dataset_pth="",
                 tnum=-1, formal=False, traj_linking=False, local_stride=1,
                 cache_file="", training=False):
        self.img_size = tuple(img_size)
        self.dataset_pth = dataset_pth
        self.val = val
        self.videos = np.load(file_path, allow_pickle=True).tolist()
        self.annotations = self._preload_annotations(cache_file)
        label_counts = {k: len(v) for k, v in self.annotations.items()}
        self.res = build_sequences(
            self.videos, lframe, gframe, mode=mode, training=training,
            local_stride=local_stride, traj_linking=traj_linking, formal=formal,
            label_counts=label_counts, val=val, tnum=tnum)
        self.lframe, self.gframe = lframe, gframe

    def _preload_annotations(self, cache_file: str):
        if cache_file and os.path.exists(cache_file):
            with open(cache_file, "rb") as f:
                return pickle.load(f)
        annotations = {}
        for video in self.videos:
            for rel in video:
                xml = os.path.join(self.dataset_pth, rel).replace(
                    "Data", "Annotations").replace("JPEG", "xml")
                annotations[rel] = parse_vid_xml(xml, self.img_size)
        if cache_file:
            os.makedirs(os.path.dirname(cache_file) or ".", exist_ok=True)
            with open(cache_file, "wb") as f:
                pickle.dump(annotations, f)
        return annotations

    def __len__(self):
        return len(self.res)

    def load_frame(self, rel_path: str):
        """-> (resized HWC uint8 BGR image, (N, 5) [x1, y1, x2, y2, cls]
        scaled, (h, w) of the source): cv2.imread and cv2.resize's pixels.
        Thread-safe: collate calls it from a pool."""
        img = image.imread(os.path.join(self.dataset_pth, rel_path))
        h, w = img.shape[:2]
        r = min(self.img_size[0] / h, self.img_size[1] / w)
        img = image.resize_linear(img, int(h * r), int(w * r))
        return img, self.annotations[rel_path].copy(), (h, w)

    def frame_index(self, rel_path: str) -> int:
        return frame_index(rel_path)


class OVISVideoDataset:
    """OVIS per-frame COCO-json video dataset (counterpart of JAX's
    OVISVideoDataset, tscd_tpu/data/vid.py:259; reference OVIS, vid.py:560):
    the json's images grouped into videos by their `sid` (0 where absent),
    each video's file names sorted, a video shorter than lframe + gframe
    padded by repeating its last frame, and windows built as JAX builds
    them (`build_sequences`, uncapped). Labels are each frame's boxes
    clipped to the image and kept where their area is positive, scaled by
    the letterbox ratio for img_size. Frames load from
    data_dir/name/file_name. Every annotation is read up front, so
    `load_frame` is thread-safe."""

    def __init__(self, json_path: str, data_dir: str, name: str = "",
                 img_size=(576, 576), lframe=4, gframe=12, val=False,
                 mode="random", training=False):
        from ..eval.coco_api import COCO
        from .coco import load_coco_labels
        self.img_size = tuple(img_size)
        self.data_dir = data_dir
        self.name = name
        self.val = val
        self.training = training
        self.coco = COCO(json_path)
        raw = self.coco.dataset
        self.class_ids = sorted(self.coco.getCatIds())
        videos: List[List[str]] = [[] for _ in range(max(len(raw.get("videos", [])), 1))]
        self.name_id = {}
        for im in raw["images"]:
            videos[im.get("sid", 0)].append(im["file_name"])
            self.name_id[im["file_name"]] = im["id"]
        for v in videos:
            v.sort()
            while 0 < len(v) < lframe + gframe:
                v.append(v[-1])
        self.annotations = {}
        for im in raw["images"]:
            res, (h, w), file_name = load_coco_labels(self.coco, im["id"], self.class_ids)
            res[:, :4] *= min(self.img_size[0] / h, self.img_size[1] / w)
            self.annotations[im["id"]] = res, (h, w), file_name
        label_counts = {fn: len(self.annotations[i][0]) for fn, i in self.name_id.items()}
        self.res = build_sequences([v for v in videos if v], lframe, gframe, mode=mode,
                                   training=training, label_counts=label_counts, val=val,
                                   total_cap=10 ** 9)
        self.lframe, self.gframe = lframe, gframe

    def __len__(self):
        return len(self.res)

    def load_frame(self, file_name: str):
        """-> (resized HWC uint8 BGR image, scaled (N, 5) labels, (h, w) of
        the source), as VIDDataset.load_frame."""
        annos, img_info, img_path = self.annotations[self.name_id[file_name]]
        img = image.imread(os.path.join(self.data_dir, self.name, img_path))
        h, w = img.shape[:2]
        r = min(self.img_size[0] / h, self.img_size[1] / w)
        return image.resize_linear(img, int(h * r), int(w * r)), annos.copy(), img_info

    def frame_index(self, file_name: str) -> int:
        return frame_index(file_name)


class ArgoverseVideoDataset(OVISVideoDataset):
    """Argoverse-HD video (reference Arg_VID, vid.py:345): OVIS's container,
    per-frame COCO json grouped by `sid`, with 8 classes."""

    ARGOVERSE_CLASSES = ("person", "bicycle", "car", "motorcycle", "bus",
                         "truck", "traffic_light", "stop_sign")


def multiscale_resize(imgs: np.ndarray, labels: np.ndarray,
                      target_hw: Tuple[int, int]):
    """A (F, H, W, 3) uint8 window resized to target_hw, frame by frame, and
    its [cls, x, y, ...] labels scaled (tscd_tpu/data/vid.py:239-254). JAX's
    trainer resizes its float32 window, so the frames come out float32 with
    cv2's float INTER_LINEAR values (`image.resize_linear_float`); at the
    window's own size they stay as they are."""
    F, H, W = imgs.shape[:3]
    th, tw = target_hw
    if (th, tw) == (H, W):
        return imgs, labels
    out = np.stack([image.resize_linear_float(imgs[f], th, tw) for f in range(F)])
    lab = labels.copy()
    lab[..., 1:5] *= np.array([tw / W, th / H, tw / W, th / H], np.float32)
    return out, lab


def collate_window(dataset, paths: Sequence[str], pool: ThreadPoolExecutor,
                   max_labels: int = 120, img_dtype=np.uint8, *,
                   train_time_index: bool = False, cxcywh: bool = False,
                   augment: bool = False, hsv_prob: float = 1.0,
                   flip_prob: float = 0.5,
                   rng: Optional[np.random.Generator] = None):
    """Loads one (lframe + gframe) window -> numpy batch dict (reference
    collate_fn / collate_fn_train, vid.py:817,838): imgs (F, H, W, 3)
    letterboxed (114 pad), labels (F, max_labels, 5) [cls, x1, y1, x2, y2]
    (or [cls, cx, cy, w, h] with `cxcywh`), time_embedding (F, 256) from
    the frame numbers (from 0..F-1 with `train_time_index`), infos
    [(h, w)], paths. Frames load through `pool`, so `dataset.load_frame`
    must be thread-safe.

    `augment` jitters the whole window in HSV (probability `hsv_prob`)
    and flips it horizontally (probability `flip_prob`), every frame
    alike, with JAX's draws in JAX's order from `rng`: the HSV coin, the
    flip coin, then the int16 gains uniform(-1, 1, 3) x [5, 30, 30] x
    randint(0, 2, 3)."""
    H, W = dataset.img_size
    F = len(paths)
    imgs = np.full((F, H, W, 3), 114, img_dtype)
    labels = np.zeros((F, max_labels, 5), np.float32)
    rng = rng or np.random.default_rng()
    do_hsv = augment and rng.random() < hsv_prob
    do_flip = augment and rng.random() < flip_prob
    gains = ((rng.uniform(-1, 1, 3) * [5, 30, 30] * rng.integers(0, 2, 3)).astype(np.int16)
             if do_hsv else None)

    def load(path):               # in the pool: image.py drops the GIL
        img, annos, info = dataset.load_frame(path)
        if do_hsv:
            img = np.array(img, np.uint8, order="C")
            image.augment_hsv(img, gains)
        return img, annos, info

    loaded = list(pool.map(load, paths))
    infos, idxs = [], []
    for i, (p, (img, annos, info)) in enumerate(zip(paths, loaded)):
        if do_flip:
            w_img = img.shape[1]
            img = np.ascontiguousarray(img[:, ::-1])
            if len(annos):
                annos = annos.copy()
                x1 = annos[:, 0].copy()
                annos[:, 0] = w_img - annos[:, 2]
                annos[:, 2] = w_img - x1
        imgs[i, :img.shape[0], :img.shape[1]] = img
        n = min(len(annos), max_labels)
        if n:
            lab = np.concatenate([annos[:n, 4:5], annos[:n, :4]], 1)
            if cxcywh:
                xy = lab[:, 1:].copy()
                lab[:, 1] = (xy[:, 0] + xy[:, 2]) / 2
                lab[:, 2] = (xy[:, 1] + xy[:, 3]) / 2
                lab[:, 3] = xy[:, 2] - xy[:, 0]
                lab[:, 4] = xy[:, 3] - xy[:, 1]
            labels[i, :n] = lab
        infos.append(info)
        idxs.append(i if train_time_index else dataset.frame_index(p))
    te = get_timing_signal_1d(np.asarray(idxs, np.float32), 256)
    return {"imgs": imgs, "labels": labels, "time_embedding": te,
            "infos": infos, "paths": list(paths)}


class WindowLoader:
    """Iterates the dataset's windows, collated by a background thread a
    few windows ahead (reference DataPrefetcher, vid.py:963), frames
    decoded by a pool of threads. In order by default; the train loader
    (`exp.get_data_loader`) shuffles them each pass and draws the flips
    from the generator `rng`.

    With `pin_memory` (a CUDA device) the worker turns `imgs` and
    `time_embedding` into pinned CPU tensors, so the step uploads them
    with non_blocking copies that do not wait on the card.
    An error in the worker is raised in the consumer.

    `batch_windows` B > 1 stacks B collated windows on a new leading axis
    (imgs (B, F, H, W, 3), labels, time_embedding; infos and paths as
    lists of B), as JAX's loader does (vid.py:436-470); the last partial
    group is dropped, so a pass has len(res) // B batches, and a B above
    the dataset's window count raises."""

    def __init__(self, dataset, img_dtype=np.uint8, pin_memory: bool = False,
                 shuffle: bool = False, train_time_index: bool = False,
                 cxcywh: bool = False, augment: bool = False,
                 hsv_prob: float = 1.0, flip_prob: float = 0.5,
                 rng: Optional[np.random.Generator] = None,
                 batch_windows: int = 1):
        self.dataset = dataset
        self.img_dtype = img_dtype
        self.pin_memory = pin_memory
        self.shuffle = shuffle
        self.rng = rng if rng is not None else np.random.default_rng()
        self.batch_windows = max(int(batch_windows), 1)
        if self.batch_windows > len(dataset.res):
            raise ValueError(
                f"batch_windows({self.batch_windows}) exceeds the dataset's "
                f"{len(dataset.res)} windows: every step takes batch_windows "
                "full windows (shrink window_batch or enlarge the dataset)")
        self.collate_kw = dict(img_dtype=img_dtype,
                               train_time_index=train_time_index,
                               cxcywh=cxcywh, augment=augment,
                               hsv_prob=hsv_prob, flip_prob=flip_prob,
                               rng=self.rng)

    def __len__(self):
        return len(self.dataset.res) // self.batch_windows

    def _collate(self, group, pool):
        ws = [collate_window(self.dataset, paths, pool, **self.collate_kw)
              for paths in group]
        if len(ws) == 1:
            batch = ws[0]
        else:
            batch = {k: np.stack([w[k] for w in ws])
                     for k in ("imgs", "labels", "time_embedding")}
            batch.update({k: [w[k] for w in ws] for k in ("infos", "paths")})
        if self.pin_memory:
            for k in ("imgs", "time_embedding"):
                batch[k] = torch.from_numpy(batch[k]).pin_memory()
        return batch

    def __iter__(self):
        windows = list(self.dataset.res)
        if self.shuffle:
            windows = [windows[i] for i in self.rng.permutation(len(windows))]
        B = self.batch_windows
        groups = [windows[i:i + B] for i in range(0, len(windows) - B + 1, B)]
        q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()
        end = object()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                with ThreadPoolExecutor(_DECODE_WORKERS,
                                        thread_name_prefix="vid-decode") as pool:
                    for group in groups:
                        if stop.is_set():
                            return
                        put(self._collate(group, pool))
                put(end)
            except Exception as e:         # handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=worker, name="vid-window-loader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=30)
