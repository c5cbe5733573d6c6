"""Pascal VOC dataset + VOC-protocol mAP, and the still-image Argoverse-HD
dataset: the port's copy of tscd_tpu/data/voc.py (reference:
yolox/data/datasets/voc.py and yolox/evaluators/voc_eval.py). Host-side
numpy; images are read by the port's `imread` (JPEG), COCO jsons by the
port's `eval/coco_api.py`."""

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple
from xml.etree import ElementTree as ET

import numpy as np

from .image import imread

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor")


def parse_rec(filename: str) -> List[dict]:
    """Parse one VOC xml (voc_eval.py parse_rec)."""
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall("object"):
        bbox = obj.find("bndbox")
        objects.append({
            "name": obj.find("name").text,
            "difficult": int((obj.find("difficult").text
                              if obj.find("difficult") is not None
                              else 0)),
            "bbox": [int(bbox.find("xmin").text),
                     int(bbox.find("ymin").text),
                     int(bbox.find("xmax").text),
                     int(bbox.find("ymax").text)],
        })
    return objects


class VOCDetection:
    """VOCdevkit detection dataset: pull_item -> (img BGR, (N,5)
    [x1,y1,x2,y2,cls], (h,w), image_id)."""

    def __init__(self, data_dir: str,
                 image_sets: Sequence[Tuple[str, str]] = (("2007",
                                                           "trainval"),),
                 img_size=(640, 640)):
        self.root = data_dir
        self.img_size = tuple(img_size)
        self.ids: List[Tuple[str, str]] = []
        for year, name in image_sets:
            rootpath = os.path.join(self.root, f"VOC{year}")
            listfile = os.path.join(rootpath, "ImageSets", "Main",
                                    name + ".txt")
            with open(listfile) as f:
                for line in f:
                    self.ids.append((rootpath, line.strip()))
        self.class_to_ind = {c: i for i, c in enumerate(VOC_CLASSES)}
        self.classes = list(VOC_CLASSES)
        self.class_ids = list(range(len(VOC_CLASSES)))

    def __len__(self):
        return len(self.ids)

    def load_anno(self, index: int,
                  keep_difficult: bool = False) -> np.ndarray:
        """(N, 5) [x1,y1,x2,y2,cls] (training default drops difficult),
        or (N, 6) with a trailing difficult flag when keep_difficult —
        the VOC protocol needs difficult GTs present so matches to them
        are IGNORED rather than counted as false positives."""
        rootpath, img_id = self.ids[index]
        objs = parse_rec(os.path.join(rootpath, "Annotations",
                                      img_id + ".xml"))
        if keep_difficult:
            rows = [[*o["bbox"], self.class_to_ind[o["name"]],
                     o["difficult"]] for o in objs]
            return np.asarray(rows, np.float32).reshape(-1, 6)
        rows = [[*o["bbox"], self.class_to_ind[o["name"]]]
                for o in objs if not o["difficult"]]
        return np.asarray(rows, np.float32).reshape(-1, 5)

    def pull_item(self, index: int):
        rootpath, img_id = self.ids[index]
        img = imread(os.path.join(rootpath, "JPEGImages", img_id + ".jpg"))
        res = self.load_anno(index)
        return img, res, img.shape[:2], img_id


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """(voc_eval.py voc_ap): 11-point or all-points AP."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def voc_eval(dets_per_image: Dict[str, np.ndarray],
             gts_per_image: Dict[str, np.ndarray],
             num_classes: int = 20, ovthresh: float = 0.5,
             use_07_metric: bool = False) -> Dict[str, float]:
    """VOC-protocol per-class AP + mAP.

    dets_per_image: image_id -> (K, 7) rows; gts: image_id -> (N, 5)
    [x1,y1,x2,y2,cls] or (N, 6) with a trailing difficult flag —
    difficult GTs are excluded from npos and matches to them are
    ignored (neither TP nor FP, reference voc_eval.py:167)."""
    aps = {}
    for c in range(num_classes):
        class_recs = {}
        npos = 0
        for img_id, g in gts_per_image.items():
            g = np.asarray(g, np.float32)
            rows = g[g[:, 4] == c] if len(g) else np.zeros((0, 6))
            sel = rows[:, :4]
            difficult = (rows[:, 5].astype(bool) if rows.shape[1] > 5
                         else np.zeros(len(rows), bool))
            class_recs[img_id] = {"bbox": sel, "difficult": difficult,
                                  "det": np.zeros(len(sel), bool)}
            npos += int((~difficult).sum())
        rows = []
        for img_id, d in dets_per_image.items():
            if len(d) == 0:
                continue
            for r in d[d[:, 6] == c]:
                rows.append((img_id, r[4] * r[5], r[:4]))
        if npos == 0:
            continue
        if not rows:
            aps[c] = 0.0
            continue
        rows.sort(key=lambda t: -t[1])
        tp = np.zeros(len(rows))
        fp = np.zeros(len(rows))
        for i, (img_id, score, bb) in enumerate(rows):
            R = class_recs[img_id]
            BBGT = R["bbox"]
            ovmax, jmax = -np.inf, -1
            if len(BBGT):
                ixmin = np.maximum(BBGT[:, 0], bb[0])
                iymin = np.maximum(BBGT[:, 1], bb[1])
                ixmax = np.minimum(BBGT[:, 2], bb[2])
                iymax = np.minimum(BBGT[:, 3], bb[3])
                iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
                ih = np.maximum(iymax - iymin + 1.0, 0.0)
                inters = iw * ih
                uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                       + (BBGT[:, 2] - BBGT[:, 0] + 1.0)
                       * (BBGT[:, 3] - BBGT[:, 1] + 1.0) - inters)
                overlaps = inters / uni
                jmax = int(np.argmax(overlaps))
                ovmax = overlaps[jmax]
            if ovmax > ovthresh:
                if R["difficult"][jmax]:
                    pass            # matched a difficult GT: ignored
                elif not R["det"][jmax]:
                    tp[i] = 1.0
                    R["det"][jmax] = True
                else:
                    fp[i] = 1.0     # duplicate match
            else:
                fp[i] = 1.0
        fp = np.cumsum(fp)
        tp = np.cumsum(tp)
        rec = tp / float(npos)
        prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        aps[c] = voc_ap(rec, prec, use_07_metric)
    mAP = float(np.mean(list(aps.values()))) if aps else 0.0
    return {"mAP": mAP, "per_class": aps}


class ArgoverseDataset:
    """Argoverse-HD COCO-json dataset (reference
    yolox/data/datasets/argoverse.py) — same surface as COCODataset."""

    def __init__(self, json_file: str, data_dir: str = "",
                 name: str = "tracking", img_size=(640, 640)):
        from ..eval.coco_api import COCO
        self.data_dir = data_dir
        self.name = name
        self.img_size = tuple(img_size)
        self.coco = COCO(json_file)
        self.ids = sorted(self.coco.getImgIds())
        self.class_ids = sorted(self.coco.getCatIds())
        self.classes = [c["name"]
                        for c in self.coco.loadCats(self.class_ids)]

    def __len__(self):
        return len(self.ids)

    def pull_item(self, index: int):
        id_ = self.ids[index]
        im = self.coco.loadImgs(id_)[0]
        width, height = im["width"], im["height"]
        anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=[id_],
                                                      iscrowd=0))
        rows = []
        for obj in anns:
            x1 = max(0, obj["bbox"][0])
            y1 = max(0, obj["bbox"][1])
            x2 = min(width, x1 + max(0, obj["bbox"][2]))
            y2 = min(height, y1 + max(0, obj["bbox"][3]))
            if obj.get("area", 0) > 0 and x2 >= x1 and y2 >= y1:
                rows.append([x1, y1, x2, y2,
                             self.class_ids.index(obj["category_id"])])
        res = np.asarray(rows, np.float32).reshape(-1, 5)
        path = os.path.join(self.data_dir, self.name,
                            im.get("name", im.get("file_name", "")))
        img = imread(path)
        return img, res, (height, width), id_
