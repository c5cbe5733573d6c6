"""Minimal COCO-format annotation API (a copy of
tscd_tpu/eval/coco_api.py): the subset of pycocotools.coco.COCO that the
evaluators use (imgs, anns, cats, getAnnIds, loadAnns, loadRes), json
backed, plain Python.
"""

import copy
import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Union


class COCO:
    def __init__(self, annotation_file: Optional[Union[str, dict]] = None):
        self.dataset: Dict[str, Any] = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            else:
                self.dataset = annotation_file
            self.createIndex()

    def createIndex(self):
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.imgToAnns, self.catToImgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.imgToAnns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
            self.catToImgs[ann["category_id"]].append(ann["image_id"])
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def getImgIds(self, imgIds=(), catIds=()):
        imgIds = list(imgIds) if hasattr(imgIds, '__iter__') else [imgIds]
        catIds = list(catIds) if hasattr(catIds, '__iter__') else [catIds]
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        for c in catIds:
            ids &= set(self.catToImgs[c])
        return sorted(ids)

    def getCatIds(self, catNms=(), supNms=(), catIds=()):
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getAnnIds(self, imgIds=(), catIds=(), areaRng=(), iscrowd=None):
        imgIds = [imgIds] if not hasattr(imgIds, '__iter__') else list(imgIds)
        catIds = [catIds] if not hasattr(catIds, '__iter__') else list(catIds)
        if imgIds:
            anns = [a for i in imgIds for a in self.imgToAnns[i]]
        else:
            anns = list(self.anns.values())
        if catIds:
            cs = set(catIds)
            anns = [a for a in anns if a["category_id"] in cs]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def loadAnns(self, ids):
        if not hasattr(ids, '__iter__'):
            return [self.anns[ids]]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        if not hasattr(ids, '__iter__'):
            return [self.imgs[ids]]
        return [self.imgs[i] for i in ids]

    def loadCats(self, ids):
        if not hasattr(ids, '__iter__'):
            return [self.cats[ids]]
        return [self.cats[i] for i in ids]

    def loadRes(self, resFile) -> "COCO":
        """Build a result COCO from a list of detection dicts
        ({image_id, category_id, bbox xywh, score})."""
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset.get("images", [])]
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(resFile)
        res.dataset["categories"] = copy.deepcopy(
            self.dataset.get("categories", []))
        for i, ann in enumerate(anns):
            bb = ann["bbox"]
            ann.setdefault("area", bb[2] * bb[3])
            ann["id"] = i + 1
            ann.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.createIndex()
        return res
