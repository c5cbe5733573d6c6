"""Writes the OVIS-format json of the port's fixtures,
tscd_torch/data/fixtures/ovis/annotations_{train,valid}.json: per-frame
COCO json (images with `sid`, `videos`, annotations, OVIS's 25 categories)
over the 32 committed frames of tscd_torch/data/fixtures/vid (file names
relative to vid/Data/VID/val), boxes from their XML, each ImageNet VID
class mapped to its OVIS one. train: two videos, frames 0-19 and 20-31 (the
second shorter than a 4 + 12 training window, so the dataset pads it);
valid: one video of all 32 frames (4 eval windows of 8 + 24). Both serve
stage 1 (COCODataset, one image a frame) and stage 2 (OVISVideoDataset).

With cv2 it also writes warp_sha256.json: for each frame a mosaic-like
canvas (the frame letterboxed to 640 px onto a 1280 x 1280 canvas of 114
at a seeded offset) warped by a seeded random_perspective matrix to 640 x
640 with cv2.warpAffine (INTER_LINEAR, border 114), the matrix and the
sha256 of cv2's pixels, which chip_smoke.py holds the port's warp to where
there is no cv2 (`warp_checks`; the canvas is its `warp_canvas`).

    PYTHONPATH=. python tests/torch_port_ovis_fixture.py
"""

import hashlib
import json
import math
import os
from xml.dom import minidom

import numpy as np

from tscd_torch.eval.vid_evaluator import OVIS_CLASSES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VID = os.path.join(REPO, "tscd_torch", "data", "fixtures", "vid")
OUT = os.path.join(REPO, "tscd_torch", "data", "fixtures", "ovis")
FRAMES = 32
# the fixture's ImageNet VID classes -> OVIS's
WNID_TO_OVIS = {"n02691156": "Airplane", "n02958343": "Vehical", "n02084071": "Dog"}
SPLITS = {"train": [range(0, 20), range(20, 32)], "valid": [range(0, 32)]}


def frame_boxes(i):
    root = minidom.parse(os.path.join(VID, "Annotations", "VID", "val", "fix0",
                                      f"{i:06d}.xml")).documentElement
    out = []
    for obj in root.getElementsByTagName("object"):
        get = lambda tag: int(obj.getElementsByTagName(tag)[0].firstChild.data)  # noqa: E731
        name = obj.getElementsByTagName("name")[0].firstChild.data
        out.append((WNID_TO_OVIS[name], get("xmin"), get("ymin"), get("xmax"), get("ymax")))
    return out


def split_json(videos):
    cat_id = {n: i + 1 for i, n in enumerate(OVIS_CLASSES)}
    images, annotations = [], []
    for sid, frames in enumerate(videos):
        for i in frames:
            img_id = len(images) + 1
            images.append({"id": img_id, "file_name": f"fix0/{i:06d}.JPEG", "width": 1280,
                           "height": 720, "sid": sid})
            for name, x1, y1, x2, y2 in frame_boxes(i):
                annotations.append({"id": len(annotations) + 1, "image_id": img_id,
                                    "category_id": cat_id[name],
                                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                                    "area": (x2 - x1) * (y2 - y1), "iscrowd": 0})
    return {"videos": [{"id": sid + 1, "name": f"fix0_{sid}"} for sid in range(len(videos))],
            "images": images, "annotations": annotations,
            "categories": [{"id": i + 1, "name": n} for i, n in enumerate(OVIS_CLASSES)]}


def warp_matrix(rng):
    """random_perspective's matrix for the 1280 x 1280 canvas with the
    mosaic's border (-320, -320) and seeded draws: degrees 10, translate
    0.1, scale 0.1-2, shear 2."""
    C = np.eye(3)
    C[0, 2] = C[1, 2] = -640.0
    R = np.eye(3)
    a, sc = rng.uniform(-10, 10), rng.uniform(0.1, 2)
    alpha, beta = math.cos(a * math.pi / 180) * sc, math.sin(a * math.pi / 180) * sc
    R[:2] = [[alpha, beta, 0.0], [-beta, alpha, 0.0]]
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-2, 2) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-2, 2) * math.pi / 180)
    T = np.eye(3)
    T[0, 2], T[1, 2] = rng.uniform(0.4, 0.6) * 640, rng.uniform(0.4, 0.6) * 640
    return (T @ S @ R @ C)[:2]


def warp_records():
    import cv2

    from chip_smoke import warp_canvas
    rng = np.random.default_rng(14)
    out = {}
    for i in range(FRAMES):
        rel = os.path.join("tscd_torch", "data", "fixtures", "vid", "Data", "VID", "val",
                           "fix0", f"{i:06d}.JPEG")
        offset = (int(rng.integers(0, 640)), int(rng.integers(0, 640)))
        M = warp_matrix(rng)
        canvas = warp_canvas(cv2.imread(os.path.join(REPO, rel)), offset)
        warped = cv2.warpAffine(canvas, M, dsize=(640, 640), borderValue=(114, 114, 114))
        out[rel] = {"offset": list(offset), "matrix": M.tolist(),
                    "sha256": hashlib.sha256(warped.tobytes()).hexdigest()}
    return {"cv2": cv2.__version__, "size": [640, 640], "border": 114, "frames": out}


def main():
    os.makedirs(OUT, exist_ok=True)
    for split, videos in SPLITS.items():
        with open(os.path.join(OUT, f"annotations_{split}.json"), "w") as f:
            json.dump(split_json(videos), f, indent=0)
    with open(os.path.join(OUT, "warp_sha256.json"), "w") as f:
        json.dump(warp_records(), f, indent=1)


if __name__ == "__main__":
    main()
