"""The port's VOC and still-image Argoverse data (tscd_torch/data/voc.py)
and VOCEvaluator (tscd_torch/eval/voc_evaluator.py) against the JAX
package's, on a VOC-layout fixture and an Argoverse-HD json made here
from the committed VID fixture (its 720p frames and XMLs, names mapped to
VOC's classes). Images are read by the port's imread and by cv2: equal
bytes; the AP arithmetic is the same numpy on both sides, so every
comparison is exact."""

import json
import os
from xml.dom import minidom

import numpy as np
import pytest

from tscd_torch.data import voc as pv
from tscd_tpu.data import voc as jv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VID = os.path.join(REPO, "tscd_torch", "data", "fixtures", "vid")
FRAMES = os.path.join(VID, "Data", "VID", "val", "fix0")
XMLS = os.path.join(VID, "Annotations", "VID", "val", "fix0")
WNID_TO_VOC = {"n02691156": "aeroplane", "n02958343": "car", "n02084071": "dog"}
N = 12


def _objects(i):
    doc = minidom.parse(os.path.join(XMLS, f"{i:06d}.xml"))
    out = []
    for o in doc.getElementsByTagName("object"):
        box = [int(o.getElementsByTagName(k)[0].firstChild.data)
               for k in ("xmin", "ymin", "xmax", "ymax")]
        out.append((WNID_TO_VOC[o.getElementsByTagName("name")[0].firstChild.data], box))
    return out


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    """VOCdevkit/VOC2007 over the first N fixture frames: JPEGImages
    (links), Annotations (every third object difficult, the first frame's
    without a difficult tag) and ImageSets/Main/test.txt."""
    root = tmp_path_factory.mktemp("VOCdevkit")
    base = root / "VOC2007"
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (base / d).mkdir(parents=True)
    ids = []
    for i in range(N):
        img_id = f"{i:06d}"
        os.symlink(os.path.join(FRAMES, f"{img_id}.JPEG"), base / "JPEGImages" / f"{img_id}.jpg")
        objs = []
        for k, (name, (x0, y0, x1, y1)) in enumerate(_objects(i)):
            diff = "" if i == 0 else f"<difficult>{int((i + k) % 3 == 0)}</difficult>"
            objs.append(f"<object><name>{name}</name>{diff}<bndbox><xmin>{x0}</xmin>"
                        f"<ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>")
        (base / "Annotations" / f"{img_id}.xml").write_text(
            f"<annotation>{''.join(objs)}</annotation>")
        ids.append(img_id)
    (base / "ImageSets" / "Main" / "test.txt").write_text("\n".join(ids) + "\n")
    return str(root)


def _dets(gts, seed):
    """Seeded detections near each gt (some off, some of another class) and
    clutter, as (K, 7) rows."""
    rng = np.random.default_rng(seed)
    out = {}
    for img_id, g in gts.items():
        rows = []
        for r in g:
            for _ in range(int(rng.integers(1, 3))):
                box = r[:4] + rng.normal(0, 12, 4)
                cls = r[4] if rng.uniform() > 0.15 else (r[4] + 1) % 20
                rows.append([*box, rng.uniform(0.3, 1), rng.uniform(0.2, 1), cls])
        for _ in range(2):
            xy = rng.uniform(0, 1000, 2)
            rows.append([*xy, *(xy + rng.uniform(20, 200, 2)), rng.uniform(0, 1),
                         rng.uniform(0, 1), int(rng.integers(0, 20))])
        out[img_id] = np.asarray(rows, np.float32)
    return out


def test_voc_detection_like_jax(voc_root):
    p = pv.VOCDetection(voc_root, (("2007", "test"),))
    j = jv.VOCDetection(voc_root, (("2007", "test"),))
    assert len(p) == len(j) == N and p.ids == j.ids
    for i in range(N):
        pi, ji = p.pull_item(i), j.pull_item(i)
        np.testing.assert_array_equal(pi[0], ji[0])
        np.testing.assert_array_equal(pi[1], ji[1])
        assert pi[2:] == ji[2:]
        np.testing.assert_array_equal(p.load_anno(i, keep_difficult=True),
                                      j.load_anno(i, keep_difficult=True))
    assert pv.parse_rec(os.path.join(voc_root, "VOC2007", "Annotations", "000004.xml")) == \
        jv.parse_rec(os.path.join(voc_root, "VOC2007", "Annotations", "000004.xml"))


@pytest.mark.parametrize("use_07", [False, True])
def test_voc_eval_like_jax(voc_root, use_07):
    ds = jv.VOCDetection(voc_root, (("2007", "test"),))
    gts = {ds.ids[i][1]: ds.load_anno(i, keep_difficult=True) for i in range(N)}
    for seed in (0, 1):
        dets = _dets(gts, seed)
        got = pv.voc_eval(dets, gts, use_07_metric=use_07)
        want = jv.voc_eval(dets, gts, use_07_metric=use_07)
        assert got == want and got["mAP"] > 0
    rec = np.linspace(0, 1, 9)
    prec = np.linspace(1, 0.2, 9)
    assert pv.voc_ap(rec, prec, use_07) == jv.voc_ap(rec, prec, use_07)


def test_voc_evaluator_like_jax(voc_root):
    """VOCEvaluator over the fixture (letterboxed batches of 8, difficult
    gts kept) with one fixed predict_fn: the same mAP and per-class APs."""
    from tscd_torch.eval.voc_evaluator import VOCEvaluator as PE
    from tscd_tpu.eval.voc_evaluator import VOCEvaluator as JE

    def predict_fn():
        calls = {"n": 0}

        def fn(imgs):
            rng = np.random.default_rng(calls["n"])
            calls["n"] += 1
            assert imgs.shape == (8, 320, 320, 3)
            out = []
            for _ in range(len(imgs)):
                xy = rng.uniform(0, 250, (5, 2))
                out.append(np.c_[xy, xy + rng.uniform(20, 120, (5, 2)),
                                 rng.uniform(0, 1, (5, 2)), rng.integers(0, 20, 5)])
            return out
        return fn

    quiet = lambda *a: None  # noqa: E731
    got = PE(pv.VOCDetection(voc_root, (("2007", "test"),)), img_size=(320, 320)).evaluate(
        predict_fn(), log=quiet)
    want = JE(jv.VOCDetection(voc_root, (("2007", "test"),)), img_size=(320, 320)).evaluate(
        predict_fn(), log=quiet)
    assert got == want


def test_argoverse_like_jax(tmp_path):
    """An Argoverse-HD json (images named by `name` and by `file_name`,
    boxes past the image, zero-area and crowd annotations) over the
    fixture frames: pull_item equal to JAX's."""
    images, anns = [], []
    for i in range(6):
        key = "name" if i % 2 else "file_name"
        images.append({"id": 10 + i, "width": 1280, "height": 720, key: f"{i:06d}.JPEG"})
        for k, (name, (x0, y0, x1, y1)) in enumerate(_objects(i)):
            anns.append({"id": len(anns) + 1, "image_id": 10 + i, "iscrowd": 0,
                         "category_id": [3, 1, 8][k % 3],
                         "bbox": [x0 - 20 * k, y0, x1 - x0 + 900 * (k == 1), y1 - y0],
                         "area": float((x1 - x0) * (y1 - y0)) * (i != 3 or k != 0)})
        anns.append({"id": len(anns) + 1, "image_id": 10 + i, "iscrowd": 1, "category_id": 1,
                     "bbox": [5, 5, 10, 10], "area": 100.0})
    cats = [{"id": c, "name": n} for c, n in ((1, "person"), (3, "car"), (8, "truck"))]
    js = tmp_path / "ann.json"
    js.write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    p = pv.ArgoverseDataset(str(js), data_dir=os.path.dirname(FRAMES), name="fix0")
    j = jv.ArgoverseDataset(str(js), data_dir=os.path.dirname(FRAMES), name="fix0")
    assert (len(p), p.ids, p.class_ids, p.classes) == (len(j), j.ids, j.class_ids, j.classes)
    for i in range(len(p)):
        pi, ji = p.pull_item(i), j.pull_item(i)
        np.testing.assert_array_equal(pi[0], ji[0])
        np.testing.assert_array_equal(pi[1], ji[1])
        assert pi[2:] == ji[2:]
