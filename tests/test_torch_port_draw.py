"""The port's drawing (tscd_torch/utils/visualize.py over
tscd_torch/csrc/host/draw.cpp) against cv2 5.0.0, byte for byte: `vis`
against JAX's cv2 `vis` (tscd_tpu/utils/visualize.py), and each of its
calls (rectangle at thickness 2 and filled, getTextSize, putText at
FONT_HERSHEY_SIMPLEX 0.4, thickness 1) against cv2's."""

import os

import cv2
import numpy as np
import pytest

from tscd_torch.data.image import imread
from tscd_torch.data.vid import VID_CLASSES
from tscd_torch.data.voc import VOC_CLASSES
from tscd_torch.eval.vid_evaluator import OVIS_CLASSES
from tscd_torch.tools.demo import COCO_CLASSES
from tscd_torch.utils import visualize as pv
from tscd_tpu.utils import visualize as jv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX0 = os.path.join(REPO, "tscd_torch", "data", "fixtures", "vid", "Data", "VID", "val",
                    "fix0")
FONT = cv2.FONT_HERSHEY_SIMPLEX
NAMES = {"vid": VID_CLASSES, "ovis": OVIS_CLASSES, "coco": COCO_CLASSES, "voc": VOC_CLASSES}


def test_class_tables_are_jax_ones():
    from tscd_tpu.data.vid import VID_CLASSES as J_VID
    from tscd_tpu.data.voc import VOC_CLASSES as J_VOC
    from tscd_tpu.eval.vid_evaluator import OVIS_CLASSES as J_OVIS
    assert list(VID_CLASSES) == list(J_VID) and list(OVIS_CLASSES) == list(J_OVIS)
    assert tuple(VOC_CLASSES) == tuple(J_VOC)
    np.testing.assert_array_equal(pv._COLORS, jv._COLORS)


@pytest.mark.parametrize("table", sorted(NAMES))
def test_text_size_every_label(table):
    """get_text_size of every label vis writes for the table's classes,
    scores 0.0% to 100.0% in steps of 0.1%, = cv2.getTextSize."""
    n = 0
    for name in NAMES[table]:
        for p in range(1001):
            text = f"{name}:{p / 10:.1f}%"
            assert pv.get_text_size(text) == cv2.getTextSize(text, FONT, 0.4, 1), text
            n += 1
    assert n == 1001 * len(NAMES[table])


def test_text_size_and_put_text_every_character():
    """Every printable ASCII character alone, and seeded strings of them at
    seeded origins past every edge of a noise image, in seeded colours."""
    rng = np.random.default_rng(0)
    for c in map(chr, range(32, 127)):
        assert pv.get_text_size(c) == cv2.getTextSize(c, FONT, 0.4, 1)
    assert pv.get_text_size("") == cv2.getTextSize("", FONT, 0.4, 1)
    for _ in range(300):
        img = rng.integers(0, 256, (40, 90, 3), dtype=np.uint8)
        text = "".join(map(chr, rng.integers(32, 127, int(rng.integers(1, 16)))))
        org = (int(rng.integers(-60, 100)), int(rng.integers(-5, 55)))
        color = [int(v) for v in rng.integers(0, 256, 3)]
        want = img.copy()
        cv2.putText(want, text, org, FONT, 0.4, color, 1)
        np.testing.assert_array_equal(pv.put_text(img, text, org, color), want, err_msg=text)
    with pytest.raises(ValueError, match="ASCII"):
        pv.get_text_size("café")


@pytest.mark.parametrize("thickness", [2, -1])
def test_rectangle_like_cv2(thickness):
    """Seeded rectangles on a small noise image: past each edge, reversed,
    zero width, zero height and single points."""
    rng = np.random.default_rng(thickness + 10)
    for t in range(1500):
        h, w = int(rng.integers(5, 60)), int(rng.integers(5, 60))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p0 = tuple(int(v) for v in rng.integers(-20, 80, 2))
        p1 = tuple(int(v) for v in rng.integers(-20, 80, 2))
        if t % 5 == 0:
            p1 = (p0[0], p1[1])
        if t % 7 == 0:
            p1 = (p1[0], p0[1])
        if t % 11 == 0:
            p1 = p0
        color = [int(v) for v in rng.integers(0, 256, 3)]
        want = img.copy()
        cv2.rectangle(want, p0, p1, color, thickness)
        np.testing.assert_array_equal(pv.rectangle(img, p0, p1, color, thickness), want,
                                      err_msg=f"{p0} {p1} on {h} x {w}")
    with pytest.raises(ValueError, match="thickness"):
        pv.rectangle(np.zeros((4, 4, 3), np.uint8), (0, 0), (2, 2), (1, 2, 3), 1)


def _vis_both(img, boxes, scores, cls_ids, conf, names):
    want = jv.vis(img.copy(), boxes, scores, cls_ids, conf, names)
    got = img.copy()
    assert pv.vis(got, boxes, scores, cls_ids, conf, names) is got
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("table", sorted(NAMES))
def test_vis_every_class(table):
    """Every class of the table drawn on a fixture frame at scores 0.0%,
    0.1%, 33.3%, 99.9% and 100.0%, boxes tiled over the frame (some text
    running off the right edge)."""
    img = imread(os.path.join(FIX0, sorted(os.listdir(FIX0))[0]))
    names = NAMES[table]
    boxes, scores, cls_ids = [], [], []
    for c in range(len(names)):
        for k, s in enumerate((0.0, 0.001, 0.333, 0.999, 1.0)):
            x0 = (c * 97 + k * 211) % 1240
            y0 = (c * 23 + k * 131) % 690
            boxes.append([x0 + 0.7, y0 + 0.2, x0 + 40.9, y0 + 25.5])
            scores.append(s)
            cls_ids.append(c)
    _vis_both(img, np.float32(boxes), np.float32(scores), np.asarray(cls_ids, np.float32),
              0.0, names)


def test_vis_edges_and_degenerate_boxes():
    """Boxes past each of the four edges and its corners, zero-width and
    reversed boxes, negative coordinates that truncate toward zero, class
    ids past the colour table and the names, names None."""
    img = imread(os.path.join(FIX0, sorted(os.listdir(FIX0))[3]))
    h, w = img.shape[:2]
    boxes = np.float32([
        [-30.6, 100, 50, 160], [w - 40, 200, w + 30, 260], [300, -20.4, 380, 40],
        [500, h - 10, 560, h + 25], [-15, -15, 20, 20], [w - 5, h - 5, w + 40, h + 40],
        [600, 300, 600, 360], [700, 400, 760, 400], [900, 500, 850, 450], [-0.9, 5, 30, 40],
        [w - 12, 50, w - 2, 70], [1000, 600, 1010, 610]])
    scores = np.float32([0.9, 0.8, 0.7, 0.6, 0.5, 0.45, 0.4, 0.35, 0.3, 0.25, 0.99, 0.01])
    cls_ids = np.float32([0, 1, 2, 3, 29, 30, 79, 85, 5, 6, 7, 8])
    for names in (VID_CLASSES, None):
        _vis_both(img, boxes, scores, cls_ids, 0.2, names)


def test_vis_seeded_boxes_on_fixture_frames():
    """Seeded detections like a demo's (boxes in a 720p frame's pixels,
    float32 scores and ids, some under conf) on the fixture frames."""
    rng = np.random.default_rng(7)
    for f in sorted(os.listdir(FIX0))[:6]:
        img = imread(os.path.join(FIX0, f))
        n = 40
        xy = rng.uniform(-100, 1300, (n, 2))
        wh = rng.uniform(0, 300, (n, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        _vis_both(img, boxes, rng.uniform(0, 1, n).astype(np.float32),
                  rng.integers(0, 30, n).astype(np.float32), 0.25, VID_CLASSES)
