"""The port's still-image augmentation (tscd_torch/data/transforms.py,
data/coco.py, the warp of data/image.py) against OpenCV and the JAX
package on the CPU:

  - `warp_affine` bit-equal to cv2.warpAffine (INTER_LINEAR, constant
    border) over many random matrices: the mosaic's rotations (+-10
    degrees), shears (+-2), scales 0.1-2 and translations, 2H x 2W sources
    warped to H x W, other sources and sizes, the output width all vector
    loop or with a scalar tail, pixels on and past the border, and other
    border values; `rotation_matrix_2d` equal to cv2.getRotationMatrix2D;
    the uint8 INTER_LINEAR resize at mixup's upscales (up to 1.5x) and at
    the same size;
  - random_perspective, the mosaic with and without mixup, the plain
    path and TrainTransform equal to JAX's, image bit for bit and labels
    exactly, at the same draws (JAX's global `random` and `np.random`
    seeded as the port's generators), on JPEG files of several sizes;
  - the batch loader's first batches (shuffled order, renders on a pool
    of threads) equal to JAX's BatchLoader's;
  - the warp hashes the card's machine is held to (the OVIS fixture's
    warp_sha256.json): cv2's, and the port's.
"""

import math
import os
import random
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from tscd_tpu.data import coco as jcoco  # noqa: E402
from tscd_tpu.data import transforms as jtf  # noqa: E402
from tscd_torch.data import coco as pcoco  # noqa: E402
from tscd_torch.data import image  # noqa: E402
from tscd_torch.data import transforms as ptf  # noqa: E402


def _affine(rng, src_hw, out_hw, far=False):
    """random_perspective's matrix with random draws (a 2 x 3 float64)."""
    C = np.eye(3)
    C[0, 2], C[1, 2] = -src_hw[1] / 2, -src_hw[0] / 2
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D(angle=rng.uniform(-10, 10), center=(0, 0),
                                    scale=rng.uniform(0.1, 2))
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-2, 2) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-2, 2) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.4, 0.6) * out_hw[1] + (rng.uniform(-3, 3) * out_hw[1] if far else 0)
    T[1, 2] = rng.uniform(0.4, 0.6) * out_hw[0]
    return (T @ S @ R @ C)[:2]


@pytest.mark.parametrize("kind", ["mosaic", "other_sizes", "far_and_borders"])
def test_warp_affine_equals_cv2(kind):
    rng = np.random.default_rng({"mosaic": 1, "other_sizes": 2, "far_and_borders": 3}[kind])
    sizes = [(64, 64), (128, 128), (40, 56), (33, 80), (320, 320)]
    for t in range(60):
        if kind == "mosaic":
            h, w = sizes[t % len(sizes)]
            src = (2 * h, 2 * w)
        else:
            h, w = int(rng.integers(3, 150)), int(rng.integers(3, 150))
            src = (int(rng.integers(2, 260)), int(rng.integers(2, 260)))
        img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
        if t % 3 == 0:                    # flat regions: rounding ties
            img = (img // 85 * 85).astype(np.uint8)
        M = _affine(rng, src, (h, w), far=kind == "far_and_borders" and t % 2 == 0)
        border = int(rng.integers(0, 256)) if kind == "far_and_borders" else 114
        want = cv2.warpAffine(img, M, dsize=(w, h), borderValue=(border,) * 3)
        got = image.warp_affine(img, M, (w, h), border)
        assert np.array_equal(got, want), (kind, t, int((got != want).sum()))


def test_rotation_matrix_and_resize_at_mixup_scales_equal_cv2():
    rng = np.random.default_rng(4)
    for _ in range(50):
        c, a, s = tuple(rng.uniform(-50, 50, 2)), rng.uniform(-180, 180), rng.uniform(0.1, 3)
        assert np.array_equal(image.rotation_matrix_2d(c, a, s),
                              cv2.getRotationMatrix2D(c, a, s))
    for h, w in ((128, 128), (96, 160), (640, 640)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for jit in (0.5, 0.77, 1.0, 1.23, 1.5):
            th, tw = int(h * jit), int(w * jit)
            assert np.array_equal(image.resize_linear(img, th, tw),
                                  cv2.resize(img, (tw, th))), (h, w, jit)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A COCO set of 9 JPEG images of several sizes, 2 categories, one image
    without boxes; the port's and JAX's COCODataset on it."""
    import json
    root = str(tmp_path_factory.mktemp("coco"))
    os.makedirs(os.path.join(root, "train2017"))
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(9):
        h, w = [(96, 128), (120, 90), (200, 150), (64, 64)][i % 4]
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 0)
        fn = f"{i:012d}.jpg"
        cv2.imwrite(os.path.join(root, "train2017", fn), img)
        images.append({"id": i, "file_name": fn, "width": w, "height": h})
        for _ in range(0 if i == 4 else int(rng.integers(1, 4))):
            bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
            x, y = rng.uniform(-4, w - bw + 4), rng.uniform(-4, h - bh + 4)
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": int(rng.integers(1, 3)),
                         "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0})
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}, f)
    return (pcoco.COCODataset(path, root, "train2017", (64, 64)),
            jcoco.COCODataset(path, root, "train2017", (64, 64)))


def _seed(s):
    random.seed(s)
    np.random.seed(s)
    return random.Random(s), np.random.RandomState(s)


def test_random_perspective_equals_jax(coco):
    port_ds, _ = coco
    for s in range(8):
        img = np.ascontiguousarray(port_ds.pull_item(s)[0])
        img2 = np.concatenate([img, img[::-1]], 0)
        targets = port_ds.pull_item(s)[1]
        targets2 = np.concatenate([targets, targets + [[0, img.shape[0], 0, img.shape[0], 0]]])
        border = (0, 0) if s % 2 else (-img.shape[0] // 2, -img.shape[1] // 4)
        rng, _ = _seed(s)
        want = jtf.random_perspective(img2.copy(), targets2.copy(), degrees=10, translate=0.1,
                                      scale=(0.1, 2), shear=2.0, border=border)
        got = ptf.random_perspective(img2.copy(), targets2.copy(), degrees=10, translate=0.1,
                                     scale=(0.1, 2), shear=2.0, border=border, rng=rng)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), s
        assert random.random() == rng.random()      # the same draws were taken


@pytest.mark.parametrize("hsv_prob,flip_prob", [(1.0, 0.5), (0.0, 1.0), (0.5, 0.0)])
def test_train_transform_equals_jax(coco, hsv_prob, flip_prob):
    port_ds, _ = coco
    kw = dict(max_labels=20, flip_prob=flip_prob, hsv_prob=hsv_prob)
    for s in range(9):
        img, targets = port_ds.pull_item(s)[:2]
        rng, np_rng = _seed(100 + s)
        want = jtf.TrainTransform(**kw)(img.copy(), targets.copy(), (64, 96))
        got = ptf.TrainTransform(**kw)(img.copy(), targets.copy(), (64, 96), rng, np_rng)
        assert got[0].dtype == want[0].dtype == np.float32
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), s
        assert random.random() == rng.random() and np.random.rand() == np_rng.rand()


@pytest.mark.parametrize("mosaic,mixup", [(True, True), (True, False), (False, False)])
def test_mosaic_and_mixup_equal_jax(coco, mosaic, mixup):
    port_ds, jax_ds = coco
    kw = dict(mosaic=mosaic, degrees=10.0, translate=0.1, mosaic_scale=(0.1, 2),
              mixup_scale=(0.5, 1.5), shear=2.0, enable_mixup=mixup, mosaic_prob=1.0,
              mixup_prob=1.0)
    jm = jcoco.MosaicDetection(jax_ds, (64, 96), preproc=jtf.TrainTransform(max_labels=50), **kw)
    pm = pcoco.MosaicDetection(port_ds, (64, 96), preproc=ptf.TrainTransform(max_labels=50), **kw)
    for s in range(9):
        rng, np_rng = _seed(200 + s)
        want = jm[s]
        got = pm.__getitem__(s, rng, np_rng)
        assert np.array_equal(got[0], want[0]), (s, int((got[0] != want[0]).sum()))
        assert np.array_equal(got[1], want[1]), s
        assert random.random() == rng.random() and np.random.rand() == np_rng.rand()


def test_batch_loader_equals_jax(coco):
    port_ds, jax_ds = coco
    jm = jcoco.MosaicDetection(jax_ds, (64, 64), preproc=jtf.TrainTransform(max_labels=30))
    pm = pcoco.MosaicDetection(port_ds, (64, 64), preproc=ptf.TrainTransform(max_labels=30))
    rng, np_rng = _seed(7)
    jit = iter(jcoco.BatchLoader(jm, 4, seed=3, prefetch=1))
    want = [next(jit) for _ in range(3)]
    time.sleep(1.0)    # JAX's worker renders 2 batches ahead, then blocks
    it = iter(pcoco.BatchLoader(pm, 4, seed=3, rng=rng, np_rng=np_rng, img_dtype=np.uint8))
    got = [next(it) for _ in range(3)]
    it.close()
    for g, w in zip(got, want):
        assert g["imgs"].dtype == np.uint8
        assert np.array_equal(g["imgs"].astype(np.float32), w["imgs"])
        assert np.array_equal(g["labels"], w["labels"])


def test_fixture_warp_hashes_are_cv2s_and_the_ports():
    """tscd_torch/data/fixtures/ovis/warp_sha256.json, which chip_smoke.py
    holds the card machine's warp to: cv2 makes each recorded hash from the
    recorded canvas and matrix, and so does the port."""
    import hashlib
    import json

    import chip_smoke
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, chip_smoke.OVIS_FIXTURE, "warp_sha256.json")) as f:
        rec = json.load(f)
    for rel, r in list(rec["frames"].items())[:4]:
        canvas = chip_smoke.warp_canvas(cv2.imread(os.path.join(repo, rel)), r["offset"])
        out = cv2.warpAffine(canvas, np.asarray(r["matrix"]), dsize=(640, 640),
                             borderValue=(114, 114, 114))
        assert hashlib.sha256(out.tobytes()).hexdigest() == r["sha256"], rel
    got = chip_smoke.warp_checks()
    assert got["pass"] and got["sha256_match"] == 32


@pytest.mark.parametrize("legacy", [False, True])
def test_val_transforms_mirror_and_hsv_equal_jax(coco, legacy):
    """ValTransform and VidValTransform (letterbox, the legacy RGB
    normalisation), mirror and augment_hsv at the same draws."""
    port_ds, _ = coco
    for s in range(4):
        img, res = port_ds.pull_item(s)[:2]
        for j, p in ((jtf.ValTransform(legacy), ptf.ValTransform(legacy)),
                     (jtf.VidValTransform(legacy), ptf.VidValTransform(legacy))):
            want, got = j(img.copy(), res.copy(), (64, 96)), p(img.copy(), res.copy(), (64, 96))
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
        rng, np_rng = _seed(300 + s)
        want = jtf.mirror(img, res[:, :4], 0.5)
        got = ptf.mirror(img, res[:, :4], 0.5, rng)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        want, got = np.ascontiguousarray(img), np.ascontiguousarray(img.copy())
        jtf.augment_hsv(want)
        ptf.augment_hsv(got, np_rng)
        assert np.array_equal(got, want)
