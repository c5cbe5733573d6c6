"""The port's numpy post-processing (tscd_torch/postprocess: linking, REPP,
motion eval; utils/demo_utils) and VIDEvaluator(traj_linking=True) against
the JAX package's on seeded synthetic detections. Both sides are numpy in
float64 with the same operations, so every comparison is exact (the
evaluator's COCO statistics too)."""

import json

import numpy as np
import pytest

import tscd_torch.postprocess as P
import tscd_tpu.postprocess as J
from tscd_torch.postprocess import linking as pl
from tscd_torch.utils import demo_utils as pd
from tscd_tpu.postprocess import linking as jl
from tscd_tpu.utils import demo_utils as jd


def _video(seed, frames=12, objects=4, classes=5, noise=3.0, drop=0.15):
    """Per-frame (K, 7) rows of objects moving across frames: jittered
    boxes, scores, a class each, some detections dropped, some clutter."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 400, (objects, 2))
    vel = rng.normal(0, 6, (objects, 2))
    size = rng.uniform(20, 120, (objects, 2))
    cls = rng.integers(0, classes, objects)
    out = []
    for f in range(frames):
        rows = []
        for o in range(objects):
            if rng.uniform() < drop:
                continue
            xy = start[o] + f * vel[o] + rng.normal(0, noise, 2)
            wh = size[o] * rng.uniform(0.9, 1.1, 2)
            rows.append([*xy, *(xy + wh), rng.uniform(0.3, 1), rng.uniform(0.2, 1), cls[o]])
        for _ in range(int(rng.integers(0, 3))):
            xy = rng.uniform(0, 500, 2)
            rows.append([*xy, *(xy + rng.uniform(10, 80, 2)), rng.uniform(0, 0.5),
                         rng.uniform(0, 0.5), int(rng.integers(0, classes))])
        out.append(np.asarray(rows, np.float32).reshape(-1, 7))
    return out


def _equal_rows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linking_like_jax(seed):
    dets = _video(seed)
    np.testing.assert_array_equal(pl.iou_matrix(dets[0][:, :4], dets[1][:, :4]),
                                  jl.iou_matrix(dets[0][:, :4], dets[1][:, :4]))
    np.testing.assert_array_equal(pl.get_linking_mat(dets[0], dets[1], 0.3),
                                  jl.get_linking_mat(dets[0], dets[1], 0.3))
    assert P.get_tubelets(dets, 0.4) == J.get_tubelets(dets, 0.4)
    _equal_rows(P.post_linking(dets), J.post_linking(dets))
    # past MAX_LINKING_FRAMES the video is linked in chunks
    long = [d for s in range(35) for d in _video(seed * 50 + s)]
    assert len(long) > P.linking.MAX_LINKING_FRAMES
    _equal_rows(P.post_linking(long), J.post_linking(long))


def test_online_previous_selection_like_jax():
    rng = np.random.default_rng(4)
    bank = {"cls": [rng.normal(size=(3, 4)) for _ in range(40)],
            "boxes": [rng.normal(size=(3, 4)) for _ in range(40)]}
    got = P.online_previous_selection({k: list(v) for k, v in bank.items()}, 31,
                                      rng=np.random.default_rng(9))
    want = J.online_previous_selection({k: list(v) for k, v in bank.items()}, 31,
                                       rng=np.random.default_rng(9))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def _classifier(tmp_path):
    path = tmp_path / "clf.json"
    path.write_text(json.dumps({"coef": [0.5, -0.8, 6.0, -0.01], "intercept": -1.5,
                                "feats": list(P.repp.PAIR_FEATURE_ORDER)}))
    return str(path)


@pytest.mark.parametrize("distance", ["def", "logreg"])
@pytest.mark.parametrize("post", [True, False])
def test_repp_like_jax(tmp_path, distance, post):
    """REPP with the IoU-score distance and with the logistic pair
    classifier (a JSON model file), linking on (`post`) and off: the
    processed per-frame dicts and the (K, 7) rows of process_video_dets."""
    kw = dict(min_tubelet_score=0.05, min_pred_score=0.01, post=post)
    if distance == "logreg":
        kw.update(clf_model_path=_classifier(tmp_path), clf_mode="dot", clf_threshold=0.3)
    for seed in (3, 4):
        dets = _video(seed, classes=30)
        _equal_rows(P.REPP(**kw).process_video_dets(list(dets)),
                    J.REPP(**kw).process_video_dets(list(dets)))
        video_p = [P.rows_to_repp(d, 30, (640, 480)) for d in dets]
        video_j = [J.rows_to_repp(d, 30, (640, 480)) for d in dets]
        got, want = P.REPP(**kw)(video_p), J.REPP(**kw)(video_j)
        assert [len(f) for f in got] == [len(f) for f in want]
        for fg, fw in zip(got, want):
            for a, b in zip(fg, fw):
                np.testing.assert_array_equal(np.asarray(a["bbox"]), np.asarray(b["bbox"]))
                np.testing.assert_array_equal(a["scores"], b["scores"])
        ids = list(range(100, 100 + len(dets)))
        assert P.repp_to_coco(got, ids, min_pred_score=0.01) == \
            J.repp_to_coco(want, ids, min_pred_score=0.01)


def test_pair_features_and_classifier_like_jax(tmp_path):
    d = [P.rows_to_repp(x, 30, (640, 480)) for x in _video(5, classes=30)]
    for a in d[0]:
        for b in d[1]:
            assert P.get_pair_features(a, b) == J.get_pair_features(a, b)
    fp, names_p = P.repp.load_pair_classifier(_classifier(tmp_path))
    fj, names_j = J.repp.load_pair_classifier(_classifier(tmp_path))
    x = np.random.default_rng(0).normal(size=(7, 4))
    assert names_p == names_j
    np.testing.assert_array_equal(fp(x), fj(x))


def test_motion_eval_like_jax(tmp_path):
    """vid_eval_motion on seeded detections and ground truth with motion
    IoUs from compute_motion_ious, and from a .mat file through
    load_motion_mat (scipy)."""
    import scipy.io as sio
    rng = np.random.default_rng(6)
    gts, tracks = [], {}
    for f in range(20):
        rows = []
        for t in range(3):
            xy = np.array([50 + 30 * t + f * (1 + 4 * t), 60 + 10 * t])
            rows.append([*xy, *(xy + [40 + 20 * t, 30 + 20 * t]), t])
            tracks.setdefault(t, []).append((f, np.asarray(rows[-1][:4])))
        gts.append(np.asarray(rows, np.float32))
    dets = [np.concatenate([np.c_[g[:, :4] + rng.normal(0, 4, (len(g), 4)),
                                  rng.uniform(0.2, 1, (len(g), 2)), g[:, 4]],
                            [[10, 10, 60, 70, 0.5, 0.3, 1]]]).astype(np.float32)
            for g in gts]
    mi_p, mi_j = P.motion_eval.compute_motion_ious(tracks), J.motion_eval.compute_motion_ious(tracks)
    assert mi_p == mi_j
    motion = [np.asarray([mi_p[(f, t)] for t in range(3)]) for f in range(20)]
    assert P.vid_eval_motion(dets, gts, motion, num_classes=3) == \
        J.vid_eval_motion(dets, gts, motion, num_classes=3)
    assert P.vid_eval_motion(dets, gts, None, num_classes=3) == \
        J.vid_eval_motion(dets, gts, None, num_classes=3)
    cells = np.empty((20, 1), dtype=object)      # the official file's layout:
    for f in range(20):                          # a (N_gt, 1) column an image
        cells[f, 0] = np.asarray(motion[f], np.float64).reshape(-1, 1)
    mat = tmp_path / "motion.mat"
    sio.savemat(str(mat), {"motion_iou": cells})
    lp, lj = P.motion_eval.load_motion_mat(str(mat)), J.motion_eval.load_motion_mat(str(mat))
    _equal_rows(lp, lj)
    assert P.vid_eval_motion(dets, gts, lp, num_classes=3) == \
        J.vid_eval_motion(dets, gts, lj, num_classes=3)


def test_demo_utils_like_jax():
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, 300, (60, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 80, (60, 2))], 1)
    scores = rng.uniform(0, 1, (60, 4))
    assert pd.nms_numpy(boxes, scores[:, 0], 0.45) == jd.nms_numpy(boxes, scores[:, 0], 0.45)
    for aware in (True, False):
        a = pd.multiclass_nms(boxes, scores, 0.45, 0.1, class_agnostic=not aware)
        b = jd.multiclass_nms(boxes, scores, 0.45, 0.1, class_agnostic=not aware)
        np.testing.assert_array_equal(a, b)
    out = rng.normal(size=(1, 8 * 8 + 4 * 4 + 2 * 2, 9)).astype(np.float32)
    np.testing.assert_array_equal(pd.demo_postprocess(out.copy(), (64, 64)),
                                  jd.demo_postprocess(out.copy(), (64, 64)))


class _Loader:
    """Windows of two videos (L local + G global frames; paths of the
    local frames' videos, frame index in the name), seeded labels."""

    def __init__(self, L=2, G=2, per_video=6):
        self.L, self.G = L, G
        rng = np.random.default_rng(11)
        self.batches = []
        for v in range(2):
            for lo in range(0, per_video, L):
                labels = [np.asarray([[k % 5, *(rng.uniform(0, 200, 2)),
                                       *(rng.uniform(250, 500, 2))] for k in range(3)]
                                     + [[0, 0, 0, 0, 0]], np.float32) for _ in range(L)]
                self.batches.append({
                    "imgs": np.zeros((L + G, 8, 8, 3), np.float32),
                    "time_embedding": np.zeros((L + G, 256), np.float32),
                    "paths": [f"Data/VID/val/vid{v}/{lo + k:06d}.JPEG" for k in range(L)],
                    "infos": [(720, 1280)] * L, "labels": labels})

    def __iter__(self):
        return iter(self.batches)


def _predict_fn():
    calls = {"n": 0}

    def predict(imgs, te, resume, state):
        rng = np.random.default_rng(100 + calls["n"])
        calls["n"] += 1
        out = []
        for f in range(2):
            xy = rng.uniform(0, 200, (6, 2))
            out.append(np.c_[xy, xy + rng.uniform(150, 300, (6, 2)), rng.uniform(0, 1, (6, 2)),
                             rng.integers(0, 5, 6)].astype(np.float32))
        return out, state
    return predict


@pytest.mark.parametrize("traj", [True, False])
def test_vid_evaluator_traj_linking_like_jax(traj):
    """The port's VIDEvaluator and JAX's on the same windows and the same
    fixed predict_fn (no model): linked and not, the same statistics."""
    from tscd_torch.eval.vid_evaluator import VIDEvaluator as PE
    from tscd_tpu.eval.vid_evaluator import VIDEvaluator as JE
    kw = dict(num_classes=5, class_names=[f"c{i}" for i in range(5)], lframe=2, gframe=2,
              traj_linking=traj)
    got = PE(_Loader(), **kw).evaluate(_predict_fn(), log=lambda *a: None)
    want = JE(_Loader(), **kw).evaluate(_predict_fn(), log=lambda *a: None)
    assert got["stats"] == want["stats"]
    assert (got["mAP"], got["AP50"]) == (want["mAP"], want["AP50"])
    np.testing.assert_equal(got["per_class_AP50"], want["per_class_AP50"])  # NaN: no gt
    assert got["mAP"] > 0
