"""The port's evaluation path against the JAX package's, on the CPU.

  (a) COCOeval (numpy) and COCOeval_opt (native) on seeded detections
      and ground truth: stats and per-class tables equal exactly (the
      same float64 arithmetic);
  (b) the native library builds into build/native/;
  (c) the slice as a whole: on the VID fixture (YOLOX_outputs/
      validate_ref/vid) with the selftest config and JAX weights carried
      into the port, the port's loader + VIDEvaluator + make_predict_fn
      against the JAX package's loader + VIDEvaluator + a JAX predict
      function, both pipelined (dispatch/materialize): per-frame
      detections in order within 1e-4 (fp32 with another summation
      order), COCO stats within 1e-4;
  (d) the tscd_eval CLI writes the in-process run's result.
"""

import json
import math
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.data.vid import VIDDataset as JVIDDataset
from tscd_tpu.data.vid import WindowLoader as JWindowLoader
from tscd_tpu.eval.coco_api import COCO as JCOCO
from tscd_tpu.eval.cocoeval import COCOeval as JCOCOeval
from tscd_tpu.eval.fast_cocoeval import COCOeval_opt as JCOCOeval_opt
from tscd_tpu.eval.vid_evaluator import VIDEvaluator as JVIDEvaluator
from tscd_tpu.models.matching import init_matcher_state as jinit
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.models.tscd import tscd_eval_postprocess as jpost
from tscd_torch.core.predict import make_predict_fn
from tscd_torch.eval import fast_cocoeval
from tscd_torch.eval.coco_api import COCO
from tscd_torch.eval.cocoeval import COCOeval
from tscd_torch.eval.fast_cocoeval import COCOeval_opt
from tscd_torch.exp import selftest_exp
from torch_port_util import carry

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "YOLOX_outputs", "validate_ref", "vid")


def _coco_case(seed=0, n_img=6, n_cat=3):
    rng = np.random.default_rng(seed)
    images = [{"id": i, "width": 640, "height": 480} for i in range(n_img)]
    cats = [{"id": c + 1, "name": f"c{c}"} for c in range(n_cat)]
    gts, dts = [], []
    for i in range(n_img):
        for _ in range(rng.integers(0, 5)):
            xy, wh = rng.uniform(0, 400, 2), rng.uniform(4, 200, 2)
            gts.append({"id": len(gts) + 1, "image_id": i,
                        "category_id": int(rng.integers(1, n_cat + 1)),
                        "bbox": [*map(float, xy), *map(float, wh)],
                        "area": float(wh[0] * wh[1]),
                        "iscrowd": int(rng.uniform() < 0.1)})
        for g in [g for g in gts if g["image_id"] == i]:    # near-hits
            if rng.uniform() < 0.8:
                b = np.asarray(g["bbox"]) + rng.normal(0, 6, 4)
                dts.append({"image_id": i, "category_id": g["category_id"],
                            "bbox": [*map(float, b[:2]), *map(float, np.abs(b[2:]) + 1)],
                            "score": float(rng.uniform())})
        for _ in range(rng.integers(0, 6)):                   # misses
            xy, wh = rng.uniform(0, 400, 2), rng.uniform(2, 150, 2)
            dts.append({"image_id": i, "category_id": int(rng.integers(1, n_cat + 1)),
                        "bbox": [*map(float, xy), *map(float, wh)],
                        "score": float(rng.uniform())})
    return {"images": images, "categories": cats, "annotations": gts}, dts


def _same(a, b):
    """Equal, NaN equal to NaN, through dicts and lists."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def _run(cls, coco_cls, gt, dts):
    g = coco_cls(gt)
    e = cls(g, g.loadRes(dts), "bbox")
    e.evaluate()
    e.accumulate()
    return e


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("native", [False, True])
def test_cocoeval_matches_jax(seed, native):
    gt, dts = _coco_case(seed)
    got = _run(COCOeval_opt if native else COCOeval, COCO, gt, dts)
    want = _run(JCOCOeval_opt if native else JCOCOeval, JCOCO, gt, dts)
    assert np.array_equal(got.summarize(), want.summarize())
    assert got.stats[1] > 0
    for k in ("precision", "recall", "scores"):
        assert np.array_equal(got.eval[k], want.eval[k])
    for thr in (None, 0.5):
        assert _same(got.per_class_ap(iouThr=thr), want.per_class_ap(iouThr=thr))
        assert _same(got.per_class_ar(iouThr=thr), want.per_class_ar(iouThr=thr))


def test_native_cocoeval_builds_into_build_native():
    lib = fast_cocoeval.load_library()
    path = fast_cocoeval.library_path()
    assert path.parent == fast_cocoeval.BUILD_DIR
    assert fast_cocoeval.BUILD_DIR == type(path)(REPO) / "build" / "native"
    assert path.exists() and lib.cocoeval_evaluate_img is not None


EXP = selftest_exp()
EXP.data_dir = FIXTURE
EXP.val_seq_path = os.path.join(FIXTURE, "val_seq.npy")
L, G = EXP.lframe_val, EXP.gframe_val


def _recording(predict, out):
    """The predict function, its materialized rows appended to `out`."""
    def materialize(dev):
        rows = predict.materialize(dev)
        out.append(rows)
        return rows

    def pipelined(imgs, te, resume, state):
        raise AssertionError("the evaluator must take the pipelined path")

    pipelined.dispatch = predict.dispatch
    pipelined.materialize = materialize
    return pipelined


def _jax_predict(jm, variables):
    P, hidden = EXP.num_proposals, int(256 * EXP.width)

    @jax.jit
    def step(v, x, te, st):
        out = jm.apply(v, x, te, L, G, False, st)
        refined, _ = jpost(out, L, EXP.num_classes, nms_thresh=EXP.nmsthre,
                           conf_thre=EXP.test_conf)
        return refined, out["matcher_state"]

    fresh = jinit(P, hidden, 4 * hidden)

    def dispatch(imgs, te, resume, state):
        st = state if (resume and state is not None) else fresh
        return step(variables, jnp.asarray(imgs), jnp.asarray(te, jnp.float32), st)

    def materialize(refined):
        r = jax.tree_util.tree_map(np.asarray, refined)
        return [np.concatenate([r.boxes[f], r.obj[f][:, None], r.score[f][:, None],
                                r.cls_id[f][:, None].astype(np.float32)], -1)[r.mask[f]]
                for f in range(L)]

    def predict(imgs, te, resume, state):
        raise AssertionError("the evaluator must take the pipelined path")

    predict.dispatch = dispatch
    predict.materialize = materialize
    return predict


@pytest.fixture(scope="module")
def evaluated():
    """Both evaluators over the whole fixture (16 windows, 2 videos);
    returns (port result, port rows, JAX result, JAX rows, port model)."""
    port = EXP.get_model(device="cpu")
    jm = JTSCD(num_classes=EXP.num_classes, depth=EXP.depth, width=EXP.width,
               num_proposals=EXP.num_proposals, minimal_limit=EXP.minimal_limit,
               heads=EXP.heads)
    H, W = EXP.test_size
    variables = carry(jm, port, jnp.zeros((L + G, H, W, 3), jnp.float32),
                      jnp.zeros((L + G, 256), jnp.float32), L, G, False)
    prows, jrows = [], []
    # the global frames of each window come from the `random` module,
    # seeded from the exp as the CLI seeds it
    random.seed(EXP.seed)
    pres = EXP.get_evaluator().evaluate(
        _recording(make_predict_fn(port, L, G, EXP.nmsthre, EXP.test_conf), prows),
        log=lambda *a: None)
    random.seed(EXP.seed)
    jds = JVIDDataset(EXP.val_seq_path, img_size=EXP.test_size, lframe=L,
                      gframe=G, val=True, mode=EXP.mode, dataset_pth=FIXTURE,
                      formal=True)
    jev = JVIDEvaluator(JWindowLoader(jds, shuffle=False, max_labels=120,
                                      img_dtype=np.uint8),
                        img_size=EXP.test_size, confthre=EXP.test_conf,
                        nmsthre=EXP.nmsthre, num_classes=EXP.num_classes,
                        lframe=L, gframe=G)
    jres = jev.evaluate(_recording(_jax_predict(jm, variables), jrows),
                        log=lambda *a: None)
    return pres, prows, jres, jrows, port


def test_evaluator_matches_jax_on_the_fixture(evaluated):
    pres, prows, jres, jrows, _ = evaluated
    assert len(prows) == len(jrows) == 16
    n = 0
    for w, (pw, jw) in enumerate(zip(prows, jrows)):
        assert len(pw) == len(jw) == L
        for got, want in zip(pw, jw):
            assert got.shape == want.shape, f"window {w}"
            assert np.array_equal(got[:, 6], want[:, 6]), f"window {w}"
            np.testing.assert_allclose(got[:, :6], want[:, :6], atol=1e-4,
                                       rtol=1e-4, err_msg=f"window {w}")
            n += len(got)
    assert n > 0
    assert set(pres) == set(jres)
    np.testing.assert_allclose(pres["stats"], jres["stats"], atol=1e-4)
    for k in ("per_class_AP50", "per_class_AP", "per_class_AR"):
        assert pres[k].keys() == jres[k].keys()
        np.testing.assert_allclose(list(pres[k].values()), list(jres[k].values()),
                                   atol=1e-2)       # percent: 1e-4 of the stats
    assert pres["ms_per_frame"] > 0


def test_eval_cli_writes_the_in_process_result(evaluated, tmp_path):
    """`python -m tscd_torch.tools.tscd_eval` on the fixture's first 6
    windows with a saved port checkpoint writes the result that the same
    arguments give in process (the time per frame aside)."""
    from tscd_torch.tools import tscd_eval
    port = evaluated[-1]
    ckpt, out = tmp_path / "port.pth", tmp_path / "result.json"
    torch.save(port.state_dict(), ckpt)
    args = ["--exp", "selftest", "-c", str(ckpt), "--device", "cpu", "--tnum", "6"]
    opts = ["data_dir", FIXTURE, "val_seq_path", EXP.val_seq_path]
    r = subprocess.run(
        [sys.executable, "-m", "tscd_torch.tools.tscd_eval", *args, "--output", str(out),
         *opts], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mAP 0.5:0.95" in r.stdout
    got = json.loads(out.read_text())
    want = json.loads(json.dumps(tscd_eval.main([*args, *opts])))
    assert got.pop("ms_per_frame") > 0
    want.pop("ms_per_frame")
    assert _same(got, want) and len(got["stats"]) == 12


def test_eval_cli_reads_a_jax_msgpack_checkpoint():
    """The committed converted_ckpt.msgpack (JAX variables of the weights of
    ref_random.pth), read without flax, evaluates to what ref_random.pth
    does."""
    from tscd_torch.tools import tscd_eval
    ref = os.path.join(REPO, "YOLOX_outputs", "validate_ref")
    opts = ["data_dir", FIXTURE, "val_seq_path", EXP.val_seq_path]
    res = {c: tscd_eval.main(["--exp", "selftest", "-c", os.path.join(ref, c), "--device",
                              "cpu", "--tnum", "6", *opts])
           for c in ("converted_ckpt.msgpack", "ref_random.pth")}
    for r in res.values():
        r.pop("ms_per_frame")
    assert _same(res["converted_ckpt.msgpack"], res["ref_random.pth"])
    assert len(res["ref_random.pth"]["stats"]) == 12


def test_get_exp_by_file_name_and_merge(tmp_path):
    """Port exp files subclass the port's TSCDExp; overrides keep each
    attribute's type (tscd_tpu/exp/base_exp.py:25)."""
    from tscd_torch.exp import TSCDExp, get_exp
    f = tmp_path / "my_exp.py"
    f.write_text("from tscd_torch.exp import TSCDExp\n\n"
                 "class Exp(TSCDExp):\n"
                 "    def __init__(self):\n"
                 "        super().__init__()\n"
                 "        self.gframe_val = 15\n")
    exp = get_exp(str(f)).merge(["tnum", "4", "--test_conf", "0.01", "mode", "uniform",
                                 "test_size", "(320, 320)"])
    assert isinstance(exp, TSCDExp) and exp.gframe_val == 15
    assert (exp.tnum, exp.test_conf, exp.mode, exp.test_size) == (4, 0.01, "uniform", (320, 320))
    assert type(exp.tnum) is int and exp.num_proposals == 50
    assert get_exp(exp_name="tscd_large").depth == 1.0
    assert get_exp(exp_name="selftest").test_size == (128, 128)
    with pytest.raises(AttributeError):
        exp.merge(["no_such_knob", "1"])
    with pytest.raises(ValueError):
        get_exp(exp_name="vid_yolox")
    bad = tmp_path / "bad_exp.py"
    bad.write_text("class Exp:\n    pass\n")
    with pytest.raises(TypeError):
        get_exp(str(bad))
    assert get_exp(exp_name="selftest").merge(["traj_linking", "True"]).get_evaluator(
        val_loader=iter(())).traj_linking is True
