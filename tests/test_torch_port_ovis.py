"""The port's OVIS recipe against the JAX package on the CPU, on the
committed OVIS-format fixture (tscd_torch/data/fixtures/ovis over the 32
frames of fixtures/vid; tests/torch_port_ovis_fixture.py writes it):

  - OVISVideoDataset and ArgoverseVideoDataset equal to JAX's: the windows
    (training windows of 4 + 12 frames, whose second video of 12 frames is
    padded with its last frame, and eval windows of 8 + 24), and the
    collated windows' frames, labels, time embeddings and paths, exactly;
  - `tscd_eval --dataset ovis` on the selftest-size OVIS exp (25 classes,
    2 + 6 frame windows) from a JAX msgpack: every window's detections
    (classes exactly, boxes and scores 1e-4) and the COCO stats (1e-4)
    equal to JAX's OVISEvaluator's with JAX's model on the same weights;
  - stage 1 to stage 2: a YOLOX checkpoint (a port `.pth`, and the JAX
    msgpack of the same weights) loads into TSCD taking exactly the
    tensors JAX's load_tolerant takes;
  - the recipe end to end through the port's CLIs: `train` (stage 1, an
    epoch with mosaic and mixup), `tscd_train -c <stage 1>`, `tscd_eval
    --dataset ovis`; dataset_name "ovis" no longer raises.
"""

import os
import random
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from tscd_tpu.data import vid as jvid
from tscd_tpu.eval.vid_evaluator import OVISEvaluator as JOVISEvaluator
from tscd_tpu.models.matching import init_matcher_state as jinit
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.models.tscd import tscd_eval_postprocess as jpost
from tscd_tpu.models.yolox import YOLOX as JYOLOX
from tscd_tpu.train.checkpoint import load_tolerant as jload_tolerant
from tscd_torch.data import vid as pvid
from tscd_torch.exp.ovis_tscd_base import OVISSelftestExp
from tscd_torch.models.yolox import YOLOX
from tscd_torch.train.checkpoint import load_checkpoint, load_tolerant
from tscd_torch.utils.convert import _BN_LEAVES, flax_module_path, flax_param_path
from tscd_torch.utils.convert import state_dict_from_flax
from torch_port_util import perturb, seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tscd_torch", "data", "fixtures")
VID, NAME = os.path.join(FIX, "vid"), "Data/VID/val"
TRAIN_JSON = os.path.join(FIX, "ovis", "annotations_train.json")
VAL_JSON = os.path.join(FIX, "ovis", "annotations_valid.json")
PATHS = ["data_dir", VID, "ovis_train_json", TRAIN_JSON, "ovis_val_json", VAL_JSON]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind,val", [("OVISVideoDataset", False), ("OVISVideoDataset", True),
                                      ("ArgoverseVideoDataset", False)])
def test_video_windows_equal_jax(kind, val):
    L, G = (8, 24) if val else (4, 12)
    kw = dict(json_path=VAL_JSON if val else TRAIN_JSON, data_dir=VID, name=NAME,
              img_size=(128, 128), lframe=L, gframe=G, val=val, training=not val)
    random.seed(7)
    want = getattr(jvid, kind)(**kw)
    random.seed(7)
    got = getattr(pvid, kind)(**kw)
    # val: 32 // 8 windows; train: 20 // 4 + 16 // 4
    assert got.res == want.res and len(got.res) == (4 if val else 9)
    if not val:       # the 12-frame video, padded to 16 with its last frame
        assert any(w.count("fix0/000031.JPEG") == 5 for w in got.res)
    with ThreadPoolExecutor(4) as pool:
        for paths in got.res[:2]:
            for train in (False, True):
                opts = dict(train_time_index=train, cxcywh=train)
                g = pvid.collate_window(got, paths, pool, **opts)
                w = jvid.collate_window(want, paths, img_dtype=np.uint8, **opts)
                for k in ("imgs", "labels", "time_embedding"):
                    assert np.array_equal(g[k], w[k]), k
                assert g["paths"] == w["paths"] and g["infos"] == w["infos"]
                assert (g["labels"].sum(-1) > 0).sum() > 0


def _jmodel(exp):
    return JTSCD(num_classes=exp.num_classes, depth=exp.depth, width=exp.width,
                 num_proposals=exp.num_proposals, minimal_limit=exp.minimal_limit,
                 heads=exp.heads)


def _jax_predict(jm, variables, exp):
    L, G = exp.lframe_val, exp.gframe_val
    P, hidden = exp.num_proposals, int(256 * exp.width)

    @jax.jit
    def step(v, x, te, st):
        out = jm.apply(v, x, te, L, G, False, st)
        refined, _ = jpost(out, L, exp.num_classes, nms_thresh=exp.nmsthre,
                           conf_thre=exp.test_conf)
        return refined, out["matcher_state"]

    fresh = jinit(P, hidden, 4 * hidden)

    def predict(imgs, te, resume, state):
        st = state if (resume and state is not None) else fresh
        refined, st = step(variables, jnp.asarray(imgs, jnp.float32),
                           jnp.asarray(te, jnp.float32), st)
        r = jax.tree_util.tree_map(np.asarray, refined)
        rows = [np.concatenate([r.boxes[f], r.obj[f][:, None], r.score[f][:, None],
                                r.cls_id[f][:, None].astype(np.float32)], -1)[r.mask[f]]
                for f in range(L)]
        return rows, st
    return predict


def _recording(predict, out):
    """A JAX predict function, its rows appended to `out`."""
    def rec(*args):
        rows, st = predict(*args)
        out.append(rows)
        return rows, st
    return rec


def _recording_pipelined(predict, out):
    """The port's predict function (dispatch, materialize), its
    materialized rows appended to `out`."""
    def materialize(dev):
        rows = predict.materialize(dev)
        out.append(rows)
        return rows

    def pipelined(*args):
        raise AssertionError("the evaluator must take the pipelined path")
    pipelined.dispatch = predict.dispatch
    pipelined.materialize = materialize
    return pipelined


def test_tscd_eval_cli_on_ovis_matches_jax(tmp_path, monkeypatch):
    from tscd_torch.core import predict as ppredict
    from tscd_torch.tools import tscd_eval
    exp = OVISSelftestExp()
    jm = _jmodel(exp)
    F = exp.lframe_val + exp.gframe_val
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((F, 128, 128, 3)), jnp.zeros((F, 256)),
                                       exp.lframe_val, exp.gframe_val, False))
    variables = perturb(init(jax.random.PRNGKey(0)))
    ckpt = tmp_path / "ovis_selftest.msgpack"
    ckpt.write_bytes(serialization.msgpack_serialize(variables))
    prows = []
    real = ppredict.make_predict_fn

    def recording_predict(*a, **k):        # the CLI's predict, its rows kept
        return _recording_pipelined(real(*a, **k), prows)
    monkeypatch.setattr(ppredict, "make_predict_fn", recording_predict)
    got = tscd_eval.main(["--exp", "ovis_selftest", "--dataset", "ovis", "-c", str(ckpt),
                          "--device", "cpu", *PATHS])
    random.seed(exp.seed)
    ds = jvid.OVISVideoDataset(VAL_JSON, VID, NAME, (128, 128), exp.lframe_val,
                               exp.gframe_val, val=True, mode=exp.mode)
    jrows = []
    want = JOVISEvaluator(jvid.WindowLoader(ds, max_labels=120, img_dtype=np.uint8),
                          img_size=(128, 128), confthre=exp.test_conf, nmsthre=exp.nmsthre,
                          num_classes=25, lframe=exp.lframe_val, gframe=exp.gframe_val
                          ).evaluate(_recording(_jax_predict(jm, variables, exp), jrows),
                                     log=lambda *a: None)
    assert len(prows) == len(jrows) == 16
    n = 0
    for pw, jw in zip(prows, jrows):
        for g, w in zip(pw, jw):
            assert g.shape == w.shape and np.array_equal(g[:, 6], w[:, 6])
            np.testing.assert_allclose(g[:, :6], w[:, :6], rtol=1e-4, atol=1e-4)
            n += len(g)
    assert n > 0
    np.testing.assert_allclose(got["stats"], want["stats"], atol=1e-4)
    assert abs(got["AP50"] - want["AP50"]) <= 1e-4


def _flax_key(name, ndim):
    """A port state_dict key's (collection, flax path) (None for
    num_batches_tracked, which flax has not)."""
    leaf = name.split(".")[-1]
    if leaf == "num_batches_tracked":
        return None
    path = flax_module_path(name)
    if path and path[-1] == "bn":
        c, key = _BN_LEAVES[leaf]
        return c, path + (key,)
    return "params", flax_param_path(name, ndim)


def test_stage1_checkpoint_loads_into_tscd_as_jax(tmp_path):
    exp = OVISSelftestExp()
    jy = JYOLOX(num_classes=25, depth=exp.depth, width=exp.width)
    yvars = seeded_variables(jy, 1, jnp.zeros((1, 128, 128, 3)), False, False)
    F = 4
    tvars = seeded_variables(_jmodel(exp), 2, jnp.zeros((F, 128, 128, 3)), jnp.zeros((F, 256)),
                             2, 2, False)
    taken_jax = set()
    for c in ("params", "batch_stats"):
        skipped = []
        jload_tolerant(tvars[c], yvars[c], log=skipped.append)
        for k in traverse_util.flatten_dict(tvars[c]):
            if not any(s.startswith("/".join(k) + " ") for s in skipped):
                taken_jax.add((c, k))
    heads = {k[1] for c, k in taken_jax if k[0] == "head"}
    assert "stem_0" in heads and "cls_pred_2" in heads and "cls_conv2_0_0" not in heads

    ym = YOLOX(25, exp.depth, exp.width, device="cpu")
    ysd = state_dict_from_flax(yvars, ym.state_dict())
    ym.load_state_dict(ysd)
    pth, msg = tmp_path / "stage1.pth", tmp_path / "stage1.msgpack"
    torch.save({"model": ym.state_dict()}, pth)
    msg.write_bytes(serialization.msgpack_serialize(yvars))
    model = exp.get_model(device="cpu")
    tmpl = model.state_dict()
    for path in (pth, msg):
        skipped = []
        loaded = load_tolerant(tmpl, load_checkpoint(str(path), model)["model"],
                               log=skipped.append)
        taken = {_flax_key(k, v.dim()) for k, v in tmpl.items()
                 if not any(s.startswith(k + " ") for s in skipped)} - {None}
        assert taken == taken_jax, path
        for k, v in loaded.items():      # taken from stage 1, else the TSCD's own
            key = _flax_key(k, v.dim())
            if key in taken_jax:
                assert torch.equal(v, ysd[k]), k
            elif key is not None:
                assert torch.equal(v, tmpl[k]), k


def test_ovis_recipe_runs_through_the_clis(tmp_path):
    """Stage 1 with the still-image train CLI, stage 2 from its
    checkpoint, then the OVIS eval, on the fixture at the selftest size."""
    from tscd_torch.tools import train, tscd_eval, tscd_train
    out = str(tmp_path / "out")
    still = ["data_dir", FIX, "output_dir", out, "max_epoch", "1", "no_aug_epochs", "0"]
    state = train.main(["--exp", "ovis_still_selftest", "--device", "cpu", *still])
    assert state.step == 8
    stage1 = os.path.join(out, "ovis_still_selftest", "latest_ckpt.pth")
    video = [*PATHS, "output_dir", out, "max_epoch", "1", "warmup_epochs", "0",
             "no_aug_epochs", "0"]
    st2 = tscd_train.main(["--exp", "ovis_selftest", "--device", "cpu", "-c", stage1, *video])
    assert st2.step == 16
    sd1 = torch.load(stage1, weights_only=True)["model"]
    # stage 2 started from stage 1: the frozen backbone is stage 1's EMA weights
    for k, v in st2.model.state_dict().items():
        if k.startswith("backbone") and v.is_floating_point() and "running" not in k:
            assert torch.equal(v, sd1[k]), k
    res = tscd_eval.main(["--exp", "ovis_selftest", "--dataset", "ovis", "-c",
                          os.path.join(out, "ovis_selftest", "latest_ckpt.pth"),
                          "--device", "cpu", *PATHS])
    assert len(res.get("stats", [0] * 12)) == 12 and "AP50" in res
