"""The port's YOLOV family (MSA aggregation, heads, models, exps, eval)
against the JAX package on the CPU, at the size of tests/test_yolov.py
(depth 0.33, width 0.125, 64 px, P = 8, 4 frames, 2 heads), on inputs and
weights made from numpy seeds (JAX's parameter trees carried across by
utils.convert):

  - DualBranchAttention's joint-projection form (cross=False) and
    MSAYolov, reconf on and off, some keys invalid: every output 1e-4;
  - YOLOVHead and YOLOVPlusHead ("msa" and "mca", decouple_reg on and
    off, lframe 0 and 2) on seeded FPN maps: proposals exactly (anchor
    ids, validity), every other output 1e-4 relative; YOLOVHead with the
    pre-NMS (its default) and without, reconf on and off;
  - the YOLOV model: every output, then yolov_eval_postprocess's
    `refined` and `original` (masks and classes exactly, 1e-4);
  - the YOLOV-L exp's evaluation at lframe 0 through the port's vid_eval
    CLI on the committed VID fixture (yolov_selftest, a JAX msgpack):
    every window's detections (classes exactly, boxes 1e-4 of the largest
    coordinate, scores 1e-4) and the COCO stats against JAX's predict
    function and VIDEvaluator on the same windows;
  - every built-in YOLOV exp constructs its model (the knobs JAX's exp
    does not pass raise off the model's value), and each exp's attributes
    equal those of its file in exps/; a JAX parameter tree of YOLOV and of
    YOLOV++ (msa, mca) round-trips through utils.convert, every key
    loaded with none left over.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from tscd_tpu.data.vid import VIDDataset as JVIDDataset
from tscd_tpu.data.vid import WindowLoader as JWindowLoader
from tscd_tpu.eval.vid_evaluator import VIDEvaluator as JVIDEvaluator
from tscd_tpu.exp.build import get_exp_by_file as jget_exp_by_file
from tscd_tpu.models import aggregation as jagg
from tscd_tpu.models import yolov_heads as jyh
from tscd_tpu.models.yolov import YOLOV as JYOLOV
from tscd_tpu.models.yolov import YOLOVPlus as JYOLOVPlus
from tscd_tpu.models.yolov import yolov_eval_postprocess as jpost
from tscd_torch.exp import get_exp_by_name
from tscd_torch.exp.yolov_base import YOLOV_EXPS, yolov_model_knobs
from tscd_torch.models import aggregation as pagg
from tscd_torch.models import yolov_heads as pyh
from tscd_torch.models.yolov import yolov_eval_postprocess
from tscd_torch.utils.convert import flatten_tree, flax_from_state_dict, state_dict_from_flax
from torch_port_util import seeded_variables

T = torch.as_tensor
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, P, WIDTH, F, HEADS = 5, 8, 0.125, 4, 2
FPN = [(8, 8, 32), (4, 4, 64), (2, 2, 128)]     # 64 px, width 0.125


def close(got, want, tol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=tol * max(1.0, float(np.abs(want).max(initial=0))),
                               rtol=tol, err_msg=msg)


def _fpn(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(F,) + s).astype(np.float32) for s in FPN]


def _load(pm, variables):
    """JAX's variables into the port module, every key taken."""
    sd = state_dict_from_flax(variables, pm.state_dict())
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    return pm


def _compare(jout, out, tol=1e-4):
    jp, pp = jout["proposals"], out["proposals"]
    for name in ("idx", "valid", "cls_id"):
        assert np.array_equal(np.asarray(getattr(jp, name)), getattr(pp, name).numpy()), name
    for name in ("boxes", "obj", "cls_conf", "cls_scores"):
        close(getattr(pp, name), getattr(jp, name), msg=name)
    keys = {k for k in jout if k != "hw"}
    assert {k for k in out if k not in ("hw", "batch_stats")} == keys
    for k in sorted(keys - {"proposals"}):
        close(out[k].detach(), jout[k], tol, msg=k)


# -- (a) the attention in its self-attention form ---------------------------

@pytest.mark.parametrize("reconf", [False, True])
def test_msa_yolov_and_joint_attention_match_jax(reconf):
    """MSAYolov (and through it DualBranchAttention(cross=False)) on N = 32
    proposals with 8 invalid keys, 1e-4; the attention's own pieces
    (out_cls, out_reg, the round-2 weights) too."""
    rng = np.random.default_rng(3)
    N, Cd = 32, 32
    x_cls, x_reg = (rng.normal(size=(N, Cd)).astype(np.float32) for _ in range(2))
    cs, fs = (rng.uniform(0.05, 1.0, N).astype(np.float32) for _ in range(2))
    valid = np.ones(N, bool)
    valid[rng.choice(N, 8, replace=False)] = False
    args = [jnp.asarray(a) for a in (x_cls, x_reg, cs, fs, valid)]
    # sim_thresh low enough that round 2 pools (random features are far apart)
    kw = dict(sim_thresh=0.05, conf_sim_thresh=0.1)
    jm = jagg.MSAYolov(4 * Cd, HEADS, reconf=reconf)
    variables = seeded_variables(jm, 1, *args)
    pm = _load(pagg.MSAYolov(Cd, 4 * Cd, HEADS, reconf=reconf), variables)
    jout = jm.apply(variables, *args, **kw)
    with torch.no_grad():
        out = pm(*(T(a) for a in (x_cls, x_reg, cs, fs, valid)), **kw)
    close(out[0], jout[0], msg="cls")
    assert (out[1] is None) == (not reconf)
    if reconf:
        close(out[1], jout[1], msg="obj")
    jatt = jagg.DualBranchAttention(HEADS, cross=False)
    jp = jatt.apply({"params": variables["params"]["msa"]}, *args, N, **kw)
    with torch.no_grad():
        pp = pm.msa.attend(*(T(a)[None] for a in (x_cls, x_reg, cs, fs, valid)), N, **kw)
    for name in ("out_cls", "out_reg", "sim_round2", "obj_round2", "v_cls"):
        close(getattr(pp, name)[0], getattr(jp, name), msg=name)
    assert float(np.asarray(jp.sim_round2).max()) > 0.0


# -- (b, c) the heads ---------------------------------------------------------

HEAD_CASES = {
    "yolov": ("v", 0, {}),
    "yolov_reconf_no_pre_nms": ("v", 0, dict(reconf=True, use_pre_nms=False)),
    "plus_msa_decouple_L0": ("p", 0, dict(agg_type="msa")),
    "plus_msa_L0": ("p", 0, dict(agg_type="msa", decouple_reg=False)),
    "plus_msa_decouple_L2": ("p", 2, dict(agg_type="msa")),
    "plus_msa_L2": ("p", 2, dict(agg_type="msa", decouple_reg=False)),
    "plus_mca_decouple_L0": ("p", 0, dict(agg_type="mca")),
    "plus_mca_L0": ("p", 0, dict(agg_type="mca", decouple_reg=False)),
    "plus_mca_decouple_L2": ("p", 2, dict(agg_type="mca")),
    "plus_mca_L2": ("p", 2, dict(agg_type="mca", decouple_reg=False)),
}


def head_pair(kind, L, knobs, seed=0):
    """JAX's and the port's head with `knobs`, on the same seeded weights."""
    xin = _fpn(seed)
    if kind == "v":
        jm = jyh.YOLOVHead(num_classes=C, width=WIDTH, heads=HEADS, num_proposals=P, **knobs)
        pm = pyh.YOLOVHead(C, width=WIDTH, heads=HEADS, num_proposals=P, **knobs)
    else:
        jm = jyh.YOLOVPlusHead(num_classes=C, width=WIDTH, heads=HEADS, num_proposals=P,
                               **knobs)
        pm = pyh.YOLOVPlusHead(C, width=WIDTH, heads=HEADS, num_proposals=P, **knobs)
    variables = seeded_variables(jm, seed, [jnp.asarray(x) for x in xin], L, F - L)
    return jm, variables, _load(pm.eval(), variables), xin


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_yolov_heads_match_jax(case):
    kind, L, knobs = HEAD_CASES[case]
    jm, variables, pm, xin = head_pair(kind, L, knobs)
    jout = jax.jit(lambda v, xs: jm.apply(v, xs, L, F - L))(
        variables, [jnp.asarray(x) for x in xin])
    with torch.no_grad():
        out = pm([T(x).permute(0, 3, 1, 2) for x in xin], L, F - L)
    _compare(jout, out)
    R = F if (kind == "v" or L == 0) else L
    assert out["refined_cls_logits"].shape == (R, P, C)
    has_obj = knobs.get("reconf", kind == "p") and (
        knobs.get("agg_type") != "mca" or knobs.get("decouple_reg", True))
    assert ("refined_obj_logits" in out) == bool(has_obj)


# -- (b) the YOLOV model and its postprocess ----------------------------------

@pytest.fixture(scope="module")
def yolov_model():
    """JAX's YOLOV and the port's at the yolov_selftest exp's size (30
    classes, P = 8, 2 heads), one seeded parameter tree, and JAX's jitted
    window: the head's outputs and both postprocess results."""
    exp = get_exp_by_name("yolov_selftest")
    G = exp.gframe_val
    jm = JYOLOV(num_classes=exp.num_classes, depth=exp.depth, width=exp.width,
                num_proposals=exp.num_proposals, heads=exp.heads)
    variables = seeded_variables(jm, 4, jnp.zeros((G, 64, 64, 3)), 0, G)
    pm = _load(exp.get_model(device="cpu"), variables)

    @jax.jit
    def window(v, x):
        out = jm.apply(v, x, 0, G)
        return out, jpost(out, G, exp.num_classes, exp.nmsthre, exp.test_conf)
    return exp, jm, variables, pm, window


def test_yolov_model_and_postprocess_match_jax(yolov_model):
    exp, _, variables, pm, window = yolov_model
    G = exp.gframe_val
    x = np.random.default_rng(5).uniform(0, 255, (G, 64, 64, 3)).astype(np.float32)
    jout, (jref, jori) = window(variables, jnp.asarray(x))
    with torch.no_grad():
        out = pm(T(x), 0, G)
    _compare(jout, out)
    ref, ori = yolov_eval_postprocess(out, G, exp.num_classes, exp.nmsthre, exp.test_conf)
    for got, want in ((ref, jref), (ori, jori)):
        assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
        assert np.array_equal(got.cls_id.numpy(), np.asarray(want.cls_id))
        for name in ("boxes", "obj", "score"):
            close(getattr(got, name), getattr(want, name), msg=name)
    assert int(ref.mask.sum()) > 0
    assert yolov_eval_postprocess(out, G, exp.num_classes, original=False)[1] is None


# -- (g) the evaluator at lframe 0 through vid_eval -----------------------------

def _recording_pipelined(predict, out):
    def materialize(dev):
        rows = predict.materialize(dev)
        out.append(rows)
        return rows

    def pipelined(*args):
        raise AssertionError("the evaluator must take the pipelined path")
    pipelined.dispatch = predict.dispatch
    pipelined.materialize = materialize
    return pipelined


def test_vid_eval_cli_at_lframe_0_matches_jax(yolov_model, tmp_path, monkeypatch):
    """vid_eval on yolov_selftest (0 + 4 frame windows of the 2 fixture
    videos, every frame refined and evaluated) from a JAX msgpack: each
    window's rows (classes exactly, the rest 1e-4) and the COCO stats
    (1e-4) equal JAX's predict function (yolov_trainer.py:68-111) through
    JAX's VIDEvaluator."""
    from tscd_torch.core import yolov_trainer
    from tscd_torch.tools import vid_eval
    exp, _, variables, _, window = yolov_model
    G = exp.gframe_val
    ckpt = tmp_path / "yolov_selftest.msgpack"
    ckpt.write_bytes(serialization.msgpack_serialize(variables))
    prows = []
    real = yolov_trainer.make_predict_fn
    monkeypatch.setattr(yolov_trainer, "make_predict_fn",
                        lambda *a, **k: _recording_pipelined(real(*a, **k), prows))
    got = vid_eval.main(["--exp", "yolov_selftest", "-c", str(ckpt), "--device", "cpu",
                         "--output", str(tmp_path / "res.json")])
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        vid_eval.main(["--exp", "yolov_selftest", "-c", str(ckpt), "--int8"])

    jrows = []

    def jpredict(imgs, te, resume, state):
        _, (refined, _) = window(variables, jnp.asarray(imgs, jnp.float32))
        r = jax.tree_util.tree_map(np.asarray, refined)
        rows = [np.concatenate([r.boxes[f], r.obj[f][:, None], r.score[f][:, None],
                                r.cls_id[f][:, None].astype(np.float32)], -1)[r.mask[f]]
                for f in range(G)]
        jrows.append(rows)
        return rows, state

    random.seed(exp.seed)
    jds = JVIDDataset(exp.val_seq_path, img_size=exp.test_size, lframe=0, gframe=G, val=True,
                      mode=exp.mode, dataset_pth=exp.data_dir, formal=True)
    want = JVIDEvaluator(JWindowLoader(jds, shuffle=False, max_labels=120, img_dtype=np.uint8),
                         img_size=exp.test_size, confthre=exp.test_conf, nmsthre=exp.nmsthre,
                         num_classes=exp.num_classes, lframe=0, gframe=G
                         ).evaluate(jpredict, log=lambda *a: None)
    assert len(prows) == len(jrows) == 4
    n = 0
    for pw, jw in zip(prows, jrows):
        assert len(pw) == len(jw) == G
        for g, w in zip(pw, jw):
            assert g.shape == w.shape and np.array_equal(g[:, 6], w[:, 6])
            # boxes 1e-4 of the window's largest coordinate: the seeded
            # detector's boxes reach 1e3 px, and x1 = cx - w / 2 cancels
            close(g[:, :4], w[:, :4])
            np.testing.assert_allclose(g[:, 4:6], w[:, 4:6], rtol=1e-4, atol=1e-4)
            n += len(g)
    assert n > 0
    np.testing.assert_allclose(got["stats"], want["stats"], atol=1e-4)


# -- (h) the exps and the weights carried across -----------------------------

JAX_EXP_FILES = {
    "yolov_l": "exps/yolov/yolov_l.py", "yolov_s": "exps/yolov/yolov_s.py",
    "v++_base": "exps/yolov++/v++_base.py",
    "v++_base_decoupleReg": "exps/yolov++/v++_base_decoupleReg.py",
    "v++_base_decoupleReg_2x": "exps/yolov++/v++_base_decoupleReg_2x.py",
    "v++_large": "exps/yolov++/v++_large.py",
    "yolovl_ovis_75_75_750": "exps/yolov_ovis/yolovl_ovis_75_75_750.py",
    "yolovs_ovis_75_75_750": "exps/yolov_ovis/yolovs_ovis_75_75_750.py",
    "v_plus_base": "exps/ovis_yolov_plus/v_plus_base.py",
    "ovis_v++_base_decoupleReg": "exps/ovis_yolov_plus/ovis_v++_base_decoupleReg.py",
    "ovis_v++_large_decoupleReg": "exps/ovis_yolov_plus/ovis_v++_large_decoupleReg.py",
}
# the attributes that decide the model and the windows
EXP_ATTRS = ("model_family", "depth", "width", "num_classes", "heads", "reconf",
             "decouple_reg", "agg_type", "sim_thresh", "conf_sim_thresh", "lframe", "gframe",
             "lframe_val", "gframe_val", "dataset_name", "input_size", "test_size",
             "max_epoch", "warmup_epochs", "no_aug_epochs", "basic_lr_per_img",
             "stem_lr_ratio", "nmsthre", "test_conf", "seed", "exp_name", "ota_mode",
             "cat_ota_fg", "ovis_train_json", "ovis_val_json", "data_dir")


def test_every_builtin_yolov_exp_constructs_as_its_jax_file():
    """Each built-in against exps/'s file (EXP_ATTRS and the slot count P
    of yolov_base.py:33-35); its model builds (full width, the port's
    family and P) with the knobs JAX passes; `use_pre_nms`, which JAX's
    get_model does not pass, is the model's own (None) and raises at the
    other family's value, as every knob in yolov_model_knobs."""
    assert set(JAX_EXP_FILES) == set(YOLOV_EXPS) - {"yolov_selftest"}
    for name, path in sorted(JAX_EXP_FILES.items()):
        jexp = jget_exp_by_file(os.path.join(REPO, path))
        exp = get_exp_by_name(name)
        for a in EXP_ATTRS:
            want = getattr(jexp, a)
            if a == "data_dir" and exp.dataset_name == "vid":
                continue           # the port's VID exps keep the TSCD exp's data_dir
            assert getattr(exp, a) == (tuple(want) if isinstance(want, list) else want), \
                (name, a)
        assert exp.num_proposals == (jexp.maximal_limit or jexp.minimal_limit
                                     or jexp.defualt_p), name
        assert exp.use_pre_nms is None or exp.use_pre_nms == (exp.model_family == "yolov")
        model = exp.get_model(device="cpu")
        assert type(model).__name__ == {"yolov": "YOLOV", "yolov_plus": "YOLOVPlus"}[
            exp.model_family]
        assert model.head.num_proposals == exp.num_proposals
        if exp.model_family == "yolov_plus":
            assert model.head.agg_type == exp.agg_type
            assert model.head.use_pre_nms is False
        else:
            assert model.head.use_pre_nms is True
        del model
        for knob, (values, _) in yolov_model_knobs(exp.model_family).items():
            other = {None: "x", True: False, False: True}.get(values[-1], "x")
            bad = get_exp_by_name(name)
            setattr(bad, knob, other if not isinstance(values[-1], float) else 0.5)
            with pytest.raises(NotImplementedError, match=knob):
                bad.get_model(device="cpu")


def _round_trip(jm, pm, *init_args):
    """A JAX parameter tree (seeded) into the port's model and back:
    every leaf of the tree taken, and the tree rebuilt exactly."""
    variables = seeded_variables(jm, 6, *init_args)
    pm = _load(pm, variables)
    back = flax_from_state_dict(pm.state_dict())
    for c in ("params", "batch_stats"):
        want = flatten_tree(variables.get(c, {}))
        got = flatten_tree(back[c])
        assert set(got) == set(want), (c, sorted(set(got) ^ set(want))[:6])
        for k in want:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("family", ["yolov", "plus_msa", "plus_mca"])
def test_jax_parameter_tree_round_trips(family):
    x = jnp.zeros((F, 64, 64, 3))
    exp = get_exp_by_name("yolov_selftest")
    if family == "yolov":
        jm = JYOLOV(num_classes=C, depth=0.33, width=WIDTH, num_proposals=P, heads=HEADS,
                    reconf=True)
        exp.reconf = True
        args = (x, 0, F)
    else:
        agg = family.split("_")[1]
        jm = JYOLOVPlus(num_classes=C, depth=0.33, width=WIDTH, num_proposals=P,
                        heads=HEADS, agg_type=agg)
        exp.model_family, exp.agg_type, exp.reconf, exp.decouple_reg = "yolov_plus", agg, \
            True, True
        args = (x, 2, F - 2, jnp.zeros((F, 256)))
    exp.num_classes = C
    _round_trip(jm, exp.get_model(device="cpu"), *args)
