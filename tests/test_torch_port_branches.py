"""The TSCD head's other branches in the port against the JAX package on
the CPU, at the selftest width (width 0.125, P = 6, 1 + 3 frames, FPN
levels of a 128 px frame), on inputs made from numpy seeds:

  - the head's outputs with each knob off JAX's default (`mca_aware`,
    `reconf` off, `decouple_reg` off, `ave` off, `use_mask`, `vid_cls` /
    `vid_reg` off, `use_pre_nms`): proposals (anchor
    ids, validity, class ids) exact, every other output 1e-4 relative,
    the same set of outputs (no matcher_* or refined_boxes without the
    matcher's heads) and the eval postprocess on them; the head with
    `cat_ota_fg` and labels: SimOTA's targets and the injected proposals;
  - proposal selection alone on seeded decoded rows (750 of 900 anchors
    through the pre-NMS at 0.75 and 0.3, boxes in clusters so that it
    suppresses; SimOTA's fg ranked first), index for index with eager JAX;
  - CosineMHAttention's box-position bias (1e-5);
  - the Focus stem with ksize 5 and with act relu / lrelu: JAX's XLA route
    in eval mode and in train mode (outputs and BN statistics 1e-4);
  - the TSCD-Base exp's attributes against exps/TSCD_VID/vid_tscd_base.py;
    the built-in `tscd_base` exp builds, evaluates and trains on the CPU;
  - one stage-2 step with `cat_ota_fg` from the same weights and window:
    JAX's losses (1e-5 relative), updates and EMA (1e-4 of the largest
    update plus the parameter's fp32 spacing), SimOTA run once.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tscd_tpu.models import blocks as jblocks
from tscd_tpu.models import matching as jmat
from tscd_tpu.models import tscd_head as jhead
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.models.tscd import tscd_eval_postprocess as jpostprocess
from tscd_tpu.train import lr as jlr
from tscd_tpu.train.ema import ema_update as jema
from tscd_tpu.train.losses import tscd_loss as jloss
from tscd_tpu.train.optim import build_sgd
from tscd_tpu.train.step import init_train_state as jinit_state
from tscd_torch.exp import get_exp_by_name
from tscd_torch.exp.tscd_large import selftest_exp
from tscd_torch.models import blocks as pblocks
from tscd_torch.models import matching as pmat
from tscd_torch.models import tscd_head as phead
from tscd_torch.models.tscd import tscd_eval_postprocess
from tscd_torch.ops import simota as psimota
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.train import losses as plosses
from tscd_torch.train.step import init_train_state, train_step
from tscd_torch.utils.convert import state_dict_from_flax
from torch_port_util import labels_near, seeded_variables

T = torch.as_tensor
F, L = 4, 1
C, P, WIDTH = 30, 6, 0.125
FPN = [(16, 16, 32), (8, 8, 64), (4, 4, 128)]     # 128 px, width 0.125


def close(got, want, tol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=tol * max(1.0, float(np.abs(want).max())), rtol=tol,
                               err_msg=msg)


def _fpn(seed=0):
    rng = np.random.default_rng(seed)
    xin = [rng.normal(size=(F,) + s).astype(np.float32) for s in FPN]
    te = get_timing_signal_1d(np.arange(F, dtype=np.float32), 256).astype(np.float32)
    return rng, xin, te


def _heads(knobs, xin, te):
    """JAX's and the port's TSCDHead with `knobs`, on the same seeded
    weights (kernels 1/fan_in, BN statistics, scales and biases random)."""
    jm = jhead.TSCDHead(num_classes=C, width=WIDTH, num_proposals=P, **knobs)
    variables = seeded_variables(jm, 0, [jnp.asarray(x) for x in xin], jnp.asarray(te),
                                 L, F - L)
    pm = phead.TSCDHead(C, width=WIDTH, num_proposals=P, **knobs).eval()
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    return jm, variables, pm


def _compare_heads(jout, out):
    jp, pp = jout["proposals"], out["proposals"]
    for name in ("idx", "valid", "cls_id"):
        assert np.array_equal(np.asarray(getattr(jp, name)), getattr(pp, name).numpy()), name
    for name in ("boxes", "obj", "cls_conf", "cls_scores"):
        close(getattr(pp, name), getattr(jp, name), msg=name)
    want = {k for k in jout if k not in ("hw", "simota")}
    assert {k for k in out if k not in ("hw", "simota")} == want
    for k in sorted(want - {"proposals", "matcher_state"}):
        close(out[k].detach(), jout[k], msg=k)
    if jout["matcher_state"] is not None:
        for name, j, p in zip(jmat.MatcherState._fields, jout["matcher_state"],
                              out["matcher_state"]):
            close(p.detach(), j, msg=f"matcher_state.{name}")
    else:
        assert out["matcher_state"] is None


BRANCHES = {
    "mca_aware": dict(agg_type="mca_aware"),
    "reconf_off": dict(reconf=False),
    "decouple_reg_off": dict(decouple_reg=False),
    "ave_off": dict(ave=False),
    "use_mask": dict(use_mask=True, sim_thresh=0.1, conf_sim_thresh=0.2),
    "vid_cls_off": dict(vid_cls=False),
    "vid_reg_off": dict(vid_reg=False),
    "use_pre_nms": dict(use_pre_nms=True),
}


@pytest.mark.parametrize("case", sorted(BRANCHES))
def test_head_branch_matches_jax(case):
    """Each knob off JAX's default through the whole head (jitted JAX),
    and the eval postprocess on its outputs (the proposals' obj and boxes
    where the head has no matcher heads)."""
    knobs = BRANCHES[case]
    _, xin, te = _fpn()
    jm, variables, pm = _heads(knobs, xin, te)
    jout = jax.jit(lambda v, xs: jm.apply(v, xs, jnp.asarray(te), L, F - L))(
        variables, [jnp.asarray(x) for x in xin])
    with torch.no_grad():
        out = pm([T(x).permute(0, 3, 1, 2) for x in xin], T(te), L)
    _compare_heads(jout, out)
    if case in ("decouple_reg_off", "reconf_off"):
        assert "refined_boxes" not in out and "matcher_obj_logits" not in out
        jr, _ = jpostprocess(jout, L, C)
        pr, _ = tscd_eval_postprocess(out, L, C)
        assert np.array_equal(np.asarray(jr.mask), pr.mask.numpy())
        for name in ("boxes", "obj", "score"):
            close(getattr(pr, name), getattr(jr, name), msg=name)


def test_cat_ota_fg_head_injects_simota_fg():
    """With labels the cat_ota_fg head runs SimOTA on its own decode and
    ranks the fg anchors into the slots, as JAX's; without labels it
    selects as the plain head."""
    knobs = dict(cat_ota_fg=True)
    rng, xin, te = _fpn(3)
    jm, variables, pm = _heads(knobs, xin, te)
    xs = [T(x).permute(0, 3, 1, 2) for x in xin]
    with torch.no_grad():
        plain = pm(xs, T(te), L)
        assert "simota" not in plain
        lab = labels_near(rng, plain["proposals"].boxes[:, :2].numpy(), F, C)
        out = pm(xs, T(te), L, labels=T(lab))
    jout = jax.jit(lambda v, xs, lab: jm.apply(v, xs, jnp.asarray(te), L, F - L, labels=lab))(
        variables, [jnp.asarray(x) for x in xin], jnp.asarray(lab))
    _compare_heads(jout, out)
    for name in ("fg_mask", "matched_gt"):
        assert np.array_equal(np.asarray(getattr(jout["simota"], name)),
                              getattr(out["simota"], name).numpy()), name
    close(out["simota"].cls_target, jout["simota"].cls_target, 1e-6)
    fg = out["simota"].fg_mask
    assert bool(fg.any())
    taken = torch.gather(fg, 1, out["proposals"].idx)
    assert torch.equal(taken.sum(1), fg.sum(1).clamp(max=P))


def _decoded(rng, Fr=3, A=900, k=3):
    """Seeded decoded rows (cxcywh, obj, k class probabilities) whose boxes
    sit in a few clusters, so that the class-aware NMS suppresses, with
    tied obj values."""
    centres = rng.uniform(40, 500, (Fr, 12, 2))
    pick = rng.integers(0, 12, (Fr, A))
    cxcy = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 6, (Fr, A, 2))
    wh = rng.uniform(30, 80, (Fr, A, 2))
    obj = rng.choice(np.linspace(0.05, 0.95, 40), (Fr, A))
    cls = rng.dirichlet(np.ones(k), (Fr, A))
    return np.concatenate([cxcy, wh, obj[..., None], cls], -1).astype(np.float32)


@pytest.mark.parametrize("mode", ["pre_nms_0.75", "pre_nms_0.3", "ota_fg"])
def test_select_frame_proposals_match_eager_jax(mode):
    rng = np.random.default_rng(7)
    dec = _decoded(rng)
    p = 50
    if mode.startswith("pre_nms"):
        thr = float(mode.split("_")[-1])
        jp = jhead.select_frame_proposals(jnp.asarray(dec), 3, p, 0.001, thr, True, p)
        pp = phead.select_frame_proposals(T(dec), 3, p, 0.001, p, thr, True)
        plain = phead.select_frame_proposals(T(dec), 3, p, 0.001, p)
        assert not torch.equal(plain.idx, pp.idx)     # the NMS suppressed
    else:
        fg = rng.uniform(size=dec.shape[:2]) < 0.03
        jp = jhead.select_frame_proposals(jnp.asarray(dec), 3, p, 0.5, 0.75, False, 10,
                                          ota_fg=jnp.asarray(fg))
        pp = phead.select_frame_proposals(T(dec), 3, p, 0.5, 10, ota_fg=T(fg))
        assert bool(torch.gather(T(fg), 1, pp.idx).any())
    for name in ("idx", "valid", "cls_id"):
        assert np.array_equal(np.asarray(getattr(jp, name)), getattr(pp, name).numpy()), name
    close(pp.boxes, jp.boxes, 1e-6)


def test_position_bias_matches_jax():
    """log(ReLU(position_embedding(geometry)) + 1e-6) added to the
    softmaxed attention (matching.py:114-119); the reference's 1x1 conv
    carried from JAX's Dense."""
    rng = np.random.default_rng(11)
    N, M, Cd = 7, 9, 64

    def boxes(n):
        xy = rng.uniform(0, 300, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(8, 90, (n, 2))], -1).astype(np.float32)

    q, k = (rng.normal(size=(n, Cd)).astype(np.float32) for n in (N, M))
    qb, kb = boxes(N), boxes(M)
    valid = rng.uniform(size=M) > 0.2
    args = [jnp.asarray(a) for a in (q, k, k, valid, qb, kb)]
    jm = jmat.CosineMHAttention(num_heads=8)
    variables = seeded_variables(jm, 1, *args)
    pm = pmat.CosineMHAttention(Cd, 8, position_bias=True)
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    assert pm.position_embedding.weight.shape == (8, 64, 1, 1)
    want = jm.apply(variables, *args)
    with torch.no_grad():
        got = pm(T(q), T(k), T(k), T(valid), T(qb), T(kb))
        plain = pm(T(q), T(k), T(k), T(valid))
    close(got, want, 1e-5)
    assert float((got - plain).abs().max()) > 1e-3      # the bias moved it


@pytest.mark.parametrize("ksize,act", [(5, "silu"), (3, "relu"), (3, "lrelu")])
def test_focus_xla_route_matches_jax(ksize, act):
    """Focus with a ksize or act the hand kernel does not take: JAX's
    XLA route in eval mode (6x6-style conv, scale and shift, act) and in
    train mode (the conv, BatchNorm on batch statistics, act)."""
    rng = np.random.default_rng(ksize)
    x = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    jm = jblocks.Focus(out_channels=16, ksize=ksize, act=act)
    variables = seeded_variables(jm, 2, jnp.asarray(x))
    pm = pblocks.Focus(3, 16, ksize=ksize, act=act)
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    assert not pm.kernel
    with torch.no_grad():
        close(pm(T(x)).permute(0, 2, 3, 1), jm.apply(variables, jnp.asarray(x)), msg="eval")
        stats = {}
        got = pm(T(x), stats)
    want, mut = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    close(got.permute(0, 2, 3, 1), want, msg="train")
    mean, var = stats[pm.conv.bn]
    close(mean, mut["batch_stats"]["conv"]["bn"]["mean"], msg="running mean")
    close(var, mut["batch_stats"]["conv"]["bn"]["var"], msg="running var")


def _jax_exp(path):
    spec = importlib.util.spec_from_file_location("jax_vid_tscd_base", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Exp()


def test_tscd_base_exp_matches_the_jax_exp():
    """Every attribute the port's TSCD-Base exp shares with
    exps/TSCD_VID/vid_tscd_base.py has its value; its model knobs raise
    nothing."""
    jexp = _jax_exp(os.path.join("exps", "TSCD_VID", "vid_tscd_base.py"))
    pexp = get_exp_by_name("tscd_base")
    shared = sorted(set(vars(pexp)) & set(vars(jexp)))
    assert len(shared) > 60
    differ = {k: (getattr(pexp, k), getattr(jexp, k)) for k in shared
              if getattr(pexp, k) != getattr(jexp, k)}
    assert differ == {}
    assert (pexp.depth, pexp.width, pexp.warmup_epochs) == (0.33, 0.5, 0)
    assert pexp.num_proposals == 50


def test_tscd_base_builds_evaluates_and_trains_on_cpu(tmp_path):
    """The built-in tscd_base exp at full width on one small window (1 + 1
    frames at 64 px for eval, 1 + 1 for a stage-2 step): finite outputs
    of the expected shapes, a step that moves the head and not the
    frozen backbone."""
    exp = get_exp_by_name("tscd_base")
    model = exp.get_model(device="cpu")
    assert model.head.hidden == 128 and model.backbone.backbone.stem.conv.conv.out_channels == 32
    rng = np.random.default_rng(0)
    x = T(rng.integers(0, 256, (2, 64, 64, 3)).astype(np.float32))
    te = T(get_timing_signal_1d(np.arange(2, dtype=np.float32), 256)).float()
    with torch.no_grad():
        out = model(x, te, 1, 1)
        ref, _ = tscd_eval_postprocess(out, 1, exp.num_classes)
    assert out["refined_cls_logits"].shape == (1, 50, 30)
    assert all(torch.isfinite(t).all() for t in (out["refined_boxes"], ref.score))
    opt = exp.get_optimizer(model, 10)
    opt.count = 3                           # past the zero-LR first update
    st = init_train_state(model, opt, exp.ema_decay)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    boxes = out["proposals"].boxes[:, :2].numpy()
    lab = T(labels_near(rng, boxes, 2, exp.num_classes, size=64))
    losses = train_step(st, x, lab, te, 1, 1)
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if k.startswith("backbone"))
    assert any(not torch.equal(after[k], v) for k, v in before.items() if k.startswith("head"))


# -- one stage-2 step with cat_ota_fg ---------------------------------------

ITERS, STEP = 4, 5


def test_cat_ota_fg_step_matches_jax(monkeypatch):
    """The slice gate of test_torch_port_train.py with cat_ota_fg on both
    sides: SimOTA runs once, in the head, and the loss reuses it."""
    exp = selftest_exp()
    exp.cat_ota_fg = True
    exp.no_aug_epochs = 0                   # STEP sits at the peak of the cosine
    Lt, Gt = exp.lframe, exp.gframe
    Ft = Lt + Gt
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (Ft, 128, 128, 3)).astype(np.float32)
    te = get_timing_signal_1d(np.arange(Ft, dtype=np.float32), 256).astype(np.float32)
    jm = JTSCD(num_classes=C, depth=exp.depth, width=exp.width, num_proposals=P,
               minimal_limit=exp.minimal_limit, heads=exp.heads, cat_ota_fg=True,
               stop_backbone_grad=True)
    variables = seeded_variables(jm, 4, jnp.asarray(x), jnp.asarray(te), Lt, Gt, False)
    pm = exp.get_model(device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    with torch.no_grad():
        boxes = pm(T(x), T(te), Lt, Gt)["proposals"].boxes[:Lt, :3].numpy()
    lab = labels_near(rng, boxes, Ft, C)

    jsched = jlr.yolox_warm_cos_lr(exp.basic_lr_per_img * exp.batch_size, exp.min_lr_ratio,
                                   ITERS * exp.max_epoch, ITERS * exp.warmup_epochs,
                                   exp.warmup_lr, 0)
    tx = build_sgd(lambda i: jsched(i + STEP), freeze_prefixes=exp.freeze_prefixes(),
                   stem_lr_prefixes=exp.stem_lr_prefixes(), stem_lr_ratio=exp.stem_lr_ratio)
    state = jinit_state(variables, tx)
    bs = variables["batch_stats"]

    def loss_fn(params, x, lab):
        out = jm.apply({"params": params, "batch_stats": bs}, x, jnp.asarray(te), Lt, Gt,
                       False, labels=lab)
        losses = jloss(out, lab, (8, 16, 32), Lt)
        return losses["total_loss"], losses

    (_, jlosses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params, jnp.asarray(x), jnp.asarray(lab))
    upd, _ = jax.jit(tx.update)(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, upd)
    step1 = jnp.asarray(STEP + 1, jnp.int32)
    ema_p = jema(state.ema_params, params, step1, exp.ema_decay)
    ema_b = jema(state.ema_batch_stats, bs, step1, exp.ema_decay)

    calls = []

    def counted(fn):
        def wrapper(*a, **k):
            calls.append(fn.__module__)
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(phead, "simota_assign", counted(psimota.simota_assign))
    monkeypatch.setattr(plosses, "simota_assign", counted(psimota.simota_assign))
    opt = exp.get_optimizer(pm, ITERS)
    opt.count = STEP
    st = init_train_state(pm, opt, exp.ema_decay)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    got = train_step(st, T(x), T(lab), T(te), Lt, Gt)
    assert len(calls) == 1                  # in the head, none in the loss

    for k, v in jlosses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(jlosses["loss_refined_cls"]) > 0 and float(jlosses["loss_matched_iou"]) > 0
    tmpl = pm.state_dict()
    named = dict(pm.named_parameters())
    want = state_dict_from_flax({"params": params, "batch_stats": bs}, tmpl)
    after = pm.state_dict()
    dmax = max(float((want[k].double() - before[k].double()).abs().max()) for k in named)
    assert dmax > 0

    def held(got_t, want_t, k):
        bound = 1e-4 * dmax + np.spacing(np.abs(want_t.numpy()))
        assert np.all(np.abs(got_t.double().numpy() - want_t.double().numpy()) <= bound), k

    for k in named:
        held(after[k], want[k], k)
    jema_sd = state_dict_from_flax({"params": ema_p, "batch_stats": ema_b}, tmpl)
    for k, v in st.ema.state.items():
        if not k.endswith("num_batches_tracked"):
            held(v, jema_sd[k], k)
