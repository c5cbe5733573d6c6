"""The port's stage-2 training against the JAX package on the CPU, at the
selftest width (depth 0.33, width 0.125, P = 6) and 128 px, on inputs
made from numpy seeds:

  - SimOTA: fg masks and matched gts exact, targets 1e-6;
  - tscd_loss, both ota_mode values (and the matched-obj clip at 15):
    each term 1e-5 relative, and its gradient with respect to the head's
    outputs 1e-5 of the largest, on the same head outputs;
  - the attention's gradients against jax.vjp of fused_dual_attention
    (Pallas interpret mode), 1e-5; cls_score gets none;
  - parameter groups equal to _label_params for every parameter; one
    grouped SGD update (two, so that momentum counts) against build_sgd's
    with and without clipping, 1e-6; the LR schedules at 10 iterations,
    1e-7; the EMA 1e-7; a checkpoint round trip;
  - the slice gate: one stage-2 step from the same JAX-initialised
    weights and window gives JAX's losses (1e-5 relative), gradients
    (1e-4 of the largest), parameter updates (1e-4 of the largest update,
    plus the fp32 spacing of the parameter: the final add rounds to it)
    and EMA (the same bound);
  - the train collate against JAX's collate_window (hsv_prob 0, flip
    probability 0 and 1), exactly;
  - the knobs the port does not run raise (the ported ones are held in
    tests/test_torch_port_train_knobs.py), and the trainer runs an epoch
    of the selftest exp on the committed fixture;
  - the repairs of the port: an exp file that sets a model knob builds
    and runs its model where JAX's TSCD takes the knob, and raises in
    get_model where JAX's exp never passes it (each default JAX's); the trainer
    augments every epoch, as JAX's one loader does, with the LR schedule's
    no-aug tail kept;
  - multiscale: random_input_size and the trainer's every-10-iterations
    cadence give JAX's sizes; an augmented multiscale epoch from files;
  - JAX's msgpack checkpoints without flax: the reader equals
    flax.serialization on the committed converted_ckpt.msgpack and on
    every kind of leaf, chunked arrays too; a step resumed by the port's
    trainer from a checkpoint in the JAX trainer's format equals JAX's
    resumed step (losses 1e-5 relative, updates and EMA as the gate's),
    its momentum traces restored exactly.
"""

import os
import random
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from tscd_tpu.data import vid as jvid
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.models.tscd_head import FrameProposals as JProps
from tscd_tpu.ops.decode import anchor_centers as janchors
from tscd_tpu.ops.pallas.fused_attention import fused_dual_attention as jfused
from tscd_tpu.ops.simota import simota_assign_batch as jsimota
from tscd_tpu.train import lr as jlr
from tscd_tpu.train.ema import ema_update as jema
from tscd_tpu.train.losses import tscd_loss as jloss
from tscd_tpu.train.optim import _label_params, build_sgd
from tscd_tpu.train.step import init_train_state as jinit_state
from tscd_torch.core import tscd_trainer as trainer_mod
from tscd_torch.data import vid as pvid
from tscd_torch.exp.tscd_large import selftest_exp
from tscd_torch.models.blocks import BaseConv
from tscd_torch.models.tscd_head import FrameProposals
from tscd_torch.ops.decode import anchor_centers
from tscd_torch.ops.kernels import fused_attention as pfa
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.ops.simota import simota_assign
from tscd_torch.train import lr as plr
from tscd_torch.train.checkpoint import (load_checkpoint, load_tolerant,
                                         save_checkpoint)
from tscd_torch.train.ema import ModelEMA, ema_decay
from tscd_torch.train.losses import tscd_loss
from tscd_torch.train.optim import GroupedSGD, label_params
from tscd_torch.train.step import init_train_state, train_step
from tscd_torch.utils.convert import flax_param_path, state_dict_from_flax
from torch_port_util import perturb

EXP = selftest_exp()
L, G = EXP.lframe, EXP.gframe
F = L + G
HW = [(16, 16), (8, 8), (4, 4)]            # 128 px at strides 8, 16, 32
STRIDES = (8, 16, 32)
A = sum(h * w for h, w in HW)
C = EXP.num_classes
P = EXP.num_proposals
ITERS, STEP = 4, 5                         # the gate's epoch and step
T = torch.as_tensor


# -- SimOTA and the losses on seeded head outputs --------------------------

def _gts(rng, n_frames, n_slots, centres=None):
    """(n_frames, n_slots, 5) [cls, cx, cy, w, h]; some slots empty, and
    where `centres` (n_frames, k, 4 cxcywh) is given, those boxes first."""
    lab = np.zeros((n_frames, n_slots, 5), np.float32)
    for f in range(n_frames):
        boxes = [] if centres is None else list(centres[f])
        n = int(rng.integers(1, n_slots - len(boxes) + 1))
        for _ in range(n):
            xy = rng.uniform(12, 116, 2)
            boxes.append(np.concatenate([xy, rng.uniform(10, 80, 2)]))
        for i, b in enumerate(boxes[:n_slots]):
            lab[f, i] = np.concatenate([[rng.integers(0, C)], b])
    return lab


def _near(rng, cxcywh):
    """Boxes near the given ones (centres a pixel or two off, sizes 10-40%
    larger): gts at a proposal's own box would put the IoU loss on the
    kinks of its max/min, where a 1e-6 difference in the box flips which
    side the gradient takes."""
    out = cxcywh.astype(np.float64).copy()
    out[:, :2] += rng.uniform(-2, 2, out[:, :2].shape)
    out[:, 2:] *= rng.uniform(1.1, 1.4, out[:, 2:].shape)
    return out.astype(np.float32)


def _head_out(rng, clip=False):
    """Seeded head outputs and labels whose local frames hold gts at some
    proposals' boxes, so that the refined terms have foreground."""
    raw = rng.normal(0, 0.5, (F, A, 5 + C)).astype(np.float32)
    raw[..., 4:] -= 2.0
    idx = np.stack([rng.choice(A, P, replace=False) for _ in range(F)])
    grids = np.concatenate([np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
                            .reshape(-1, 2) for h, w in HW]).astype(np.float32)
    strs = np.concatenate([np.full(h * w, s, np.float32) for (h, w), s in zip(HW, STRIDES)])
    cxcy = (raw[..., :2] + grids) * strs[:, None]
    wh = np.exp(raw[..., 2:4]) * strs[:, None]
    boxes = np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1)
    pboxes = np.take_along_axis(boxes, idx[..., None], 1)
    centres = [_near(rng, np.concatenate([cxcy[f, idx[f, :3]], wh[f, idx[f, :3]]], -1))
               if f < L else None for f in range(F)]
    lab = np.zeros((F, 8, 5), np.float32)
    for f in range(F):
        lab[f] = _gts(rng, 1, 8, None if centres[f] is None else centres[f][None])[0]
    valid = rng.uniform(size=(F, P)) < 0.85
    obj = rng.normal(0, 2, (L, P)).astype(np.float32) * (60.0 if clip else 1.0)
    arrays = dict(raw_outputs=raw, refined_cls_logits=rng.normal(0, 1, (L, P, C)).astype(np.float32),
                  matcher_obj_logits=obj,
                  matcher_reg_offsets=rng.normal(0, 0.3, (L, P, 4)).astype(np.float32))
    props = dict(boxes=pboxes.astype(np.float32), idx=idx, valid=valid)
    return arrays, props, lab


def _props(props, for_jax):
    """The proposals the losses read (boxes, anchor idx, valid), in either
    package's FrameProposals; the score fields are zeros."""
    module, conv, ints = ((JProps, jnp.asarray, np.int32) if for_jax
                          else (FrameProposals, T, np.int64))
    z = conv(np.zeros((F, P), np.float32))
    return module(conv(props["boxes"]), z, z, conv(np.zeros((F, P), ints)),
                  conv(np.zeros((F, P, C), np.float32)),
                  conv(props["idx"].astype(ints)), conv(props["valid"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simota_matches_jax(seed):
    rng = np.random.default_rng(seed)
    arrays, _, lab = _head_out(rng)
    raw = arrays["raw_outputs"]
    from tscd_tpu.ops.decode import decode_outputs as jdecode
    dec = np.asarray(jdecode(jnp.asarray(raw), HW, STRIDES))
    xs, ys, ss = janchors(HW, STRIDES)
    if seed == 2:          # an image with no gt at all
        lab[1] = 0
    valid = lab.sum(-1) > 0
    want = jsimota(jnp.asarray(dec[..., :4]), jnp.asarray(raw[..., 4]),
                   jnp.asarray(raw[..., 5:]), jnp.asarray(lab[..., 1:5]),
                   jnp.asarray(lab[..., 0].astype(np.int32)), jnp.asarray(valid),
                   jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ss))
    pxs, pys, pss = anchor_centers(HW, STRIDES)
    assert np.array_equal(pss.numpy(), ss) and np.array_equal(pxs.numpy(), xs)
    got = simota_assign(T(dec[..., :4]), T(raw[..., 4]), T(raw[..., 5:]),
                        T(lab[..., 1:5]), T(lab[..., 0]).to(torch.int32), T(valid),
                        pxs, pys, pss)
    fg = np.asarray(want.fg_mask)
    assert fg.sum() > 5
    assert np.array_equal(got.fg_mask.numpy(), fg)
    assert np.array_equal(got.matched_gt.numpy()[fg], np.asarray(want.matched_gt)[fg])
    for name in ("cls_target", "obj_target", "num_fg", "num_gt"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-6, err_msg=name)
    for name in ("reg_target", "l1_target"):
        np.testing.assert_allclose(getattr(got, name).numpy()[fg],
                                   np.asarray(getattr(want, name))[fg],
                                   rtol=1e-6, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("ota_mode,clip", [(True, False), (False, False), (True, True)])
def test_tscd_loss_and_its_gradient_match_jax(ota_mode, clip):
    arrays, props, lab = _head_out(np.random.default_rng(3), clip=clip)
    names = sorted(arrays)

    def jfn(*xs):
        out = dict(zip(names, xs), hw=HW, proposals=_props(props, True))
        losses = jloss(out, jnp.asarray(lab), STRIDES, L, ota_mode=ota_mode)
        return losses["total_loss"], losses

    (_, want), jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(names))),
                                           has_aux=True)(*(jnp.asarray(arrays[n]) for n in names))
    ins = [T(arrays[n]).requires_grad_(True) for n in names]
    out = dict(zip(names, ins), hw=HW, proposals=_props(props, False))
    got = tscd_loss(out, T(lab), STRIDES, L, ota_mode=ota_mode)
    got["total_loss"].backward()
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(want["loss_refined_cls"]) > 0 and float(want["loss_matched_iou"]) > 0
    if clip:
        assert float(want["loss_matched_obj"]) == pytest.approx(15.0)
    for n, x, g in zip(names, ins, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=n)


# -- the attention's backward ----------------------------------------------

@pytest.mark.parametrize("h,q,k,d,p_valid", [(2, 6, 24, 8, 0.8), (4, 5, 40, 16, 0.5)])
def test_attention_gradients_match_jax_vjp(h, q, k, d, p_valid):
    rng = np.random.default_rng(h * 10 + q)
    B = 2
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    qkv = [mk(B, h, q, d), mk(B, h, k, d), mk(B, h, k, d), mk(B, h, q, d),
           mk(B, h, k, d), mk(B, h, k, d)]
    score = rng.uniform(0, 1, (B, k)).astype(np.float32)
    valid = rng.uniform(size=(B, k)) < p_valid
    cot = [mk(B, h, q, d), mk(B, h, q, d), mk(B, h, q, k)]
    want = []
    for b in range(B):
        _, vjp = jax.vjp(lambda *a: jfused(*a, jnp.asarray(score[b]), jnp.asarray(valid[b]),
                                          25.0, True), *(jnp.asarray(t[b]) for t in qkv))
        want.append([np.asarray(g) for g in vjp(tuple(jnp.asarray(c[b]) for c in cot))])
    ins = [T(t).requires_grad_(True) for t in qkv]
    s = T(score).requires_grad_(True)
    n0 = pfa.fused_dual_attention.backward_calls
    outs = pfa.fused_dual_attention(*ins, s, T(valid))
    grads = torch.autograd.grad(outs, ins + [s], [T(c) for c in cot], allow_unused=True)
    assert pfa.fused_dual_attention.backward_calls == n0 + 1
    assert grads[6] is None                    # JAX returns zeros for cls_score
    for i, g in enumerate(grads[:6]):
        w = np.stack([want[b][i] for b in range(B)])
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1))


# -- the JAX-initialised selftest model ------------------------------------

def _window(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (F, 128, 128, 3)).astype(np.float32)
    te = get_timing_signal_1d(np.arange(F, dtype=np.float32), 256)
    return rng, x, te


@pytest.fixture(scope="module")
def jax_model():
    _, x, te = _window()
    jm = JTSCD(num_classes=C, depth=EXP.depth, width=EXP.width, num_proposals=P,
               minimal_limit=EXP.minimal_limit, heads=EXP.heads, stop_backbone_grad=True)
    init = jax.jit(lambda key: jm.init(key, jnp.asarray(x), jnp.asarray(te), L, G, False))
    return jm, perturb(jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0))))


def _port_model(variables):
    pm = EXP.get_model(device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    return pm


def test_parameter_groups_equal_label_params(jax_model):
    _, variables = jax_model
    pm = _port_model(variables)
    want = {"/".join(k): v for k, v in traverse_util.flatten_dict(_label_params(
        variables["params"], EXP.freeze_prefixes(), EXP.stem_lr_prefixes())).items()}
    named = dict(pm.named_parameters())
    got = {"/".join(flax_param_path(n, named[n].dim())): lab for n, lab in
           label_params(named.items(), EXP.freeze_prefixes(),
                        EXP.stem_lr_prefixes()).items()}
    assert got == want
    assert set(want.values()) == {"frozen", "weight", "no_decay", "stem_weight",
                                  "stem_no_decay"}


def _grad_trees(variables, rng, norm):
    """Two random gradient trees of global norm `norm`, as JAX trees."""
    out = []
    for _ in range(2):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                   variables["params"])
        leaves = jax.tree_util.tree_leaves(g)
        scale = norm / np.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in leaves))
        out.append(jax.tree_util.tree_map(lambda a: (a * scale).astype(np.float32), g))
    return out


@pytest.mark.parametrize("norm", [10.0, 200.0], ids=["no_clip", "clip"])
def test_grouped_sgd_matches_build_sgd(jax_model, norm):
    _, variables = jax_model
    sched = plr.yolox_warm_cos_lr(0.01, 0.05, 40, 4, 0.0, 8)
    jsched = jlr.yolox_warm_cos_lr(0.01, 0.05, 40, 4, 0.0, 8)
    tx = build_sgd(lambda i: jsched(i + STEP), freeze_prefixes=EXP.freeze_prefixes(),
                   stem_lr_prefixes=EXP.stem_lr_prefixes(), stem_lr_ratio=0.1)
    params = variables["params"]
    opt_state = tx.init(params)
    pm = _port_model(variables)
    opt = GroupedSGD(pm.named_parameters(), sched, freeze_prefixes=EXP.freeze_prefixes(),
                     stem_lr_prefixes=EXP.stem_lr_prefixes(), stem_lr_ratio=0.1)
    opt.count = STEP
    names = dict(pm.named_parameters())
    update = jax.jit(tx.update)
    for g in _grad_trees(variables, np.random.default_rng(9), norm):
        upd, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
        as_port = state_dict_from_flax({"params": g, "batch_stats": variables["batch_stats"]},
                                       pm.state_dict())
        for n, p in names.items():
            p.grad = as_port[n]
        opt.step()
        want = state_dict_from_flax({"params": params, "batch_stats": variables["batch_stats"]},
                                    pm.state_dict())
        for n, p in names.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=n)
    assert opt.count == STEP + 2


@pytest.mark.parametrize("name", ["yolox_warm_cos", "warm_cos", "cos", "multistep"])
def test_lr_schedules_match_jax(name):
    args = {"yolox_warm_cos": (0.01, 0.05, 10, 2, 0.001, 3), "warm_cos": (0.01, 10, 3),
            "cos": (0.01, 10), "multistep": (0.01, [4, 7])}[name]
    fn = {"yolox_warm_cos": "yolox_warm_cos_lr", "warm_cos": "warm_cos_lr",
          "cos": "cos_lr", "multistep": "multistep_lr"}[name]
    got, want = getattr(plr, fn)(*args), getattr(jlr, fn)(*args)
    for it in range(10):
        assert got(it) == pytest.approx(float(want(it)), abs=1e-7), it
    if name == "yolox_warm_cos":
        assert plr.yolox_warm_cos_lr(0.01, 0.05, 10, 2, 0.0, 3)(0) == 0.0


@pytest.mark.parametrize("step", [1, 7, 3000])
def test_ema_matches_jax(step):
    """The decay within one fp32 spacing of exp's result: np.exp and XLA's
    exp may round apart by that, and 1 - exp(-t/2000) keeps the absolute
    error. That moves 1 - d by up to an ulp of 1, so the EMA is held to
    1e-7 plus 2 ulps of its value."""
    d_jax = 0.9998 * (1.0 - jnp.exp(-jnp.asarray(step, jnp.float32) / 2000.0))
    assert abs(float(ema_decay(step)) - float(d_jax)) <= 2.0 ** -23
    rng = np.random.default_rng(step)
    m = BaseConv(3, 4, 3)
    with torch.no_grad():
        for t in list(m.parameters()) + [m.bn.running_mean, m.bn.running_var]:
            t.copy_(T(rng.normal(size=t.shape).astype(np.float32)))
    ema = ModelEMA(m)
    with torch.no_grad():
        for t in list(m.parameters()) + [m.bn.running_mean, m.bn.running_var]:
            t.add_(T(rng.normal(0, 1e-3, size=t.shape).astype(np.float32)))
        m.bn.num_batches_tracked.fill_(11)
    old = {k: v.numpy().copy() for k, v in ema.state.items()}
    ema.update(m, step)
    new = {k: v.numpy() for k, v in m.state_dict().items()}
    want = jema(old, new, jnp.asarray(step, jnp.int32))
    for k, v in ema.state.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=2.0 ** -22,
                                   atol=1e-7, err_msg=k)
    assert int(ema.state["bn.num_batches_tracked"]) == 11


def test_checkpoint_round_trip(tmp_path):
    m = EXP.get_model(device="cpu")
    opt = EXP.get_optimizer(m, ITERS)
    st = init_train_state(m, opt)
    with torch.no_grad():
        for t in opt.trace.values():
            t.normal_()
    st.ema.update(m, 3)
    ckpt = {"start_epoch": 2, "step": 9, "model": st.ema.state_dict(),
            "raw_model": m.state_dict(), "optimizer": opt.state_dict()}
    path = save_checkpoint(ckpt, str(tmp_path), is_best=True)
    assert os.path.exists(tmp_path / "best_ckpt.pth")
    back = load_checkpoint(path)
    assert back["start_epoch"] == 2 and back["step"] == 9
    m2 = EXP.get_model(device="cpu")
    m2.load_state_dict(load_tolerant(m2.state_dict(), back["raw_model"]))
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                   m2.state_dict().values()))
    opt2 = EXP.get_optimizer(m2, ITERS)
    opt2.load_state_dict(back["optimizer"])
    assert opt2.count == opt.count
    assert all(torch.equal(opt.trace[n], opt2.trace[n]) for n in opt.trace)
    # tolerant: a missing key and a shape mismatch keep the target's value
    target = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    logged = []
    out = load_tolerant(target, {"a": torch.ones(2), "b": torch.ones(4)}, log=logged.append)
    assert out["a"].tolist() == [1, 1] and out["b"].tolist() == [0, 0, 0] and len(logged) == 2


# -- the slice gate: one stage-2 step --------------------------------------

def _gate_labels(pm, x, te, rng):
    """8 gt slots a frame; the local frames' first gts sit near the boxes
    of the port's own first proposals, so that the refined terms see fg."""
    out = pm(T(x), T(te), L, G)
    b = out["proposals"].boxes[:, :3].numpy()
    cxcywh = np.concatenate([(b[..., :2] + b[..., 2:]) / 2, b[..., 2:] - b[..., :2]], -1)
    return _gts(rng, F, 8, [_near(rng, cxcywh[f]) if f < L else np.zeros((0, 4))
                            for f in range(F)])


_LOSS_AND_GRAD = {}


def _jax_loss_and_grad(jm, ota_mode):
    """jit(value_and_grad) of JAX's window loss (_build_train_step,
    window_batch = 1, fix_bn), one compile for each ota_mode."""
    if ota_mode not in _LOSS_AND_GRAD:
        def loss_fn(params, bs, x, te, lab):
            out = jm.apply({"params": params, "batch_stats": bs}, x, te, L, G, False,
                           labels=lab)
            losses = jloss(out, lab, STRIDES, L, ota_mode=ota_mode)
            return losses["total_loss"], losses
        _LOSS_AND_GRAD[ota_mode] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return _LOSS_AND_GRAD[ota_mode]


@pytest.mark.parametrize("ota_mode", [True, False])
def test_one_stage2_step_matches_jax(jax_model, ota_mode):
    jm, variables = jax_model
    rng, x, te = _window()
    pm = _port_model(variables)
    lab = _gate_labels(pm, x, te, rng)
    exp = selftest_exp()
    exp.no_aug_epochs = 0             # STEP sits at the peak of the cosine
    jsched = jlr.yolox_warm_cos_lr(exp.basic_lr_per_img * exp.batch_size, exp.min_lr_ratio,
                                   ITERS * exp.max_epoch, ITERS * exp.warmup_epochs,
                                   exp.warmup_lr, 0)
    tx = build_sgd(lambda i: jsched(i + STEP), freeze_prefixes=exp.freeze_prefixes(),
                   stem_lr_prefixes=exp.stem_lr_prefixes(), stem_lr_ratio=exp.stem_lr_ratio)
    state = jinit_state(variables, tx)
    bs = variables["batch_stats"]
    (_, jlosses), grads = _jax_loss_and_grad(jm, ota_mode)(state.params, bs, x, te, lab)
    upd, _ = jax.jit(tx.update)(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, upd)
    ema_p = jema(state.ema_params, params, jnp.asarray(STEP + 1, jnp.int32), exp.ema_decay)
    ema_b = jema(state.ema_batch_stats, bs, jnp.asarray(STEP + 1, jnp.int32), exp.ema_decay)

    opt = exp.get_optimizer(pm, ITERS)
    opt.count = STEP
    st = init_train_state(pm, opt, exp.ema_decay)
    assert st.step == STEP
    assert opt.lr() == pytest.approx(float(jsched(STEP))) and opt.lr() > 0
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    raw = {}                    # the gradients as backward leaves them: the
    sgd_step = opt.step         # step clips them in place

    def step():
        raw.update({n: p.grad.clone() for n, p in pm.named_parameters() if p.grad is not None})
        sgd_step()
    opt.step = step
    got = train_step(st, T(x), T(lab), T(te), L, G, ota_mode=ota_mode)

    for k, v in jlosses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(jlosses["loss_refined_cls"]) > 0 and float(jlosses["loss_matched_iou"]) > 0
    tmpl = pm.state_dict()
    jg = state_dict_from_flax({"params": grads, "batch_stats": bs}, tmpl)
    named = dict(pm.named_parameters())
    gmax = max(float(jg[n].abs().max()) for n in named)
    for n, p in named.items():
        g = raw.get(n, torch.zeros_like(p))
        if n.startswith("backbone"):
            assert n not in raw              # stop_backbone_grad
            continue
        np.testing.assert_allclose(g.numpy(), jg[n].numpy(), rtol=0, atol=1e-4 * gmax,
                                   err_msg=n)
    want = state_dict_from_flax({"params": params, "batch_stats": bs}, tmpl)
    after = pm.state_dict()
    d_want = {k: want[k].double() - before[k].double() for k in named}
    dmax = max(float(d.abs().max()) for d in d_want.values())
    assert dmax > 0

    def close(got_t, want_t, ref_t, k):
        bound = 1e-4 * dmax + np.spacing(np.abs(ref_t.numpy()))
        assert np.all(np.abs(got_t.double().numpy() - want_t.double().numpy()) <= bound), k

    for k in named:
        close(after[k], want[k], want[k], k)
        if k.startswith("backbone"):
            assert torch.equal(after[k], before[k])
    jema_sd = state_dict_from_flax({"params": ema_p, "batch_stats": ema_b}, tmpl)
    for k, v in st.ema.state.items():
        if k.endswith("num_batches_tracked"):
            continue
        close(v, jema_sd[k], jema_sd[k], k)


# -- the train collate and the loader --------------------------------------

class _Frames:
    """In-memory dataset with VIDDataset's interface, for both packages."""

    def __init__(self, seed=0, n=4):
        rng = np.random.default_rng(seed)
        self.img_size = (128, 128)
        self.paths = [f"vid0/{i:06d}.JPEG" for i in range(n)]
        self.frames = {p: rng.integers(0, 256, (72, 128, 3), dtype=np.uint8) for p in self.paths}
        self.annos = {}
        for p in self.paths:
            k = int(rng.integers(0, 4))
            xy = rng.uniform(0, 80, (k, 2))
            wh = rng.uniform(5, 40, (k, 2))
            self.annos[p] = np.concatenate(
                [xy, np.minimum(xy + wh, (128, 72)), rng.integers(0, 30, (k, 1))], 1
            ).astype(np.float32)
        self.res = [self.paths]

    def load_frame(self, p):
        return self.frames[p], self.annos[p].copy(), (720, 1280)

    def frame_index(self, p):
        return int(os.path.splitext(os.path.basename(p))[0]) + 100


@pytest.mark.parametrize("flip_prob", [0.0, 1.0])
def test_train_collate_matches_jax(flip_prob):
    ds = _Frames()
    kw = dict(train_time_index=True, cxcywh=True, augment=True, hsv_prob=0.0,
              flip_prob=flip_prob)
    random.seed(0)
    want = jvid.collate_window(ds, ds.paths, 120, **kw)
    with ThreadPoolExecutor(2) as pool:
        got = pvid.collate_window(ds, ds.paths, pool, 120, np.uint8,
                                  rng=np.random.default_rng(0), **kw)
    assert np.array_equal(got["imgs"], want["imgs"].astype(np.uint8))
    assert np.array_equal(got["imgs"].astype(np.float32), want["imgs"])
    assert np.array_equal(got["labels"], want["labels"])
    assert np.array_equal(got["time_embedding"], want["time_embedding"])
    assert got["infos"] == want["infos"] and got["paths"] == want["paths"]
    assert (got["labels"].sum(-1) > 0).any()


def test_train_loader_shuffles_with_its_generator():
    ds = _Frames(n=4)
    ds.res = [[p] for p in ds.paths]
    order = lambda seed: [b["paths"][0] for b in pvid.WindowLoader(
        ds, shuffle=True, rng=np.random.default_rng(seed))]
    assert order(3) == order(3) and sorted(order(3)) == ds.paths
    assert [b["paths"][0] for b in pvid.WindowLoader(ds)] == ds.paths


# -- what the port does not run, and the trainer -----------------------------

def _set(**kw):
    def apply(exp):
        for k, v in kw.items():
            setattr(exp, k, v)
    return apply


@pytest.mark.parametrize("knob", ["agg_type", "int8_frozen_backbone", "int8_qat"])
def test_knobs_the_port_does_not_run_raise(knob):
    exp = selftest_exp()
    if knob == "agg_type":
        # every agg_type of JAX's TSCD head runs ('localagg' since the YOLOV
        # family's port); a YOLOV-only one raises
        exp.agg_type = "msa"
        with pytest.raises(ValueError, match="agg_type 'msa'"):
            exp.get_model(device="cpu")
        with pytest.raises(ValueError, match="agg_type"):
            exp.get_trainer(device="cpu")
    else:
        setattr(exp, knob, True)
        with pytest.raises(NotImplementedError, match=knob):
            exp.get_trainer(device="cpu")


def test_eval_forward_records_no_graph_and_train_forward_does():
    m = EXP.get_model(device="cpu")
    _, x, te = _window()
    out = m(T(x), T(te), L, G)
    assert not out["raw_outputs"].requires_grad and not m.training
    m.train()
    out = m(T(x), T(te), L, G)
    assert out["raw_outputs"].requires_grad and out["refined_cls_logits"].requires_grad
    assert not out["proposals"].boxes.requires_grad     # the detached decode
    assert m.training and not any(mod.training for mod in m.children())
    assert all(not mod.training for mod in m.modules() if mod is not m)


def test_trainer_runs_the_selftest_epoch(tmp_path):
    exp = selftest_exp()
    exp.output_dir = str(tmp_path)
    exp.print_interval = 2
    args = type("Args", (), {"start_epoch": 1})()
    trainer = exp.get_trainer(args, device="cpu")
    st = trainer.train()                      # the no-aug epoch, then eval
    n = len(trainer.dataset.res)
    assert n > 0 and st.step == 2 * n and st.optimizer.count == 2 * n
    assert all(np.isfinite(v).all() for v in trainer.meter.values())
    ckpt = load_checkpoint(os.path.join(trainer.file_name, "latest_ckpt.pth"))
    assert ckpt["start_epoch"] == 2
    assert all(torch.equal(ckpt["model"][k], v) for k, v in st.ema.state.items())
    assert 0.0 <= trainer.evaluate() <= 1.0
    # a resume takes the EMA weights, the momentum and the update count
    resumed = exp.get_trainer(type("Args", (), {"resume": True})(), device="cpu")
    resumed.dataset = trainer.dataset
    resumed._init_state(n)
    assert resumed.start_epoch == 2 and resumed.state.step == 2 * n
    assert all(torch.equal(resumed.model.state_dict()[k], v) for k, v in ckpt["model"].items())
    assert all(torch.equal(resumed.state.optimizer.trace[k], v)
               for k, v in ckpt["optimizer"]["trace"].items())


# -- the port's repairs: model knobs, augmentation, multiscale --------------

_KNOB_VALUES = {"use_pre_nms": True, "cat_ota_fg": True, "agg_type": "mca_aware",
                "decouple_reg": False, "reconf": False, "ave": False, "use_mask": True,
                "vid_cls": False, "vid_reg": False, "sparse_vid_towers": True,
                "pre_nms": 0.6, "defualt_pre": 500, "remat_backbone": True}


@pytest.mark.parametrize("knob", [None] + sorted(_KNOB_VALUES))
def test_an_exp_file_that_sets_a_model_knob_raises(tmp_path, knob):
    """An exp file that sets a model knob in __init__: the knobs JAX's TSCD
    takes build their model, which runs one forward (and, for
    remat_backbone, the trainer recomputing the backbone); the six JAX's
    exp never passes to its TSCD raise in get_model, saying why. Each
    default is JAX's."""
    from tscd_tpu.exp.tscd_base import Exp as JExp
    from tscd_torch.exp import get_exp
    from tscd_torch.exp.tscd_base import MODEL_KNOBS
    jexp = JExp()
    assert {k: getattr(jexp, k) for k in MODEL_KNOBS} == {k: v[0] for k, (v, _) in MODEL_KNOBS.items()}
    ported = {"use_pre_nms", "cat_ota_fg", "decouple_reg", "reconf", "sparse_vid_towers",
              "agg_type"}
    assert {k: getattr(selftest_exp(), k) for k in ported} == {k: getattr(jexp, k) for k in ported}
    assert set(MODEL_KNOBS) == set(_KNOB_VALUES) - ported - {"remat_backbone"}
    assert selftest_exp().remat_backbone == jexp.remat_backbone is False
    line = f"        self.{knob} = {_KNOB_VALUES[knob]!r}\n" if knob else ""
    path = tmp_path / "exp_knob.py"
    path.write_text("from tscd_torch.exp.tscd_large import SelftestExp\n\n\n"
                    "class Exp(SelftestExp):\n    def __init__(self):\n"
                    "        super().__init__()\n" + line)
    exp = get_exp(str(path))
    if knob in MODEL_KNOBS and _KNOB_VALUES[knob] not in MODEL_KNOBS[knob][0]:
        with pytest.raises(NotImplementedError, match=f"{knob} = .*JAX's exp does not pass it"):
            exp.get_model(device="cpu")
        return
    model = exp.get_model(device="cpu")
    if knob == "remat_backbone":
        assert model.remat_backbone is True
        assert exp.get_trainer(device="cpu").model.remat_backbone is True
    elif knob is not None:
        field = getattr(model.head, knob)
        assert field == _KNOB_VALUES[knob]
    _, x, te = _window()
    with torch.no_grad():
        out = model(T(x), T(te), L, G)
    assert torch.isfinite(out["refined_cls_logits"]).all()
    assert ("refined_boxes" in out) == (knob not in ("reconf", "decouple_reg"))


def test_the_trainer_augments_every_epoch_as_jax(tmp_path):
    """JAX builds one loader with no_aug left False, so the port's trainer
    augments every epoch; no_aug_epochs still shapes the LR schedule."""
    exp = selftest_exp()
    exp.max_epoch, exp.no_aug_epochs, exp.hsv_prob = 4, 2, 1.0
    exp.output_dir = str(tmp_path)
    trainer = exp.get_trainer(device="cpu")
    trainer.dataset = exp.get_train_dataset()
    for epoch in range(exp.max_epoch):
        kw = trainer._loader(epoch).collate_kw
        assert kw["augment"] and kw["hsv_prob"] == 1.0 and kw["flip_prob"] == 0.5
        assert kw["rng"] is trainer.rng
    iters = len(trainer.dataset.res)
    got = exp.get_lr_schedule(iters)
    want = jlr.yolox_warm_cos_lr(exp.basic_lr_per_img * exp.batch_size, exp.min_lr_ratio,
                                 iters * exp.max_epoch, iters * exp.warmup_epochs,
                                 exp.warmup_lr, iters * exp.no_aug_epochs)
    for it in range(iters * exp.max_epoch):
        assert got(it) == pytest.approx(float(want(it)), abs=1e-9)
    tail = [got(it) for it in range(iters * (exp.max_epoch - exp.no_aug_epochs),
                                    iters * exp.max_epoch)]
    assert tail == [tail[0]] * len(tail) and tail[0] > 0


@pytest.mark.parametrize("input_size", [(576, 576), (128, 128), (576, 1024)])
def test_multiscale_sizes_match_jax(input_size):
    """random_input_size under the same Random(step) and the trainer's
    cadence (a new size when n % 10 == 0, from the updates made) give
    JAX's sizes."""
    from tscd_tpu.exp.tscd_base import Exp as JExp
    jexp, exp = JExp(), selftest_exp()
    jexp.input_size = exp.input_size = input_size
    for step in range(300):
        assert exp.random_input_size(random.Random(step)) == \
            jexp.random_input_size(random.Random(step)), step
    trainer = exp.get_trainer(device="cpu")
    trainer.state = type("State", (), {"step": 0})()
    want, size = [], None
    for epoch_start in (0, 37):
        for n in range(25):
            trainer.state.step = epoch_start + n
            if n % 10 == 0 or size is None:
                size = jexp.random_input_size(random.Random(epoch_start + n))
            want.append(size)
            assert trainer.multiscale_size(n) == size
    assert len(set(want)) > 1


def test_a_multiscale_epoch_trains_at_jax_sizes(tmp_path, monkeypatch):
    """One augmented epoch of the selftest exp from the fixture's files with
    multiscale on: each step's frames come at the size of JAX's rule, with
    the pixels of JAX's resize of the same window."""
    from tscd_tpu.exp.tscd_base import Exp as JExp
    exp = selftest_exp()
    exp.output_dir, exp.enable_multiscale, exp.multiscale_step = str(tmp_path), True, 32
    exp.max_epoch, exp.eval_interval, exp.hsv_prob = 1, 5, 1.0
    jexp = JExp()
    jexp.input_size, jexp.multiscale_step = exp.input_size, 32
    trainer = exp.get_trainer(device="cpu")
    sizes, resized, step_fn = [], [], trainer.step

    def step(frames, labels, te):
        sizes.append((trainer.state.step, tuple(frames.shape[1:3])))
        return step_fn(frames, labels, te)

    def resize(imgs, labels, target):
        """The port's resize of the window, held to JAX's of the same window
        as JAX's trainer holds it (float32)."""
        got = pvid.multiscale_resize(imgs, labels, target)
        want = jvid.multiscale_resize(imgs.astype(np.float32), labels, target)
        assert np.array_equal(np.asarray(got[0], np.float32), want[0])
        assert np.array_equal(got[1], want[1])
        resized.append(got[0].dtype)
        return got

    monkeypatch.setattr(trainer_mod, "multiscale_resize", resize)
    trainer.step = step
    trainer.train()
    assert len(sizes) == len(resized) == len(trainer.dataset.res) > 1
    assert np.dtype(np.float32) in resized
    for n, (s, hw) in enumerate(sizes):
        assert hw == jexp.random_input_size(random.Random(s - n % 10)), (n, hw)


# -- JAX's msgpack checkpoints ----------------------------------------------

def test_the_msgpack_reader_equals_flax(monkeypatch):
    from flax import serialization

    from tscd_torch.utils.flax_msgpack import msgpack_restore
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "YOLOX_outputs", "validate_ref", "converted_ckpt.msgpack")
    data = open(path, "rb").read()
    got, want = msgpack_restore(data), serialization.msgpack_restore(data)
    flat_g, flat_w = traverse_util.flatten_dict(got), traverse_util.flatten_dict(want)
    assert flat_g.keys() == flat_w.keys() and len(flat_w) > 500
    for k, w in flat_w.items():
        assert flat_g[k].dtype == w.dtype and np.array_equal(flat_g[k], w), k
    m = EXP.get_model(device="cpu")
    sd_g = load_checkpoint(path, m)["model"]
    sd_w = state_dict_from_flax(want, m.state_dict())
    assert sd_g.keys() == sd_w.keys() == m.state_dict().keys()
    assert all(torch.equal(sd_g[k], sd_w[k]) for k in sd_w)
    # every kind of leaf flax writes, and an array split into chunks
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(50, dtype=np.float32).reshape(5, 10), "s": np.float32(2.5),
            "i": np.int32(-7), "c": 1 - 2j, "n": None, "b": True, "x": -3, "big": 2 ** 40,
            "f": 0.25, "t": "text" * 10, "e": {}, "u": {"v": np.zeros((0, 3), np.uint8)}}
    back = msgpack_restore(serialization.msgpack_serialize(dict(tree)))
    ref = serialization.msgpack_restore(serialization.msgpack_serialize(dict(tree)))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
        elif isinstance(v, dict):
            assert str(back[k]) == str(v)
        else:
            assert type(back[k]) is type(v) and back[k] == v, k


def test_a_step_resumed_from_a_jax_checkpoint_matches_jax(jax_model, tmp_path):
    """JAX's trainer saves a checkpoint (EMA params, raw params, batch
    stats, opt_state with non-zero traces, start_epoch 2) in its msgpack
    format; JAX's resume (load_tolerant, restore_opt_state, step =
    start_epoch x iters) takes one step, and the port's trainer resumes
    from the same file and takes the same step: losses 1e-5 relative,
    updates and EMA 1e-4 of the largest update plus the fp32 spacing."""
    from flax import serialization

    from tscd_tpu.train import checkpoint as jckpt
    jm, variables = jax_model
    rng, x, te = _window()
    exp = selftest_exp()
    exp.output_dir, exp.max_epoch, exp.no_aug_epochs = str(tmp_path), 7, 2   # the recipe's
    epoch = 2
    count = epoch * ITERS
    jsched = jlr.yolox_warm_cos_lr(exp.basic_lr_per_img * exp.batch_size, exp.min_lr_ratio,
                                   ITERS * exp.max_epoch, ITERS * exp.warmup_epochs,
                                   exp.warmup_lr, ITERS * exp.no_aug_epochs)
    tx = build_sgd(jsched, freeze_prefixes=exp.freeze_prefixes(),
                   stem_lr_prefixes=exp.stem_lr_prefixes(), stem_lr_ratio=exp.stem_lr_ratio)
    # the saved run: an update of random gradients (non-zero traces), the
    # EMA moved off the raw weights, the schedules' counts at `count`
    g0 = _grad_trees(variables, np.random.default_rng(3), 5.0)[0]
    opt0 = tx.update(g0, tx.init(variables["params"]), variables["params"])[1]
    raw = jax.tree_util.tree_map(lambda a: a + np.float32(1e-3), variables["params"])
    opt_sd = serialization.to_state_dict(opt0)

    def set_count(t):
        return {k: (np.int32(count) if k == "count" else set_count(v)) for k, v in t.items()} \
            if isinstance(t, dict) else t
    jckpt.save_checkpoint({"start_epoch": np.int32(epoch), "params": variables["params"],
                           "raw_params": raw, "batch_stats": variables["batch_stats"],
                           "opt_state": set_count(opt_sd)}, str(tmp_path / "jax"))
    path = str(tmp_path / "jax" / "latest_ckpt.msgpack")

    # JAX's resume (tscd_tpu/core/tscd_trainer.py:_init_state) and step
    restored = jckpt.load_checkpoint(path)
    jvars = {"params": jckpt.load_tolerant(variables["params"], restored["params"]),
             "batch_stats": jckpt.load_tolerant(variables["batch_stats"],
                                                restored["batch_stats"])}
    state = jinit_state(jvars, tx)
    state = state._replace(opt_state=jckpt.restore_opt_state(state.opt_state,
                                                             restored["opt_state"]),
                           step=jnp.asarray(count, jnp.int32))
    pm0 = _port_model(variables)
    lab = _gate_labels(pm0, x, te, rng)
    bs = jvars["batch_stats"]
    (_, jlosses), grads = _jax_loss_and_grad(jm, True)(state.params, bs, x, te, lab)
    upd, _ = jax.jit(tx.update)(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, upd)
    new_step = state.step + 1
    ema_p = jema(state.ema_params, params, new_step, exp.ema_decay)
    ema_b = jema(state.ema_batch_stats, bs, new_step, exp.ema_decay)

    # the port's trainer resumes from the same file
    args = type("Args", (), {"resume": True, "ckpt": path})()
    trainer = exp.get_trainer(args, device="cpu")
    trainer._init_state(ITERS)
    st, pm = trainer.state, trainer.model
    assert trainer.start_epoch == epoch and st.step == count
    named = dict(pm.named_parameters())
    tmpl = pm.state_dict()
    # the momentum: each group's trace tree of the JAX state, merged and
    # carried over by name
    traces = {}
    for sub in state.opt_state[2].inner_states.values():
        is_trace = lambda t: isinstance(t, optax.TraceState)   # noqa: E731
        for leaf in jax.tree_util.tree_leaves(sub, is_leaf=is_trace):
            if is_trace(leaf):
                flat = traverse_util.flatten_dict(serialization.to_state_dict(leaf.trace))
                traces.update({k: np.asarray(v) for k, v in flat.items() if not isinstance(v, dict)})
    want_trace = state_dict_from_flax({"params": traverse_util.unflatten_dict(traces)}, named,
                                      strict=False)
    assert sorted(want_trace) == sorted(st.optimizer.trained)
    for n in st.optimizer.trained:
        assert torch.equal(st.optimizer.trace[n], want_trace[n]) and want_trace[n].abs().sum() > 0, n
    ema0 = state_dict_from_flax({"params": restored["params"], "batch_stats": bs}, tmpl)
    assert all(torch.equal(st.ema.state[k], ema0[k]) for k in ema0)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    got = trainer.step(T(x), T(lab), T(te))
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    want = state_dict_from_flax({"params": params, "batch_stats": bs}, tmpl)
    d_want = {k: want[k].double() - before[k].double() for k in named}
    dmax = max(float(d.abs().max()) for d in d_want.values())
    assert dmax > 0
    after = pm.state_dict()
    jema_sd = state_dict_from_flax({"params": ema_p, "batch_stats": ema_b}, tmpl)
    for k, v in list(after.items()) + [(f"ema:{k}", st.ema.state[k]) for k in named]:
        ref = jema_sd[k[4:]] if k.startswith("ema:") else want.get(k)
        if ref is None or not v.is_floating_point():
            continue
        bound = 1e-4 * dmax + np.spacing(np.abs(ref.numpy()))
        assert np.all(np.abs(v.double().numpy() - ref.double().numpy()) <= bound), k
