"""The port's YOLOV family training against the JAX package on the CPU,
at the size of tests/test_yolov.py (depth 0.33, width 0.125, 64 px,
P = 8, 4 frames, 2 heads), on inputs made from numpy seeds:

  - yolov_loss (losses.py:206-268) on the same head outputs, every frame
    refined with the obj logits and 2 of 4 frames without them: each term
    1e-5 relative, and its gradient with respect to the raw outputs and
    the refined logits 1e-5 of the largest;
  - one YOLOVTrainer step of YOLOV++ (msa, decouple_reg: two attention
    calls, each with the plain-recompute backward, q = k = 32), lframe 0,
    past warm-up, from the same seeded weights and window as JAX's window
    loss (yolov_trainer.py:41-66, fix_bn) and build_sgd's update: the
    losses 1e-5 relative, the gradients 1e-4 of the largest, the updated
    parameters and the EMA 1e-4 of the largest update plus the fp32
    spacing of the parameter (the final add rounds to it); the stems of
    JAX's `towers` module take the base LR, as JAX's prefixes give them;
  - the YOLOV trainer's epoch on the committed fixture through the
    vid_train CLI (yolov_selftest), and its evaluation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tscd_tpu.models.tscd_head import select_frame_proposals as jselect
from tscd_tpu.models.yolov import YOLOVPlus as JYOLOVPlus
from tscd_tpu.ops.decode import decode_outputs as jdecode
from tscd_tpu.train import lr as jlr
from tscd_tpu.train.ema import ema_update as jema
from tscd_tpu.train.losses import yolov_loss as jyolov_loss
from tscd_tpu.train.optim import build_sgd
from tscd_tpu.train.step import init_train_state as jinit_state
from tscd_torch.exp import get_exp_by_name
from tscd_torch.models.tscd_head import FrameProposals
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.train.losses import yolov_loss
from tscd_torch.train.step import init_train_state
from tscd_torch.utils.convert import state_dict_from_flax
from torch_port_util import labels_near, seeded_variables

T = torch.as_tensor
F, P, C = 4, 8, 30
HW = [(8, 8), (4, 4), (2, 2)]              # 64 px at strides 8, 16, 32
STRIDES = (8, 16, 32)
A = sum(h * w for h, w in HW)
ITERS, STEP = 4, 5                         # past the one warm-up epoch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("R,obj", [(F, True), (2, False)])
def test_yolov_loss_and_its_gradient_match_jax(R, obj):
    rng = np.random.default_rng(11)
    raw = rng.normal(0, 1, (F, A, 5 + C)).astype(np.float32)
    raw[..., 4:] -= 2.0
    dec = np.asarray(jdecode(jnp.asarray(raw), HW, STRIDES))
    decoded = np.concatenate([dec[..., :4], 1 / (1 + np.exp(-dec[..., 4:]))], -1)
    props = jselect(jnp.asarray(decoded), C, P, 0.001, 0.75, False, P)
    lab = labels_near(rng, np.asarray(props.boxes)[:, :3], F, C, size=64)
    cls_l = rng.normal(0, 1, (R, P, C)).astype(np.float32)
    obj_l = rng.normal(0, 1, (R, P)).astype(np.float32)

    def jfn(raw_, cls_, obj_):
        out = {"raw_outputs": raw_, "hw": HW, "proposals": props,
               "refined_cls_logits": cls_}
        if obj:
            out["refined_obj_logits"] = obj_
        losses = jyolov_loss(out, jnp.asarray(lab), STRIDES, R)
        return losses["total_loss"], losses
    (_, jl), jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(raw), jnp.asarray(cls_l), jnp.asarray(obj_l))

    ins = [T(a).requires_grad_(True) for a in (raw, cls_l, obj_l)]
    pprops = FrameProposals(*(T(np.asarray(t)) for t in props))
    out = {"raw_outputs": ins[0], "hw": HW, "proposals": pprops,
           "refined_cls_logits": ins[1]}
    if obj:
        out["refined_obj_logits"] = ins[2]
    got = yolov_loss(out, T(lab), STRIDES, R)
    assert set(got) == set(jl)
    for k, v in jl.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(jl["loss_refined_cls"]) > 0
    assert (float(jl["loss_refined_obj"]) > 0) == obj
    grads = torch.autograd.grad(got["total_loss"], ins, allow_unused=True)
    for name, g, w in zip(("raw", "cls", "obj"), grads, jg):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)


def _plus_exp():
    exp = get_exp_by_name("yolov_selftest")
    exp.model_family, exp.agg_type, exp.reconf, exp.decouple_reg = "yolov_plus", "msa", \
        True, True
    exp.no_aug_epochs = 0               # STEP sits at the peak of the cosine
    return exp


def test_one_yolov_trainer_step_matches_jax():
    exp = _plus_exp()
    jm = JYOLOVPlus(num_classes=C, depth=exp.depth, width=exp.width, num_proposals=P,
                    heads=exp.heads, agg_type="msa", reconf=True, decouple_reg=True)
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 255, (F, 64, 64, 3)).astype(np.float32)
    te = get_timing_signal_1d(np.arange(F, dtype=np.float32), 256).astype(np.float32)
    variables = seeded_variables(jm, 13, jnp.zeros((F, 64, 64, 3)), 0, F,
                                 jnp.zeros((F, 256)))
    trainer = exp.get_trainer(device="cpu")
    pm = trainer.model
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    with torch.no_grad():
        boxes = pm(T(x), 0, F, T(te))["proposals"].boxes[:, :3].numpy()
    lab = labels_near(rng, boxes, F, C, size=64)

    jsched = jlr.yolox_warm_cos_lr(exp.basic_lr_per_img * exp.batch_size, exp.min_lr_ratio,
                                   ITERS * exp.max_epoch, ITERS * exp.warmup_epochs,
                                   exp.warmup_lr, 0)
    tx = build_sgd(lambda i: jsched(i + STEP), freeze_prefixes=exp.freeze_prefixes(),
                   stem_lr_prefixes=exp.stem_lr_prefixes(), stem_lr_ratio=exp.stem_lr_ratio)
    state = jinit_state(variables, tx)
    bs = variables["batch_stats"]

    def loss_fn(params):
        out = jm.apply({"params": params, "batch_stats": bs}, jnp.asarray(x), 0, F,
                       jnp.asarray(te), False)
        losses = jyolov_loss(out, jnp.asarray(lab), STRIDES, F)
        return losses["total_loss"], losses
    (_, jlosses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    upd, _ = jax.jit(tx.update)(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, upd)
    ema_p = jema(state.ema_params, params, jnp.asarray(STEP + 1, jnp.int32), exp.ema_decay)
    ema_b = jema(state.ema_batch_stats, bs, jnp.asarray(STEP + 1, jnp.int32), exp.ema_decay)

    opt = exp.get_optimizer(pm, ITERS)
    opt.count = STEP
    assert opt.lr() == pytest.approx(float(jsched(STEP))) and opt.lr() > 0
    assert all(not lab_.startswith("stem") for n, lab_ in opt.labels.items()
               if n.startswith("head.stems."))
    trainer.state = init_train_state(pm, opt, exp.ema_decay)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    raw = {}
    sgd_step = opt.step

    def step():                 # the gradients as backward leaves them
        raw.update({n: p.grad.clone() for n, p in pm.named_parameters() if p.grad is not None})
        sgd_step()
    opt.step = step
    got = trainer.step(T(x), T(lab), T(te))

    for k, v in jlosses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(jlosses["loss_refined_cls"]) > 0 and float(jlosses["loss_refined_obj"]) > 0
    tmpl = pm.state_dict()
    jg = state_dict_from_flax({"params": grads, "batch_stats": bs}, tmpl)
    named = dict(pm.named_parameters())
    gmax = max(float(jg[n].abs().max()) for n in named if not n.startswith("backbone"))
    for n, p in named.items():
        if n.startswith("backbone"):
            assert n not in raw          # stop_backbone_grad: the backbone is frozen
            continue
        g = raw.get(n, torch.zeros_like(p))
        np.testing.assert_allclose(g.numpy(), jg[n].numpy(), rtol=0, atol=1e-4 * gmax,
                                   err_msg=n)
    assert "head.agg_iou.msa.qkv_reg.weight" in raw
    want = state_dict_from_flax({"params": params, "batch_stats": bs}, tmpl)
    after = pm.state_dict()
    dmax = max(float((want[k].double() - before[k].double()).abs().max()) for k in named)
    assert dmax > 0

    def close(got_t, want_t, k):
        bound = 1e-4 * dmax + np.spacing(np.abs(want_t.numpy()))
        assert np.all(np.abs(got_t.double().numpy() - want_t.double().numpy()) <= bound), k

    for k in named:
        close(after[k], want[k], k)
        if k.startswith("backbone"):
            assert torch.equal(after[k], before[k])
    jema_sd = state_dict_from_flax({"params": ema_p, "batch_stats": ema_b}, tmpl)
    for k, v in trainer.state.ema.state.items():
        if not k.endswith("num_batches_tracked"):
            close(v, jema_sd[k], k)


def test_vid_train_cli_trains_and_evaluates_the_selftest(tmp_path):
    """vid_train on yolov_selftest: the last of its 2 epochs on the
    committed fixture (0 + 4 frame windows, HSV jitter and flip), the
    checkpoint written, the EMA weights evaluated at lframe 0."""
    from tscd_torch.tools import vid_train
    state = vid_train.main(["--exp", "yolov_selftest", "--device", "cpu", "-e", "1",
                            "output_dir", str(tmp_path)])
    assert state.step == 8           # 4 windows an epoch, from epoch 1
    assert (tmp_path / "yolov_selftest" / "latest_ckpt.pth").exists()
    for p in state.model.parameters():
        assert torch.isfinite(p).all()
