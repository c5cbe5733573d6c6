"""The port's stage-2 training knobs against the JAX package on the CPU, at
the selftest width (depth 0.33, width 0.125, P = 6, 2 + 2 frames, 128
px), weights and windows made from numpy seeds. Each JAX function is
built once (module-scoped) and jitted, as JAX's trainer runs it.

Tolerances, each with its reason:
  - one BN layer in train mode against flax's nn.BatchNorm (jitted): the
    new running mean and variance within 1e-6 of the largest value
    (torch's own train-mode BN, which updates with the unbiased variance,
    is far off), the output likewise against flax's with its batch sums
    pairwise (`torch_port_util.pairwise_batch_stats`); the port
    computes flax's biased E[x^2] - E[x]^2, which on a channel with a
    large mean keeps fewer digits than Welford;
  - train-mode BN in the whole model: XLA:CPU sums a batch mean with an
    error near 1e-6 of it, ten times torch's, and the fast variance turns
    that into 2e-4 of the variance of a stem channel whose mean is ten
    times its spread, which the layers after it carry to 1e-4 of the
    raw outputs; so the JAX side of every fix_bn=False comparison sums
    its batch statistics pairwise (flax's formula otherwise), and
    `test_train_mode_statistics_are_closer_to_float64_than_xla_cpu`
    holds the port's own sums;
  - fix_bn=False (train-mode BN, JAX's mutable batch_stats step,
    tscd_trainer.py:159-165): the forward's raw outputs and refined logits
    and the new batch_stats within 1e-4 of each tensor's largest value;
    losses 1e-4 relative; gradients 1e-4 of the largest; parameter
    updates and EMA 1e-4 of the largest update plus the parameter's fp32
    spacing (the final add rounds to it), as tests/test_torch_port_train.py
    holds the fix_bn step;
  - the stem's backward against jax.vjp of JAX's focus_stem (its forward
    the Pallas kernel in interpret mode, its backward `_bwd`): the x, w3,
    scale and shift gradients within 1e-5 of each one's largest value, at
    fp32 and at a bf16 output (both backwards are the fp32 recompute);
  - stop_backbone_grad=False under fix_bn: every gradient, the backbone's
    included, and the step's updates as the fix_bn=False step's bounds;
    its updates equal the stop_backbone_grad=True step's (both freeze the
    backbone; as tests/test_remat.py:55 pins for JAX, rtol 1e-5 and 1e-6
    of the largest parameter);
  - remat: the same loss (1e-6 relative) and gradients (rtol 1e-5, atol
    1e-6) as without it (tests/test_remat.py:16), at fix_bn and in train
    mode, whose statistics it leaves as one forward gives them;
  - B = 2 windows a step, with and without grad_accum = 2, at fix_bn and
    fix_bn=False, against JAX's batched step (each window through JAX's
    jitted window loss, as vmap runs it, and the means, SGD and EMA of
    tscd_trainer.py:170-252; two jitted programs serve the whole file):
    losses (the windows' mean) 1e-4 relative, updates, EMA and
    batch_stats as above; the LR is the schedule's x B; the loader's
    batch_windows stacks as JAX's does (tests/test_trainer_mesh.py:364,388).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tscd_tpu.data import vid as jvid
from tscd_tpu.exp.tscd_base import Exp as JExp
from tscd_tpu.models import blocks as jblk
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.ops.pallas import focus_stem as jfs
from tscd_tpu.train.ema import ema_update as jema
from tscd_tpu.train.losses import tscd_loss as jloss
from tscd_tpu.train.step import init_train_state as jinit_state
from tscd_torch.data import vid as pvid
from tscd_torch.exp.tscd_large import selftest_exp
from tscd_torch.models import blocks as pblk
from tscd_torch.ops.kernels import focus_stem as pfs
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.train.step import init_train_state, train_step
from tscd_torch.utils.convert import state_dict_from_flax
from torch_port_util import labels_near, pairwise_batch_stats, seeded_variables

EXP = selftest_exp()
L, G = EXP.lframe, EXP.gframe
F = L + G
C, P = EXP.num_classes, EXP.num_proposals
STRIDES = (8, 16, 32)
ITERS, STEP = 4, 5                 # an epoch of 4 steps; STEP is past warm-up
T = torch.as_tensor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs files in several
    processes at once, where each torch's thread pool would contend for the
    same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(**knobs):
    exp = selftest_exp()
    exp.no_aug_epochs = 0
    for k, v in knobs.items():
        setattr(exp, k, v)
    return exp


def _jax_exp(exp):
    """JAX's exp with the port exp's schedule and groups."""
    j = JExp()
    for k in ("basic_lr_per_img", "batch_size", "max_epoch", "warmup_epochs", "warmup_lr",
              "no_aug_epochs", "min_lr_ratio", "scheduler", "momentum", "weight_decay",
              "stem_lr_ratio", "ema_decay"):
        setattr(j, k, getattr(exp, k))
    return j


def _jmodel(**kw):
    return JTSCD(num_classes=C, depth=EXP.depth, width=EXP.width, num_proposals=P,
                 minimal_limit=EXP.minimal_limit, heads=EXP.heads, **kw)


def _window(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (F, 128, 128, 3)).astype(np.float32)
    te = get_timing_signal_1d(np.arange(F, dtype=np.float32), 256)
    return rng, x, te


@pytest.fixture(scope="module")
def variables():
    _, x, te = _window(5)
    return seeded_variables(_jmodel(), 0, jnp.asarray(x), jnp.asarray(te), L, G, False)


def _port(variables, exp):
    pm = exp.get_model(device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    return pm


def _labels(pm, x, te, rng, train, k=3):
    """Gts near the port model's own first k proposals of each local frame
    (in the BN mode the step runs)."""
    with torch.no_grad():
        boxes = pm(T(x), T(te), L, G, train=train)["proposals"].boxes[:L, :k].numpy()
    return labels_near(rng, boxes, F, C)


def _sd(variables, tmpl):
    return state_dict_from_flax(variables, tmpl)


def _max(ts):
    return max(float(t.abs().max()) for t in ts)


def _close_update(got, want, before, names, tol=1e-4):
    """Each tensor of `got` within tol x the largest update of `want` plus
    the fp32 spacing of its value."""
    dmax = _max([want[k].double() - before[k].double() for k in names])
    assert dmax > 0
    for k in names:
        bound = tol * dmax + np.spacing(np.abs(want[k].numpy()))
        err = np.abs(got[k].double().numpy() - want[k].double().numpy())
        assert np.all(err <= bound), (k, float((err - bound).max()))


def _step_and_grads(exp, pm, frames, labels, te, fix_bn=True, window_batch=1, trainer=False):
    """One port step from update STEP (through `TSCDTrainer.step`, which
    takes fix_bn from the exp, where `trainer`); returns the losses, the
    state before and after, the EMA and the gradients as backward leaves
    them."""
    opt = exp.get_optimizer(pm, ITERS, window_batch=window_batch)
    opt.count = STEP
    st = init_train_state(pm, opt, exp.ema_decay)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    raw, sgd_step = {}, opt.step

    def step():
        raw.update({n: p.grad.clone() for n, p in pm.named_parameters() if p.grad is not None})
        sgd_step()
    opt.step = step
    if trainer:
        tr = exp.get_trainer(device="cpu")
        tr.state = st
        losses = tr.step(T(frames), T(labels), T(te))
    else:
        losses = train_step(st, T(frames), T(labels), T(te), L, G, fix_bn=fix_bn)
    return ({k: float(v) for k, v in losses.items()}, before, pm.state_dict(),
            st.ema.state_dict(), raw)


def _jax_sched(exp, window_batch=1):
    from tscd_tpu.train import lr as jlr
    s = jlr.yolox_warm_cos_lr(exp.basic_lr_per_img * exp.batch_size, exp.min_lr_ratio,
                              ITERS * exp.max_epoch, ITERS * exp.warmup_epochs,
                              exp.warmup_lr, ITERS * exp.no_aug_epochs)
    return lambda i: s(i + STEP) * window_batch


def _jax_update(exp, variables, grads, bs):
    """JAX's SGD update and EMA (tscd_trainer.py:227-244) from update STEP."""
    import optax

    from tscd_tpu.train.optim import build_sgd
    tx = build_sgd(_jax_sched(exp), freeze_prefixes=exp.freeze_prefixes(),
                   stem_lr_prefixes=exp.stem_lr_prefixes(), stem_lr_ratio=exp.stem_lr_ratio)
    state = jinit_state(variables, tx)
    upd, _ = jax.jit(tx.update)(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, upd)
    t = jnp.asarray(STEP + 1, jnp.int32)
    return params, jema(state.ema_params, params, t, exp.ema_decay), \
        jema(state.ema_batch_stats, bs, t, exp.ema_decay)


# -- one BatchNorm layer in train mode --------------------------------------

def test_batch_norm_train_mode_matches_flax():
    """Activations whose channel means (-3.5 to 3.5) are up to a few times
    their spread, as a conv's outputs are."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8, 12, 12)).astype(np.float32)
    x += np.linspace(-3.5, 3.5, 8, dtype=np.float32)[None, :, None, None]
    bn = torch.nn.BatchNorm2d(8, eps=1e-5).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            t.copy_(T(rng.uniform(0.5, 1.5, 8).astype(np.float32)))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                        dtype=jnp.float32)
    variables = {"params": {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy()},
                 "batch_stats": {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}}
    apply = lambda v, a: jbn.apply(v, a, mutable=["batch_stats"])  # noqa: E731
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    _, mut = jax.jit(apply)(variables, xj)
    with pairwise_batch_stats():
        want = np.asarray(jax.jit(lambda v, a: jbn.apply(v, a, mutable=["batch_stats"]))(
            variables, xj)[0])
    stats = {}
    got = pblk.batch_norm(bn, T(x), stats)
    new_mean, new_var = stats[bn]
    w_mean, w_var = (np.asarray(mut["batch_stats"][k]) for k in ("mean", "var"))
    np.testing.assert_allclose(new_mean.numpy(), w_mean, rtol=0, atol=1e-6 * np.abs(w_mean).max())
    np.testing.assert_allclose(new_var.numpy(), w_var, rtol=0, atol=1e-6 * np.abs(w_var).max())
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # torch's own train mode (the unbiased variance in the update) is far
    # off; and the module's buffers are left as they were
    torch_bn = torch.nn.BatchNorm2d(8, eps=1e-5, momentum=0.1)
    torch_bn.load_state_dict(bn.state_dict())
    torch_bn.train()(T(x))
    assert np.abs(torch_bn.running_var.detach().numpy() - w_var).max() > 1e-4 * np.abs(w_var).max()
    assert torch.equal(bn.running_var, T(variables["batch_stats"]["var"]))


def test_train_mode_statistics_are_closer_to_float64_than_xla_cpu(variables):
    """The stem's 6x6 conv output on a noise window (channel means several
    times their spread): the port's batch variance (flax's formula over
    torch's sums) stays within 2e-6 of float64's, while jitted flax on
    XLA:CPU's sums of the same values errs by more than 5e-6; hence the
    pairwise sums on the JAX side of the model comparisons."""
    from tscd_torch.ops.kernels.focus_stem import rearrange_weight
    pm = _port(variables, _exp())
    conv = pm.backbone.backbone.stem.conv
    _, x, _ = _window(7)
    with torch.no_grad():
        y = torch.nn.functional.conv2d(T(x).permute(0, 3, 1, 2), rearrange_weight(conv.conv.weight),
                                       stride=2, padding=2)
    exact = y.double().var((0, 2, 3), unbiased=False).numpy()
    stats = {}
    pblk.batch_norm(conv.bn, y, stats)
    old = conv.bn.running_var.double().numpy()
    port = (stats[conv.bn][1].double().numpy() - 0.9 * old) / 0.1
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    v = {"params": {"scale": conv.bn.weight.detach().numpy(), "bias": conv.bn.bias.detach().numpy()},
         "batch_stats": {"mean": conv.bn.running_mean.numpy(), "var": conv.bn.running_var.numpy()}}
    _, mut = jax.jit(lambda v, a: jbn.apply(v, a, mutable=["batch_stats"]))(
        v, jnp.asarray(y.numpy().transpose(0, 2, 3, 1)))
    xla = (np.asarray(mut["batch_stats"]["var"], np.float64) - 0.9 * old) / 0.1
    mean = y.double().mean((0, 2, 3)).abs().numpy()
    assert (mean / np.sqrt(exact)).max() > 3
    port_err, xla_err = (float((np.abs(a - exact) / exact).max()) for a in (port, xla))
    assert port_err < 2e-6 < 5e-6 < xla_err, (port_err, xla_err)


def test_train_mode_base_conv_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 16, 16)).astype(np.float32)
    jm = jblk.BaseConv(16, 3, 2)
    pm = pblk.BaseConv(8, 16, 3, 2)
    v = seeded_variables(jm, 1, jnp.asarray(x.transpose(0, 2, 3, 1)))
    pm.load_state_dict(_sd(v, pm.state_dict()))
    want, mut = jax.jit(lambda v, a: jm.apply(v, a, True, mutable=["batch_stats"]))(
        v, jnp.asarray(x.transpose(0, 2, 3, 1)))
    stats = {}
    got = pm(T(x), stats)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    for k, t in zip(("mean", "var"), stats[pm.bn]):
        w = np.asarray(mut["batch_stats"]["bn"][k])
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())


# -- JAX's window loss and gradients, jitted once each -----------------------

@functools.lru_cache(maxsize=None)
def _jax_window_fn(kind):
    """jit(value_and_grad) of JAX's one-window loss as its trainer takes it
    (tscd_trainer.py:_window_losses): "bn" train-mode BN (mutable
    batch_stats, stop_backbone_grad), "open" fix_bn with the backbone's
    gradient (stop_backbone_grad=False). fn(params, bs, x, te, lab) ->
    ((loss, (losses, new batch_stats, raw_outputs, refined_cls_logits)),
    grads). "bn" sums its batch statistics pairwise (`pairwise_batch_stats`)."""
    train = kind == "bn"
    jm = _jmodel(stop_backbone_grad=train)

    def loss_fn(params, bs, x, te, lab):
        if train:
            out, mut = jm.apply({"params": params, "batch_stats": bs}, x, te, L, G, True,
                                labels=lab, mutable=["batch_stats"])
            bs = mut["batch_stats"]
        else:
            out = jm.apply({"params": params, "batch_stats": bs}, x, te, L, G, False, labels=lab)
        losses = jloss(out, lab, STRIDES, L)
        return losses["total_loss"], (losses, bs, out["raw_outputs"], out["refined_cls_logits"])

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def call(*args):
        with pairwise_batch_stats() if train else contextlib.nullcontext():
            return fn(*args)
    return call


# -- fix_bn=False: train-mode BN, JAX's mutable batch_stats step ------------

@pytest.fixture(scope="module")
def bn_case(variables):
    """JAX's fix_bn=False window loss (mutable batch_stats), its gradients,
    SGD update and EMA; and the port's forward, statistics and step on the
    same weights and window."""
    exp = _exp(fix_bn=False)
    rng, x, te = _window(7)
    pm = _port(variables, exp)
    lab = _labels(pm, x, te, rng, train=True, k=P)
    (_, (jl, new_bs, raw, refined)), grads = _jax_window_fn("bn")(
        variables["params"], variables["batch_stats"], x, te, lab)
    params, ema_p, ema_b = _jax_update(exp, variables, grads, new_bs)
    with torch.no_grad():
        out = pm(T(x), T(te), L, G, train=True)
    fwd = {"raw_outputs": out["raw_outputs"], "refined_cls_logits": out["refined_cls_logits"],
           "batch_stats": out["batch_stats"]}
    step = _step_and_grads(exp, pm, x, lab, te, fix_bn=False)
    tmpl = pm.state_dict()
    return dict(fwd=fwd, step=step, jlosses=jl, jraw=np.asarray(raw), jrefined=np.asarray(refined),
                jbs=_sd({"params": variables["params"], "batch_stats": new_bs}, tmpl),
                jgrads=_sd({"params": grads, "batch_stats": variables["batch_stats"]}, tmpl),
                jparams=_sd({"params": params, "batch_stats": new_bs}, tmpl),
                jema=_sd({"params": ema_p, "batch_stats": ema_b}, tmpl),
                names=[n for n, _ in pm.named_parameters()])


def test_train_mode_forward_and_batch_stats_match_jax(bn_case):
    fwd = bn_case["fwd"]
    for k, want in (("raw_outputs", bn_case["jraw"]), ("refined_cls_logits", bn_case["jrefined"])):
        np.testing.assert_allclose(fwd[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    stats = fwd["batch_stats"]
    running = [k for k in bn_case["jbs"] if ".running_" in k]
    assert sorted(stats) == sorted(running) and len(running) > 100
    before = bn_case["step"][1]
    moved = 0
    for k in running:
        want = bn_case["jbs"][k]
        np.testing.assert_allclose(stats[k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()), err_msg=k)
        moved += not torch.equal(stats[k], before[k])
    assert moved == len(running)


def test_fix_bn_false_step_matches_jax(bn_case):
    losses, before, after, ema, raw = bn_case["step"]
    for k, v in bn_case["jlosses"].items():
        np.testing.assert_allclose(losses[k], float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    # with batch statistics these random weights predict boxes several
    # frames wide, so no proposal is a SimOTA foreground and the refined
    # class and offset terms are 0 here; the base terms drive every BN of
    # the head, and the fix_bn steps drive the refined ones
    assert losses["iou_loss"] > 0 and losses["loss_matched_obj"] > 0
    jg = bn_case["jgrads"]
    names = bn_case["names"]
    gmax = _max([jg[n] for n in names])
    for n in names:
        if n.startswith("backbone"):
            assert n not in raw                # stop_backbone_grad
            continue
        g = raw.get(n, torch.zeros_like(jg[n]))       # JAX's zeros where unused
        np.testing.assert_allclose(g.numpy(), jg[n].numpy(), rtol=0, atol=1e-4 * gmax,
                                   err_msg=n)
    want = bn_case["jparams"]
    _close_update(after, want, before, names)
    # the running statistics took the window's new ones; the EMA follows
    for k in want:
        if ".running_" in k:
            np.testing.assert_allclose(after[k].numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-4 * float(want[k].abs().max()), err_msg=k)
    _close_update({k: ema[k] for k in names}, {k: bn_case["jema"][k] for k in names},
                  before, names)
    for k in want:
        if ".running_" in k:
            w = bn_case["jema"][k]
            np.testing.assert_allclose(ema[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-4 * float(w.abs().max()), err_msg=k)


def test_train_mode_stem_runs_the_conv_route_and_no_kernel(variables):
    """Train-mode BN takes JAX's XLA conv route (blocks.py:573-577): the
    stem's wrapper is not called, and its output equals the conv, BN and
    SiLU written out."""
    exp = _exp(fix_bn=False)
    pm = _port(variables, exp)
    _, x, _ = _window(8)
    n0 = pfs.focus_stem.launches
    calls = []
    orig = pfs._forward
    pfs._forward = lambda *a: calls.append(1) or orig(*a)
    try:
        stats = {}
        with torch.no_grad():
            got = pm.backbone.backbone.stem(T(x), stats)
            pm.backbone.backbone.stem(T(x))
    finally:
        pfs._forward = orig
    assert pfs.focus_stem.launches == n0 and len(calls) == 1      # the eval call only
    conv = pm.backbone.backbone.stem.conv
    xs = pfs.space_to_depth(T(x).permute(0, 3, 1, 2))
    y = torch.nn.functional.conv2d(xs, conv.conv.weight, padding=1)
    mean = y.mean((0, 2, 3))
    var = (y * y).mean((0, 2, 3)) - mean * mean
    want = torch.nn.functional.silu((y - mean[:, None, None]) / torch.sqrt(var + 1e-5)[:, None, None]
                                    * conv.bn.weight[:, None, None] + conv.bn.bias[:, None, None])
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert set(stats) == {conv.bn}


# -- the stem's backward ----------------------------------------------------

@pytest.mark.parametrize("out_dtype", ["fp32", "bf16"])
def test_stem_backward_matches_jax_vjp(monkeypatch, out_dtype):
    monkeypatch.setattr(jfs, "_focus_stem_impl",
                        functools.partial(jfs._focus_stem_impl, interpret=True))
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.float32)
    w3 = rng.normal(0, 0.1, (8, 12, 3, 3)).astype(np.float32)          # OIHW
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    shift = rng.normal(0, 0.5, 8).astype(np.float32)
    g = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    jdt, pdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[out_dtype]
    ins = (jnp.asarray(x), jnp.asarray(w3.transpose(2, 3, 1, 0)), jnp.asarray(scale),
           jnp.asarray(shift))
    _, vjp = jax.vjp(lambda *a: jfs.focus_stem(*a, jdt), *ins)
    # the forward: bf16, the Pallas kernel (interpret mode); fp32, the
    # reference's math, since the Pallas kernel's dot takes bf16 operands
    # on the TPU's matrix unit at fp32 too
    want_out = (jfs._focus_stem_impl(*ins, jdt) if out_dtype == "bf16"
                else jfs._xla_reference(*ins, jdt))
    gj = jnp.asarray(g).astype(jdt)
    want = [np.asarray(t) for t in vjp(gj)]
    want[1] = want[1].transpose(3, 2, 0, 1)                          # HWIO -> OIHW
    pins = [T(a).requires_grad_(True) for a in (x, w3, scale, shift)]
    n0 = pfs.focus_stem.backward_calls
    out = pfs.focus_stem(*pins, out_dtype=pdt)
    assert out.dtype == pdt
    got = torch.autograd.grad(out, pins, T(np.asarray(gj.astype(jnp.float32))
                                         .transpose(0, 3, 1, 2)).to(pdt))
    assert pfs.focus_stem.backward_calls == n0 + 1
    wo = np.asarray(want_out.astype(jnp.float32)).transpose(0, 3, 1, 2)
    tol = 1e-5 if out_dtype == "fp32" else 2.0 ** -7
    np.testing.assert_allclose(out.detach().float().numpy(), wo, rtol=0,
                               atol=tol * np.abs(wo).max())
    for name, a, b in zip(("x", "w3", "scale", "shift"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    # no input that needs a gradient: autograd records nothing
    with torch.no_grad():
        assert not pfs.focus_stem(*pins, out_dtype=pdt).requires_grad


# -- stop_backbone_grad=False under fix_bn ----------------------------------

@pytest.fixture(scope="module")
def backbone_grad_case(variables):
    rng, x, te = _window(9)
    exp = _exp(stop_backbone_grad=False)
    pm = _port(variables, exp)
    lab = _labels(pm, x, te, rng, train=False)
    bs = variables["batch_stats"]
    (_, (jl, _, _, _)), grads = _jax_window_fn("open")(variables["params"], bs, x, te, lab)
    params, _, _ = _jax_update(exp, variables, grads, bs)
    n0 = pfs.focus_stem.backward_calls
    step = _step_and_grads(exp, pm, x, lab, te)
    stem_backwards = pfs.focus_stem.backward_calls - n0
    stop = _step_and_grads(_exp(), _port(variables, _exp()), x, lab, te)
    tmpl = pm.state_dict()
    return dict(step=step, stop=stop, jlosses=jl, stem_backwards=stem_backwards,
                jgrads=_sd({"params": grads, "batch_stats": bs}, tmpl),
                jparams=_sd({"params": params, "batch_stats": bs}, tmpl),
                names=[n for n, _ in pm.named_parameters()])


def test_backbone_gradients_match_jax(backbone_grad_case):
    c = backbone_grad_case
    losses, before, after, _, raw = c["step"]
    for k, v in c["jlosses"].items():
        np.testing.assert_allclose(losses[k], float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    assert c["stem_backwards"] == 1
    jg = c["jgrads"]
    bb = [n for n in c["names"] if n.startswith("backbone")]
    assert "backbone.backbone.stem.conv.conv.weight" in raw and all(n in raw for n in bb)
    assert _max([jg[n] for n in bb]) > 0
    gmax = _max([jg[n] for n in c["names"]])
    for n in c["names"]:
        g = raw.get(n, torch.zeros_like(jg[n]))       # JAX's zeros where unused
        np.testing.assert_allclose(g.numpy(), jg[n].numpy(), rtol=0, atol=1e-4 * gmax,
                                   err_msg=n)
    _close_update(after, c["jparams"], before, c["names"])


def test_backbone_grad_updates_equal_the_stopped_step(backbone_grad_case):
    """Both steps freeze the backbone, so stopping its gradient changes no
    update (tests/test_remat.py:55)."""
    c = backbone_grad_case
    after, stopped = c["step"][2], c["stop"][2]
    for n in c["names"]:
        a = stopped[n].numpy()
        np.testing.assert_allclose(after[n].numpy(), a, rtol=1e-5,
                                   atol=1e-6 * max(float(np.abs(a).max()), 1.0), err_msg=n)
        if n.startswith("backbone"):
            assert torch.equal(after[n], c["step"][1][n])
    assert not any(n.startswith("backbone") for n in c["stop"][4])


# -- remat ------------------------------------------------------------------

@pytest.mark.parametrize("fix_bn", [True, False])
def test_remat_gives_the_same_loss_and_gradients(variables, fix_bn):
    from tscd_torch.train.losses import tscd_loss
    rng, x, te = _window(12)
    results = []
    for remat in (False, True):
        exp = _exp(stop_backbone_grad=False, remat_backbone=remat)
        pm = _port(variables, exp)
        assert pm.remat_backbone is remat
        lab = _labels(pm, x, te, np.random.default_rng(1), train=not fix_bn)
        pm.train()
        out = pm(T(x), T(te), L, G, train=not fix_bn)
        loss = tscd_loss(out, T(lab), STRIDES, L)["total_loss"]
        n0 = pfs.focus_stem.backward_calls
        loss.backward()
        stats = {k: v.clone() for k, v in out.get("batch_stats", {}).items()}
        results.append((float(loss), {n: p.grad.clone() for n, p in pm.named_parameters()
                                      if p.grad is not None},
                        stats, pfs.focus_stem.backward_calls - n0))
    (l0, g0, s0, b0), (l1, g1, s1, b1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert g0.keys() == g1.keys() and float(g0["backbone.backbone.stem.conv.conv.weight"].abs().sum()) > 0
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-5, atol=1e-6, err_msg=n)
    assert s0.keys() == s1.keys() and (len(s0) > 100) == (not fix_bn)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert (b0, b1) == ((1, 1) if fix_bn else (0, 0))


# -- B windows a step -------------------------------------------------------

def _jax_batched_step(variables, frames, labels, te, fix_bn):
    """JAX's step on a batch of 2 windows (tscd_trainer.py:170-252): each
    window's losses, gradients and new BN statistics from JAX's window
    loss (`_jax_window_fn`; vmap maps it over the windows, the same
    program for each), their means as the trainer takes them (:208-220),
    the SGD of get_optimizer(iters, window_batch=2) (the schedule x 2,
    tscd_base.py:178-194) from update STEP and the EMA of params and BN
    statistics. fix_bn keeps the statistics as they were (:231-235); its
    gradients come from the backbone-open loss, whose updates equal the
    stopped one's under the frozen backbone (tests/test_remat.py:55).
    grad_accum gives the same step (tests/test_trainer_mesh.py:141)."""
    import optax
    fn = _jax_window_fn("open" if fix_bn else "bn")
    bs = variables["batch_stats"]
    outs = [fn(variables["params"], bs, frames[b], te[b], labels[b]) for b in range(2)]
    mean = lambda *t: jax.tree_util.tree_map(lambda *a: sum(a) / len(a), *t)  # noqa: E731
    losses = mean(*(o[0][1][0] for o in outs))
    grads = mean(*(o[1] for o in outs))
    new_bs = bs if fix_bn else mean(*(o[0][1][1] for o in outs))
    tx = _jax_exp(_exp()).get_optimizer(ITERS, window_batch=2)
    state = jinit_state(variables, tx)
    counts = lambda a: jnp.full_like(a, STEP) if a.dtype == jnp.int32 and a.ndim == 0 else a  # noqa: E731
    opt_state = jax.tree_util.tree_map(counts, state.opt_state)
    upd, _ = jax.jit(tx.update)(grads, opt_state, state.params)
    params = optax.apply_updates(state.params, upd)
    t = jnp.asarray(STEP + 1, jnp.int32)
    return (losses, params, new_bs, jema(state.ema_params, params, t, _exp().ema_decay),
            jema(state.ema_batch_stats, new_bs, t, _exp().ema_decay))


def _two_windows(variables, train):
    pm = _port(variables, _exp())
    xs, labs, tes = [], [], []
    for seed in (21, 22):
        rng, x, te = _window(seed)
        labs.append(_labels(pm, x, te, rng, train=train, k=P if train else 3))
        xs.append(x)
        tes.append(te)
    return np.stack(xs), np.stack(labs), np.stack(tes)


@pytest.mark.parametrize("fix_bn,accum", [(True, 1), (True, 2), (False, 1), (False, 2)])
def test_window_batch_step_matches_jax_vmapped_step(variables, fix_bn, accum):
    """Port B = 2 through the trainer's step, with and without grad_accum
    = 2 (the port's step runs one window at a time whatever the chunking,
    so grad_accum reaches only the trainer's knob check), against JAX's
    batched step (`_jax_batched_step`)."""
    frames, labels, te = _two_windows(variables, train=not fix_bn)
    jl, jparams, jbs, jema_p, jema_b = _jax_batched_step(variables, frames, labels, te, fix_bn)
    exp = _exp(fix_bn=fix_bn, grad_accum=accum, window_batch=2)
    pm = _port(variables, exp)
    opt = exp.get_optimizer(pm, ITERS, window_batch=exp.windows_per_step)
    assert opt.lr(STEP) == pytest.approx(2 * exp.get_lr_schedule(ITERS)(STEP)) and opt.lr(STEP) > 0
    losses, before, after, ema, _ = _step_and_grads(exp, pm, frames, labels, te, fix_bn=fix_bn,
                                                    window_batch=2, trainer=True)
    for k, v in jl.items():
        np.testing.assert_allclose(losses[k], float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    tmpl = pm.state_dict()
    want = _sd({"params": jparams, "batch_stats": jbs}, tmpl)
    jema_sd = _sd({"params": jema_p, "batch_stats": jema_b}, tmpl)
    names = [n for n, _ in pm.named_parameters()]
    _close_update(after, want, before, names)
    _close_update({k: ema[k] for k in names}, {k: jema_sd[k] for k in names}, before, names)
    for k in want:
        if ".running_" in k:
            if fix_bn:
                assert torch.equal(after[k], before[k]), k
            np.testing.assert_allclose(after[k].numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-4 * float(want[k].abs().max()), err_msg=k)
            np.testing.assert_allclose(ema[k].numpy(), jema_sd[k].numpy(), rtol=0,
                                       atol=1e-4 * float(jema_sd[k].abs().max()), err_msg=k)


def test_grad_accum_must_divide_the_window_batch():
    """As JAX's trainer asserts (tscd_trainer.py:178-181)."""
    for window_batch, accum in ((2, 3), (1, 2), (4, 3)):
        exp = _exp(window_batch=window_batch, grad_accum=accum)
        with pytest.raises(ValueError, match="grad_accum"):
            exp.check_train_knobs()
        with pytest.raises(ValueError, match="grad_accum"):
            exp.get_trainer(device="cpu")
    _exp(window_batch=4, grad_accum=2).check_train_knobs()


class _Frames:
    """In-memory dataset with VIDDataset's interface, for both packages:
    5 one-frame windows."""

    def __init__(self, seed=0, n=5):
        rng = np.random.default_rng(seed)
        self.img_size = (128, 128)
        self.paths = [f"vid0/{i:06d}.JPEG" for i in range(n)]
        self.frames = {p: rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for p in self.paths}
        self.annos = {p: np.array([[10, 10, 50, 60, i % 30]], np.float32)
                      for i, p in enumerate(self.paths)}
        self.res = [[p] for p in self.paths]

    def load_frame(self, p):
        return self.frames[p], self.annos[p].copy(), (96, 128)

    def frame_index(self, p):
        return int(p[-11:-5])


def test_batch_windows_stack_as_jax():
    ds = _Frames()
    kw = dict(train_time_index=True, cxcywh=True, batch_windows=2)
    want = list(jvid.WindowLoader(ds, shuffle=False, img_dtype=np.uint8, **kw))
    loader = pvid.WindowLoader(ds, **kw)
    got = list(loader)
    assert len(loader) == len(got) == len(want) == len(ds.res) // 2
    for g, w in zip(got, want):
        assert g["imgs"].shape[:2] == (2, 1) and g["time_embedding"].shape == (2, 1, 256)
        for k in ("imgs", "labels", "time_embedding"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        assert g["paths"] == w["paths"] and g["infos"] == w["infos"]
    with pytest.raises(ValueError, match="batch_windows"):
        pvid.WindowLoader(ds, batch_windows=len(ds.res) + 1)
    with pytest.raises(ValueError, match="batch_windows"):
        jvid.WindowLoader(ds, batch_windows=len(ds.res) + 1)


# -- the knobs in the exp and the trainer -----------------------------------

@pytest.mark.parametrize("knob,value", [("fix_bn", False), ("stop_backbone_grad", False),
                                        ("window_batch", 2), ("grad_accum", 2),
                                        ("remat_backbone", True)])
def test_lifted_knobs_build_a_trainer(knob, value):
    exp = _exp(**{knob: value})
    if knob == "grad_accum":
        exp.window_batch = 2
    trainer = exp.get_trainer(device="cpu")
    assert trainer.window_batch == exp.windows_per_step
    m = trainer.model
    assert (m.stop_backbone_grad, m.remat_backbone) == (exp.stop_backbone_grad, exp.remat_backbone)


@pytest.mark.parametrize("knob", ["fsdp", "mesh_data", "mesh_model"])
def test_mesh_knobs_still_raise(knob):
    exp = _exp(**{knob: 2 if knob.startswith("mesh") else True})
    with pytest.raises(NotImplementedError, match=knob):
        exp.get_trainer(device="cpu")


def test_stop_backbone_grad_needs_a_frozen_backbone():
    exp = _exp(freeze_prefixes=lambda: ("head/stem_",))
    with pytest.raises(ValueError, match="does not freeze the backbone"):
        exp.get_model(device="cpu")
    exp.stop_backbone_grad = False
    assert exp.get_model(device="cpu").stop_backbone_grad is False


def test_trainer_runs_window_batches_in_train_mode(tmp_path):
    """An epoch of the selftest exp on the committed fixture, 2 windows a
    step with grad_accum 2 and train-mode BN: len(res) // 2 steps at twice
    the LR, the running statistics moved, the backbone's weights not."""
    exp = _exp(window_batch=2, grad_accum=2, fix_bn=False, max_epoch=1, eval_interval=5)
    exp.output_dir = str(tmp_path)
    trainer = exp.get_trainer(device="cpu")
    seen, first = [], {}
    step = trainer.step

    def counted(f, lab, te):
        if not seen:
            first.update({k: v.clone() for k, v in trainer.model.state_dict().items()})
        seen.append(tuple(f.shape))
        return step(f, lab, te)
    trainer.step = counted
    st = trainer.train()
    n = len(trainer.dataset.res) // 2
    assert n > 1 and st.step == n and len(seen) == n and all(s[:2] == (2, F) for s in seen)
    sched = exp.get_lr_schedule(n)
    assert st.optimizer.lr(n - 1) == pytest.approx(2 * sched(n - 1)) and sched(n - 1) > 0
    after = st.model.state_dict()
    moved = [k for k in after if ".running_" in k and not torch.equal(after[k], first[k])]
    assert len(moved) > 100
    assert all(torch.equal(after[k], first[k]) for k in after
               if k.startswith("backbone") and ".running_" not in k)
