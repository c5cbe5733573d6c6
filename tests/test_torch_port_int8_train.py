"""The port's int8 training knobs against the JAX package on the CPU
(tscd_tpu/models/blocks.py int8_eval(scope=...) and int8_eval(qat=True),
tscd_tpu/core/tscd_trainer.py:253-277), where the hand int8 kernels take
their plain versions, on the same numpy-seeded weights and inputs. As
JAX's own tests do, the C_in gate is lowered to 16 on both sides so that
the tiny widths quantize.

  - Scope: a scope that matches nothing is bit-equal to fp; the backbone
    scope on tests/test_int8_eval.py:test_int8_scope_frozen_backbone's
    TSCD (depth 0.33, width 0.25, P 4, 2 heads, 1 + 1 frames at 64 px)
    gives JAX's loss within 1e-5 relative and its gradients within 1e-5
    of the largest (the int8 sums are exact; what is left is fp32 sums in
    other orders, measured 8e-8 and 7e-7), and it quantizes: the loss
    differs from fp.
  - The QAT BaseConv (C_in 128, k 3 and 1, stride 1 and 2, fp32): its
    forward within 1e-5 of JAX's largest output and by
    `chip_smoke.int8_spread_rule` against JAX's QAT output (JAX's fp
    output the reference's distance), and its gradients (x, the conv
    weight, BN scale and bias) within 1e-5 of each one's largest value
    (measured 2e-7); a case with values exactly on +-127 x s_x, where
    JAX's clip passes half the gradient and torch.clamp all of it: the
    port equals JAX's there, and a clamp-based mask would not.
  - `int8_conv_ste` (the card's autograd Function, run here on the plain
    versions of its kernels) against `int8_conv_ste_reference`: the
    forward equal, the gradients within 1e-5 of the largest.
  - One stage-2 step at each knob on the same TSCD, fix_bn and the
    backbone frozen, against JAX's step (value_and_grad under the mode,
    build_sgd at a constant LR 0.01): losses 1e-5 relative, gradients
    1e-5 of the largest, updates 1e-4 of the largest update plus the
    parameter's fp32 spacing (as tests/test_torch_port_train.py holds the
    fp step), the backbone bit-unchanged.
  - The trainer's gating and precedence (JAX's conditions), the fp
    fallthrough outside them (no int8 conv runs), the frozen-int8
    trainer preparing the backbone only; fsdp and meshes still raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from tscd_tpu.models import blocks as jblk
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.ops.position import get_timing_signal_1d
from tscd_tpu.train.losses import tscd_loss as jloss
from tscd_tpu.train.optim import build_sgd
from tscd_tpu.train.step import init_train_state as jinit_state
from tscd_torch.core import tscd_trainer as ptrainer
from tscd_torch.exp.tscd_large import selftest_exp
from tscd_torch.models import blocks as pblk
from tscd_torch.models.tscd import TSCD
from tscd_torch.ops.kernels import int8_conv as q8
from tscd_torch.train.losses import tscd_loss
from tscd_torch.train.optim import GroupedSGD
from tscd_torch.train.step import init_train_state, train_step
from tscd_torch.utils.convert import state_dict_from_flax
from torch_port_util import seeded_variables

T = torch.from_numpy
L, G = 1, 1
F, HW = L + G, 64
BACKBONE = (("backbone",),)
LR = 0.01


@pytest.fixture(scope="module", autouse=True)
def _gates_and_threads():
    """The C_in gate at 16 on both sides (tests/test_int8_eval.py's), and
    the port's side on one thread: the tests run beside others."""
    old = (jblk.INT8_MIN_CIN, pblk.INT8_MIN_CIN, torch.get_num_threads())
    jblk.INT8_MIN_CIN = pblk.INT8_MIN_CIN = 16
    torch.set_num_threads(1)
    yield
    jblk.INT8_MIN_CIN, pblk.INT8_MIN_CIN = old[:2]
    torch.set_num_threads(old[2])


# -- the QAT BaseConv --------------------------------------------------------

def _baseconv(k, stride, seed):
    """A JAX BaseConv (C_in 128 -> 96, SiLU, BN with non-trivial
    statistics) and the port's with the same weights."""
    rng = np.random.default_rng(seed)
    cin, cout = 128, 96
    jm = jblk.BaseConv(cout, k, stride)
    v = {"params": {"conv": {"kernel": (rng.normal(size=(k, k, cin, cout))
                                        / np.sqrt(k * k * cin)).astype(np.float32)},
                    "bn": {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                           "bias": rng.normal(0, 0.1, cout).astype(np.float32)}},
         "batch_stats": {"bn": {"mean": rng.normal(0, 0.1, cout).astype(np.float32),
                                "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)}}}
    pm = pblk.BaseConv(cin, cout, k, stride)
    pm.load_state_dict({"conv.weight": T(v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1).copy()),
                        "bn.weight": T(v["params"]["bn"]["scale"]),
                        "bn.bias": T(v["params"]["bn"]["bias"]),
                        "bn.running_mean": T(v["batch_stats"]["bn"]["mean"]),
                        "bn.running_var": T(v["batch_stats"]["bn"]["var"]),
                        "bn.num_batches_tracked": torch.tensor(0)})
    return jm, v, pm


def _x(seed, edge=False):
    """N(0, 2) activations (2, 128, 12, 12) NCHW with an outlier channel;
    with `edge`, multiples of 0.5 whose largest magnitude 63.5 sits on
    +-127 x s_x exactly, in several places and both signs."""
    rng = np.random.default_rng(seed)
    if edge:
        x = rng.integers(-120, 121, (2, 128, 12, 12)).astype(np.float32) * 0.5
        x[0, 3, 4, 5] = x[1, 7, 0, 0] = 63.5
        x[0, 9, 2, 2] = x[1, 0, 11, 11] = -63.5
        return x
    x = rng.normal(0, 2, (2, 128, 12, 12)).astype(np.float32)
    x[:, 7] *= 20
    return x


def _jax_qat(jm, v, x, mode):
    """JAX's output and gradients (x, params) of sum(y^2) under `mode`."""
    def loss(params, xj):
        with jblk.int8_eval(**mode):
            y = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xj)
        return jnp.sum(y ** 2), y
    (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x.transpose(0, 2, 3, 1)))
    return (np.asarray(y).transpose(0, 3, 1, 2), np.asarray(gx).transpose(0, 3, 1, 2),
            {"conv.weight": np.asarray(gp["conv"]["kernel"]).transpose(3, 2, 0, 1),
             "bn.weight": np.asarray(gp["bn"]["scale"]), "bn.bias": np.asarray(gp["bn"]["bias"])})


def _port_qat(pm, x):
    xp = T(x).clone().requires_grad_(True)
    pm.zero_grad(set_to_none=True)
    with pblk.int8_eval(qat=True):
        y = pm(xp)
    (y ** 2).sum().backward()
    return y.detach().numpy(), xp.grad.numpy(), {n: p.grad.numpy()
                                                 for n, p in pm.named_parameters()}


def _close(got, want, tol, what):
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), what


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)])
def test_qat_baseconv_matches_jax(k, stride):
    jm, v, pm = _baseconv(k, stride, seed=k + 3 * stride)
    x = _x(k + stride)
    want, gx, gp = _jax_qat(jm, v, x, {"qat": True})
    fp = np.asarray(jm.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    got, px, pp = _port_qat(pm, x)
    _close(got, want, 1e-5, "forward")
    _, _, ok = chip_smoke.int8_spread_rule(got, want, fp)
    assert ok
    _close(px, gx, 1e-5, "dx")
    for n, g in gp.items():
        _close(pp[n], g, 1e-5, n)
    assert all(np.abs(g).max() > 0 for g in pp.values())


def test_qat_gradient_on_the_clip_bound_is_jaxs_half():
    """Values exactly on +-127 x s_x: JAX's clip gives them half the
    gradient (jnp.clip is min(max(v, -127), 127); max and min split a
    tie), torch.clamp would give all of it. The port's gradient there is
    JAX's, and twice it is what a clamp-based STE gives."""
    jm, v, pm = _baseconv(3, 1, seed=11)
    x = _x(5, edge=True)
    on = np.abs(x) == 63.5
    assert on.sum() == 4
    assert float(np.abs(x).max()) / (float(q8.dynamic_scale(torch.tensor([63.5]))) ) == 127.0
    _, gx, _ = _jax_qat(jm, v, x, {"qat": True})
    _, px, _ = _port_qat(pm, x)
    _close(px, gx, 1e-5, "dx")
    clip = q8._clip127
    q8._clip127 = lambda t: t.clamp(-127, 127)
    try:
        _, cx, _ = _port_qat(pm, x)
    finally:
        q8._clip127 = clip
    np.testing.assert_allclose(px[on], gx[on], rtol=1e-5, atol=0)
    np.testing.assert_allclose(2 * px[on], cx[on], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(px[~on], cx[~on])


@pytest.mark.parametrize("act,dtype,k,stride,pad", [
    ("silu", torch.float32, 3, 1, 1), ("id", torch.float32, 1, 1, 0),
    ("lrelu", torch.bfloat16, 3, 2, 1), ("silu", torch.bfloat16, 3, 1, 0)])
def test_ste_function_matches_its_reference(act, dtype, k, stride, pad):
    """The card's `_Int8ConvSTE` (its kernels as their plain versions
    here) against `int8_conv_ste_reference`: the forward equal, dx, dw and
    db within 1e-5 of the largest."""
    g = torch.Generator().manual_seed(k + stride)
    x = (torch.randn(2, 64, 10, 10, generator=g) * 2).to(dtype)
    w = torch.randn(48, 64, k, k, generator=g) / 24
    b = torch.randn(48, generator=g) * 0.1
    ins = [[t.clone().requires_grad_(True) for t in (x, w, b)] for _ in range(2)]
    yr = q8.int8_conv_ste_reference(*ins[0], stride, pad, act, dtype)
    yf = q8._Int8ConvSTE.apply(*ins[1], stride, pad, act, dtype)
    assert torch.equal(yr, yf)
    up = torch.randn(yr.shape, generator=g).to(dtype)
    yr.backward(up)
    yf.backward(up)
    for a, r in zip(ins[1], ins[0]):
        _close(a.grad.float().numpy(), r.grad.float().numpy(), 1e-5, "grad")


# -- scope and the stage-2 step on a small TSCD --------------------------------

@pytest.fixture(scope="module")
def tscd():
    """tests/test_int8_eval.py:test_int8_scope_frozen_backbone's TSCD and
    inputs (with stop_backbone_grad, as the stage-2 exps run it), seeded
    weights, and the port's TSCD with them."""
    jm = JTSCD(num_classes=3, depth=0.33, width=0.25, num_proposals=4, heads=2,
               stop_backbone_grad=True)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 255, (F, HW, HW, 3)).astype(np.float32)
    te = get_timing_signal_1d(np.arange(F), 256).astype(np.float32)
    lab = np.zeros((F, 4, 5), np.float32)
    lab[:, 0] = [1, 30, 30, 20, 20]
    v = seeded_variables(jm, 0, jnp.asarray(x), jnp.asarray(te), L, G)
    return {"jm": jm, "v": v, "x": x, "te": te, "lab": lab, "vag": {}}


def _port_tscd(v):
    pm = TSCD(num_classes=3, depth=0.33, width=0.25, num_proposals=4, heads=2,
              stop_backbone_grad=True, device="cpu")
    pm.load_state_dict(state_dict_from_flax(v, pm.state_dict()))
    return pm


def _jax_vag(tscd, mode):
    """jit(value_and_grad) of JAX's fix_bn window loss under `mode`, one
    compile a mode for the module."""
    key = tuple(sorted(mode.items()))
    if key not in tscd["vag"]:
        jm, v = tscd["jm"], tscd["v"]

        def f(params):
            out = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, tscd["x"],
                           tscd["te"], L, G, False, labels=tscd["lab"])
            return jloss(out, tscd["lab"], (8, 16, 32), L)["total_loss"]
        with jblk.int8_eval(**mode):
            tscd["vag"][key] = jax.jit(jax.value_and_grad(f)).lower(v["params"]).compile()
    return tscd["vag"][key](tscd["v"]["params"])


def _port_loss(pm, tscd, mode):
    pm.train()
    pm.zero_grad(set_to_none=True)
    with pblk.int8_eval(**mode):
        out = pm(T(tscd["x"]), T(tscd["te"]), L, G, labels=T(tscd["lab"]))
        loss = tscd_loss(out, T(tscd["lab"]), (8, 16, 32), L)["total_loss"]
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in pm.named_parameters()
                         if p.grad is not None}


def _grads_close(got, jgrads, tscd, pm, tol=1e-5):
    jg = state_dict_from_flax({"params": jgrads, "batch_stats": tscd["v"]["batch_stats"]},
                              pm.state_dict())
    assert got and all(n.startswith("head.") for n in got)        # stop_backbone_grad
    gmax = max(float(jg[n].abs().max()) for n in got)
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), jg[n].numpy(), rtol=0, atol=tol * gmax, err_msg=n)


def test_scope_matching_nothing_is_fp_and_backbone_scope_matches_jax(tscd):
    pm = _port_tscd(tscd["v"])
    pblk.stamp_int8_paths(pm)
    loss_fp, _ = _port_loss(pm, tscd, {"enable": False})
    loss_none, _ = _port_loss(pm, tscd, {"scope": (("nonexistent",),)})
    assert loss_none == loss_fp
    ptrainer.prepare_frozen_int8(pm, pm.state_dict())
    prepared = {n for n, m in pm.named_modules() if getattr(m, "_int8", None) is not None}
    assert prepared and all(n.startswith("backbone.") for n in prepared)
    loss, grads = _port_loss(pm, tscd, {"scope": BACKBONE})
    jl, jg = _jax_vag(tscd, {"scope": BACKBONE})
    assert loss != loss_fp and np.isfinite(loss)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    _grads_close(grads, jg, tscd, pm)


def test_scope_needs_stamped_paths_and_matches_whole_components():
    conv = pblk.BaseConv(32, 8, 1)
    x = torch.randn(1, 32, 4, 4)
    with pblk.int8_eval(scope=BACKBONE), pytest.raises(ValueError, match="stamp_int8_paths"):
        conv(x)
    assert pblk.in_int8_scope(("backbone", "dark2"), BACKBONE)
    assert not pblk.in_int8_scope(("backbones", "dark2"), BACKBONE)
    assert not pblk.in_int8_scope(("head", "backbone"), BACKBONE)
    assert pblk.in_int8_scope(("head",), None)


@pytest.mark.parametrize("knob", ["int8_frozen_backbone", "int8_qat"])
def test_one_stage2_step_at_each_knob_matches_jax(tscd, knob):
    exp = selftest_exp()
    setattr(exp, knob, True)
    mode = ptrainer.int8_train_mode(exp)
    assert mode == {"int8_frozen_backbone": "frozen_backbone", "int8_qat": "qat"}[knob]
    jmode = {"scope": BACKBONE} if mode == "frozen_backbone" else {"qat": True}
    jm, v = tscd["jm"], tscd["v"]
    (jl, jg) = _jax_vag(tscd, jmode)
    tx = build_sgd(lambda i: LR, freeze_prefixes=("backbone",))
    state = jinit_state(v, tx)
    upd, _ = jax.jit(tx.update)(jg, state.opt_state, state.params)
    params = optax.apply_updates(state.params, upd)

    pm = _port_tscd(v)
    opt = GroupedSGD(pm.named_parameters(), lambda i: LR, freeze_prefixes=("backbone",))
    st = init_train_state(pm, opt, 0.9998)
    if mode == "frozen_backbone":
        ptrainer.prepare_frozen_int8(pm, st.model_state())
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    raw, sgd_step = {}, opt.step

    def step():             # the gradients as backward leaves them
        raw.update({n: p.grad.clone() for n, p in pm.named_parameters() if p.grad is not None})
        sgd_step()
    opt.step = step
    with ptrainer.int8_step_context(mode):
        losses = train_step(st, T(tscd["x"]), T(tscd["lab"]), T(tscd["te"]), L, G)
    np.testing.assert_allclose(float(losses["total_loss"]), float(jl), rtol=1e-5)
    _grads_close(raw, jg, tscd, pm)
    tmpl = pm.state_dict()
    want = state_dict_from_flax({"params": params, "batch_stats": v["batch_stats"]}, tmpl)
    after = pm.state_dict()
    names = [n for n, _ in pm.named_parameters()]
    dmax = max(float((want[k].double() - before[k].double()).abs().max()) for k in names)
    assert dmax > 0
    for k in names:
        bound = 1e-4 * dmax + np.spacing(np.abs(want[k].numpy()))
        assert np.all(np.abs(after[k].double().numpy() - want[k].double().numpy()) <= bound), k
        if k.startswith("backbone."):
            assert torch.equal(after[k], before[k]), k


# -- the trainer's gating ------------------------------------------------------

@pytest.mark.parametrize("frozen,qat,fix_bn,freeze,want", [
    (True, False, True, True, "frozen_backbone"),
    (False, True, True, True, "qat"),
    (True, True, True, True, "frozen_backbone"),        # the frozen backbone wins
    (True, True, True, False, "qat"),                   # no frozen backbone: QAT
    (True, False, False, True, None),                   # both need fix_bn
    (False, True, False, True, None),
    (True, False, True, False, None),
    (False, False, True, True, None)])
def test_int8_mode_gated_and_ordered_as_jax(frozen, qat, fix_bn, freeze, want):
    exp = selftest_exp()
    exp.int8_frozen_backbone, exp.int8_qat, exp.fix_bn = frozen, qat, fix_bn
    if not freeze:
        exp.freeze_prefixes = lambda: ()
        exp.stop_backbone_grad = False
    assert ptrainer.int8_train_mode(exp) == want
    with ptrainer.int8_step_context(want):
        mode = pblk.int8_mode()
    assert mode.enable == (want is not None)
    assert mode.scope == (BACKBONE if want == "frozen_backbone" else None)
    assert mode.qat == (want == "qat")


def test_the_frozen_int8_trainer_prepares_the_backbone_only():
    exp = selftest_exp()
    exp.int8_frozen_backbone = True
    trainer = exp.get_trainer(device="cpu")
    assert trainer.int8 == "frozen_backbone"
    trainer._init_state(1)
    prepared = [n for n, m in trainer.model.named_modules()
                if isinstance(m, pblk.BaseConv) and m._int8 is not None]
    assert prepared and all(n.startswith("backbone.") for n in prepared)


@pytest.mark.parametrize("fix_bn", [True, False])
def test_the_trainer_step_runs_qat_under_fix_bn_only(fix_bn):
    """TSCDTrainer.step with int8_qat: under fix_bn eligible convs take
    the int8 route; without it (JAX's fp fallthrough) none does."""
    exp = selftest_exp()
    exp.int8_qat, exp.fix_bn = True, fix_bn
    trainer = exp.get_trainer(device="cpu")
    trainer._init_state(1)
    Fr = exp.lframe + exp.gframe
    rng = np.random.default_rng(3)
    x = T(rng.uniform(0, 255, (Fr, *exp.input_size, 3)).astype(np.float32))
    lab = np.zeros((Fr, 4, 5), np.float32)
    lab[:, 0] = [1, 60, 60, 30, 30]
    te = T(get_timing_signal_1d(np.arange(Fr), 256).astype(np.float32))
    calls = []
    orig = pblk.BaseConv._int8_forward
    pblk.BaseConv._int8_forward = lambda self, *a: calls.append(1) or orig(self, *a)
    try:
        losses = trainer.step(x, T(lab), te)
    finally:
        pblk.BaseConv._int8_forward = orig
    assert np.isfinite(float(losses["total_loss"]))
    assert bool(calls) == fix_bn


@pytest.mark.parametrize("knob,value", [("fsdp", True), ("mesh_data", 2), ("mesh_model", 2)])
def test_meshes_still_raise(knob, value):
    exp = selftest_exp()
    exp.int8_qat = True
    setattr(exp, knob, value)
    with pytest.raises(NotImplementedError, match=knob):
        exp.get_trainer(device="cpu")
