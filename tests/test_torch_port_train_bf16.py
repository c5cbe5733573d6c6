"""The port's bf16 stage-2 step (bench.py:section_train's: TSCD at bf16,
grouped SGD at a constant LR of 0.01, the backbone frozen and its
gradient stopped, fix_bn) against the JAX package on the CPU, at the
selftest width (depth 0.33, width 0.125, P = 6, 2 + 2 frames, 128 px),
weights and window made from numpy seeds.

The JAX bf16 step runs as JAX runs it on its TPU, where bench.py times
it: the attention is the Pallas kernel (interpret mode), whose forward
computes what the port's kernel computes (q and k normalised in fp32)
and whose backward is XLA's VJP; on the CPU JAX would take its unfused
attention, which normalises q and k in bf16. The patch that routes it
there touches only `jax.default_backend` as that call site sees it
(`_on_the_tpu_path`). The stem is the XLA 6x6 conv on both (the Pallas
stem is an opt-in there, focus_stem.py:53). Each JAX step is jitted
once (module-scoped).

Tolerances, each with its reason:
  - the bf16 step: its losses, gradients, parameter updates and EMA (max
    |difference| over each) within BF16_SPREAD = 2 x the distance of JAX's
    bf16 step from JAX's fp32 step, as chip_smoke.py holds the card's bf16
    forward: two bf16 models of one fp32 model are two draws of rounding
    noise (the bf16 conv backwards and elementwise ops round at other
    places in XLA:CPU and torch, and JAX's bf16 stem rounds its conv
    before BN where the port's kernel folds BN into bf16 weights, as the
    Pallas stem does), so they sit further apart than
    either sits from fp32: here 1.59x (gradients), 1.26x (updates, EMA)
    and 0.58x (losses) of JAX's bf16-to-fp32 distance, while the port's
    own bf16-to-fp32 distance is 1.10x, 0.92x and 0.45x of JAX's (max,
    p99.9 and L2 are printed with `-s`);
  - the chained bf16 steps (CHAIN of them, each from the masters,
    momentum and count the one before left, as bench.py chains its
    steps): after each, the losses, updates and EMA within BF16_SPREAD x
    the distance of JAX's bf16 chain from its fp32 chain at that step;
  - the masters: every parameter the bf16 model stores in bf16 has an
    fp32 master in the optimizer and an fp32 EMA; after the step each
    bf16 weight is its master's rounding; a thousand updates each below
    half a bf16 ulp move the master (by their sum, 1e-6 relative) where
    SGD on the bf16 weight itself leaves it as it was;
  - the losses from bf16 head outputs: JAX's tscd_loss on the same bf16
    outputs, each term 1e-5 relative, its gradients 1e-5 of the largest
    plus one bf16 ulp (both round an fp32 gradient to bf16);
  - the attention's backward on bf16 q/k/v: jax.vjp of
    dual_attention_reference on the same bf16 values, 1e-5 of each
    gradient's largest value (as test_attention_gradients_match_jax_vjp)
    plus one bf16 ulp of the element, since both round the same fp32 VJP
    to bf16;
  - the checkpoint: the fp32 masters, the EMA and its BN statistics
    through JAX's msgpack layout exactly (flax reads the file; the port
    reads it back).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization, traverse_util

from tscd_tpu.models import aggregation as jagg
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.ops.pallas import fused_attention as jfa
from tscd_tpu.train.ema import ema_update as jema
from tscd_tpu.train.losses import tscd_loss as jloss
from tscd_tpu.train.optim import build_sgd
from tscd_tpu.train.step import init_train_state as jinit_state
from tscd_torch.exp.tscd_large import selftest_exp
from tscd_torch.models.tscd import TSCD
from tscd_torch.ops.kernels import fused_attention as pfa
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tscd_torch.train.losses import tscd_loss
from tscd_torch.train.optim import GroupedSGD
from tscd_torch.train.step import init_train_state, train_step
from tscd_torch.utils.convert import state_dict_from_flax
from torch_port_util import labels_near, seeded_variables

EXP = selftest_exp()
L, G = EXP.lframe, EXP.gframe
F = L + G
C, P = EXP.num_classes, EXP.num_proposals
STRIDES = (8, 16, 32)
BF16_SPREAD = 2.0
LR = 0.01                     # bench.py:466
CHAIN = 3                     # chained steps (bench.py:483-487 chains 9)
FREEZE = ("backbone",)
BF = torch.bfloat16
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


class _TPUBackend:
    """`jax` as a module that asks for the backend sees it on the TPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@contextlib.contextmanager
def _on_the_tpu_path():
    """JAX's attention call site takes its TPU branch, the Pallas kernel,
    in interpret mode on the CPU."""
    mp = pytest.MonkeyPatch()
    fused = jfa.fused_dual_attention
    mp.setattr(jagg, "jax", _TPUBackend())
    mp.setattr(jfa, "fused_dual_attention",
               lambda *a, scale=25.0: fused(*a, scale, True))
    try:
        yield
    finally:
        mp.undo()


def _window(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (F, 128, 128, 3)).astype(np.float32)    # bench.py:450
    te = get_timing_signal_1d(np.arange(F, dtype=np.float32), 256)
    return rng, x, te


def _jmodel(dtype):
    return JTSCD(num_classes=C, depth=EXP.depth, width=EXP.width, num_proposals=P,
                 minimal_limit=EXP.minimal_limit, heads=EXP.heads, stop_backbone_grad=True,
                 dtype=dtype)


def _port_model(sd32, dtype):
    """The port's TSCD at `dtype` (bench.py:460-463) with the fp32
    weights `sd32` (cast on load)."""
    pm = TSCD(num_classes=C, depth=EXP.depth, width=EXP.width, num_proposals=P,
              minimal_limit=EXP.minimal_limit, heads=EXP.heads, stop_backbone_grad=True,
              device="cpu", dtype=dtype)
    pm.load_state_dict(sd32)
    return pm


def _flat(sd, names):
    return torch.cat([sd[n].double().flatten() for n in names])


@pytest.fixture(scope="module")
def steps():
    """CHAIN steps of JAX at fp32 and at bf16, and of the port at bf16,
    from the same fp32 weights on the same window, each step from the
    state the one before returned (bench.py's chain): after the first,
    the losses, gradients, parameters and EMA as port state_dicts (fp32);
    after each, the losses, parameters and EMA."""
    rng, x, te = _window()
    variables = seeded_variables(_jmodel(jnp.float32), 0, jnp.asarray(x), jnp.asarray(te),
                                 L, G, False)
    tmpl = TSCD(num_classes=C, depth=EXP.depth, width=EXP.width, num_proposals=P,
                minimal_limit=EXP.minimal_limit, heads=EXP.heads, device="cpu").state_dict()
    sd32 = state_dict_from_flax(variables, tmpl)
    with torch.no_grad():
        boxes = _port_model(sd32, BF)(T(x), T(te), L, G)["proposals"].boxes[:L, :3].float()
    lab = labels_near(rng, boxes.numpy(), F, C)
    tx = build_sgd(lambda i: LR, freeze_prefixes=FREEZE)
    bs = variables["batch_stats"]
    as_sd = lambda p: state_dict_from_flax({"params": p, "batch_stats": bs}, tmpl)  # noqa: E731
    out = {}
    for name, dtype in (("jax32", jnp.float32), ("jax16", jnp.bfloat16)):
        jm = _jmodel(dtype)

        def loss_fn(params, bs, x, te, lab):
            o = jm.apply({"params": params, "batch_stats": bs}, x, te, L, G, False)
            losses = jloss(o, lab, STRIDES, L)
            return losses["total_loss"], losses

        state = jinit_state(variables, tx)
        params, opt_state, ema = state.params, state.opt_state, state.ema_params
        value_and_grad, update = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)), jax.jit(tx.update)
        chain = []
        # the fp32 reference computes in fp32 throughout; its unfused
        # attention normalises in fp32 as the kernel does
        path = _on_the_tpu_path() if dtype == jnp.bfloat16 else contextlib.nullcontext()
        with path:
            for t in range(1, CHAIN + 1):
                (_, jl), grads = value_and_grad(params, bs, x, te, lab)
                upd, opt_state = update(grads, opt_state, params)
                params = optax.apply_updates(params, upd)
                ema = jema(ema, params, jnp.asarray(t, jnp.int32), EXP.ema_decay)
                chain.append(dict(losses={k: float(v) for k, v in jl.items()},
                                  params=as_sd(params), ema=as_sd(ema)))
                if t == 1:
                    out[name] = dict(chain[0], grads=as_sd(grads))
        out[name]["chain"] = chain
    pm = _port_model(sd32, BF)
    opt = GroupedSGD(pm.named_parameters(), lambda i: LR, freeze_prefixes=FREEZE, masters=sd32)
    st = init_train_state(pm, opt, EXP.ema_decay)
    raw, sgd_step = {}, opt.step

    def step():       # the gradients as the step has them (a master's, in fp32)
        for n, p in pm.named_parameters():
            g = opt.masters[n].grad if n in opt.masters else p.grad
            if g is not None:
                raw[n] = g.float().clone()
        sgd_step()
    opt.step = step
    chain = []
    for t in range(1, CHAIN + 1):
        losses = train_step(st, T(x), T(lab), T(te), L, G)
        chain.append(dict(losses={k: float(v) for k, v in losses.items()},
                          params={k: v.clone() for k, v in st.model_state().items()},
                          ema={k: v.clone() for k, v in st.ema.state_dict().items()}))
        if t == 1:
            out["port16"] = dict(chain[0], grads=dict(raw))
    out["port16"].update(chain=chain, state=st, masters=dict(opt.masters))
    out["before"] = sd32
    out["names"] = [n for n, _ in pm.named_parameters()]
    return out


def _vec(steps, run, what, step=None):
    """One run's losses, gradients, updates (from the start) or EMA, after
    its first step, or after step `step` of the chain, as one float64
    vector over the trained parameters (the EMA over every one)."""
    names = steps["names"]
    trained = [n for n in names if not n.startswith("backbone")]
    r = steps[run] if step is None else steps[run]["chain"][step - 1]
    if what == "losses":
        return torch.tensor([r["losses"][k] for k in sorted(r["losses"])], dtype=torch.float64)
    if what == "grads":
        return _flat({n: r["grads"].get(n, torch.zeros(1)).expand_as(steps["before"][n])
                      for n in trained}, trained)
    if what == "updates":
        return _flat(r["params"], trained) - _flat(steps["before"], trained)
    return _flat(r["ema"], names)


def _dist(a, b):
    d = (a - b).abs().numpy()
    return float(d.max()), float(np.percentile(d, 99.9)), float(np.sqrt((d * d).sum()))


@pytest.mark.parametrize("what", ["losses", "grads", "updates", "ema"])
def test_bf16_step_within_jax_bf16_distance(steps, what):
    port, j16, j32 = (_vec(steps, r, what) for r in ("port16", "jax16", "jax32"))
    d_port, d_jax, d_own = _dist(port, j16), _dist(j16, j32), _dist(port, j32)
    print(f"{what}: port-jax16 {d_port}, jax16-jax32 {d_jax}, port-jax32 {d_own}")
    assert 0 < d_jax[0] and float(j16.abs().max()) > 0
    assert d_port[0] <= BF16_SPREAD * d_jax[0], (what, d_port, d_jax)
    if what == "losses":
        assert steps["jax16"]["losses"]["loss_refined_cls"] > 0
        assert steps["jax16"]["losses"]["loss_matched_iou"] > 0


@pytest.mark.parametrize("what", ["losses", "updates", "ema"])
def test_chained_bf16_steps_stay_within_jax_bf16_distance(steps, what):
    """bench.py chains its steps: after each of CHAIN steps, each from the
    masters, momentum and count the one before left, the port's bf16 state
    no farther from JAX's bf16 chain than BF16_SPREAD x that chain's
    distance from JAX's fp32 chain at the same step."""
    for step in range(2, CHAIN + 1):
        port, j16, j32 = (_vec(steps, r, what, step) for r in ("port16", "jax16", "jax32"))
        d_port, d_jax = _dist(port, j16), _dist(j16, j32)
        print(f"{what} after step {step}: port-jax16 {d_port}, jax16-jax32 {d_jax}")
        assert 0 < d_jax[0]
        assert d_port[0] <= BF16_SPREAD * d_jax[0], (what, step, d_port, d_jax)
    if what == "updates":           # the chain moved past its first step
        first, last = (_vec(steps, "port16", what, s) for s in (1, CHAIN))
        assert float((last - first).abs().max()) > 0


def test_bf16_model_trains_fp32_masters(steps):
    st, masters = steps["port16"]["state"], steps["port16"]["masters"]
    model = st.model
    bf16 = {n for n, p in model.named_parameters() if p.dtype == BF}
    assert len(bf16) > 100 and set(masters) == bf16
    assert all(m.dtype == torch.float32 for m in masters.values())
    assert all(v.dtype == torch.float32 for v in st.ema.state_dict().values()
               if v.is_floating_point())
    assert all(v.dtype == torch.float32 for k, v in st.model_state().items()
               if v.is_floating_point())
    params = dict(model.named_parameters())
    for n, m in masters.items():
        assert torch.equal(params[n], m.to(BF)), n
        if n.startswith("backbone"):              # frozen: its fp32 value kept
            assert torch.equal(m, steps["before"][n]), n
    moved = [n for n in masters if not n.startswith("backbone")
             and not torch.equal(masters[n], steps["before"][n])]
    assert len(moved) > 50


def test_a_thousand_tiny_updates_move_the_master():
    """Each update is a quarter of a bf16 ulp of the weight: SGD on the
    bf16 weight rounds every one away; on the fp32 master they add up."""
    w0 = torch.full((4, 4), 1.0)
    lin = torch.nn.Linear(4, 4, bias=False, dtype=BF)
    with torch.no_grad():
        lin.weight.copy_(w0)
    ulp = 2.0 ** -7                                   # bf16 at 1.0
    g = torch.full((4, 4), ulp / 4)
    opt = GroupedSGD([("fc.weight", lin.weight)], lambda i: 1.0, momentum=0.9,
                     weight_decay=0.0)
    plain = torch.nn.Parameter(w0.to(BF))
    sgd = torch.optim.SGD([plain], lr=1.0, momentum=0.0)
    for _ in range(1000):
        lin.weight.grad = g.to(BF)
        opt.step()
        plain.grad = g.to(BF)
        sgd.step()
    master = opt.masters["fc.weight"]
    assert master.dtype == torch.float32
    assert torch.equal(plain.detach(), w0.to(BF))              # rounded away each time
    assert float((w0 - master).min()) > 1.0 * ulp                 # 1000 x ulp/4, and momentum
    assert torch.equal(lin.weight.detach(), master.to(BF))
    assert not torch.equal(lin.weight.detach(), w0.to(BF))


def test_losses_from_bf16_outputs_match_jax():
    """tscd_loss on bf16 head outputs casts them to fp32 where JAX's does
    (losses.py:103,162,167,183,212)."""
    rng = np.random.default_rng(3)
    A = 16 * 16 + 8 * 8 + 4 * 4
    hw = [(16, 16), (8, 8), (4, 4)]
    raw = rng.normal(0, 0.5, (F, A, 5 + C)).astype(np.float32)
    raw[..., 4:] -= 2.0
    arrays = dict(raw_outputs=raw, refined_cls_logits=rng.normal(0, 1, (L, P, C)),
                  matcher_obj_logits=rng.normal(0, 2, (L, P)),
                  matcher_reg_offsets=rng.normal(0, 0.3, (L, P, 4)))
    arrays = {k: T(v.astype(np.float32)).to(BF) for k, v in arrays.items()}
    idx = np.stack([rng.choice(A, P, replace=False) for _ in range(F)])
    decoded_boxes = rng.uniform(10, 110, (F, P, 2))
    boxes = np.concatenate([decoded_boxes, decoded_boxes + rng.uniform(8, 40, (F, P, 2))], -1)
    lab = labels_near(rng, boxes[:L, :3], F, C)
    from tscd_tpu.models.tscd_head import FrameProposals as JProps
    from tscd_torch.models.tscd_head import FrameProposals
    z = np.zeros((F, P), np.float32)
    jp = JProps(jnp.asarray(boxes, jnp.float32), jnp.asarray(z), jnp.asarray(z),
                jnp.asarray(z.astype(np.int32)), jnp.asarray(np.zeros((F, P, C), np.float32)),
                jnp.asarray(idx.astype(np.int32)), jnp.asarray(np.ones((F, P), bool)))
    pp = FrameProposals(T(boxes.astype(np.float32)), T(z), T(z), T(z).long(),
                        T(np.zeros((F, P, C), np.float32)), T(idx), T(np.ones((F, P), bool)))
    names = sorted(arrays)

    def jfn(*xs):
        losses = jloss(dict(zip(names, xs), hw=hw, proposals=jp), jnp.asarray(lab), STRIDES, L)
        return losses["total_loss"], losses

    jin = [jnp.asarray(arrays[n].float().numpy()).astype(jnp.bfloat16) for n in names]
    (_, want), jg = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(len(names))),
                                               has_aux=True))(*jin)
    ins = [arrays[n].clone().requires_grad_(True) for n in names]
    got = tscd_loss(dict(zip(names, ins), hw=hw, proposals=pp), T(lab), STRIDES, L)
    got["total_loss"].backward()
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    for n, x, g in zip(names, ins, jg):
        g = np.asarray(g.astype(jnp.float32))
        assert x.grad.dtype == BF
        bound = 1e-5 * np.abs(g).max() + np.abs(g) * 2.0 ** -8
        assert np.all(np.abs(x.grad.float().numpy() - g) <= bound), n


@pytest.mark.parametrize("h,q,k,d,p_valid", [(2, 6, 24, 8, 0.8), (4, 5, 40, 16, 0.5)])
def test_attention_backward_on_bf16_matches_jax_vjp(h, q, k, d, p_valid):
    rng = np.random.default_rng(h * 10 + q)
    B = 2
    mk = lambda *s: T(rng.normal(size=s).astype(np.float32)).to(BF)  # noqa: E731
    qkv = [mk(B, h, q, d), mk(B, h, k, d), mk(B, h, k, d), mk(B, h, q, d),
           mk(B, h, k, d), mk(B, h, k, d)]
    score = rng.uniform(0, 1, (B, k)).astype(np.float32)
    valid = rng.uniform(size=(B, k)) < p_valid
    cot = [rng.normal(size=s).astype(np.float32) for s in ((B, h, q, d), (B, h, q, d),
                                                           (B, h, q, k))]
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    want = []
    for b in range(B):
        _, vjp = jax.vjp(lambda *a: jfa.dual_attention_reference(
            *a, jnp.asarray(score[b]), jnp.asarray(valid[b]), 25.0),
            *(to_j(t[b]) for t in qkv))
        want.append([np.asarray(g.astype(jnp.float32))
                     for g in vjp(tuple(jnp.asarray(c[b]) for c in cot))])
    ins = [t.clone().requires_grad_(True) for t in qkv]
    n0 = pfa.fused_dual_attention.backward_calls
    outs = pfa.fused_dual_attention(*ins, T(score), T(valid))
    assert all(o.dtype == torch.float32 for o in outs)
    grads = torch.autograd.grad(outs, ins, [T(c) for c in cot])
    assert pfa.fused_dual_attention.backward_calls == n0 + 1
    for i, g in enumerate(grads):
        assert g.dtype == BF
        w = np.stack([want[b][i] for b in range(B)])
        bound = 1e-5 * max(np.abs(w).max(), 1) + np.abs(w) * 2.0 ** -8
        assert np.all(np.abs(g.float().numpy() - w) <= bound), i


@pytest.mark.parametrize("flax_format", [True, False], ids=["msgpack", "pth"])
def test_bf16_checkpoint_keeps_the_fp32_masters(steps, tmp_path, flax_format):
    st = steps["port16"]["state"]
    ckpt = {"start_epoch": 1, "step": st.step, "model": st.ema.state_dict(),
            "raw_model": st.model_state(), "optimizer": st.optimizer.state_dict()}
    path = save_checkpoint(ckpt, str(tmp_path),
                           name="latest_ckpt.msgpack" if flax_format else "latest_ckpt.pth")
    model = st.model
    back = load_checkpoint(path, model)
    names = set(st.optimizer.params)
    for key in ("model", "raw_model"):
        for k, v in ckpt[key].items():
            # JAX's layout keeps the EMA's BN statistics only
            if k.endswith("num_batches_tracked") or (flax_format and key == "raw_model"
                                                     and k not in names):
                continue
            assert back[key][k].dtype == v.dtype and torch.equal(back[key][k], v), (key, k)
    assert int(back["start_epoch"]) == 1
    if flax_format:
        tree = serialization.msgpack_restore(open(path, "rb").read())
        assert sorted(tree) == ["batch_stats", "params", "raw_params", "start_epoch"]
        for coll in ("params", "raw_params", "batch_stats"):
            leaves = traverse_util.flatten_dict(tree[coll]).values()
            assert leaves and all(a.dtype == np.float32 for a in leaves), coll
        raw = state_dict_from_flax({"params": tree["raw_params"], "batch_stats": tree["batch_stats"]},
                                   back["raw_model"])
        assert all(torch.equal(raw[n], m) for n, m in st.optimizer.masters.items())
    # a new optimizer resumes from the file's masters, bit for bit
    opt = GroupedSGD(model.named_parameters(), lambda i: LR, freeze_prefixes=FREEZE,
                     masters=back["raw_model"])
    assert all(torch.equal(opt.masters[n], m) for n, m in st.optimizer.masters.items())
