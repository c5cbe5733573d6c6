"""The port's LocalAggregation family (SelfAttentionLocal, LocalFFN,
TransformerBlockLocal, LocalAggregation) and the heads that run it
against the JAX package on the CPU, on inputs and weights made from
numpy seeds (JAX's parameter trees carried across by utils.convert):

  - LocalAggregation on 32 proposals (4 frames x 8, some keys invalid,
    boxes overlapping across frames), its options one by one: the
    relation bias added and multiplied (use_loc_emb, loc_fuse_type), no
    relation, pure_pos_emb, use_time_emd (with each embedding), loc_conf,
    iou_base with iou_window 0 and 1, reconf (with iou_base too),
    use_ffn off, 2 blocks: both outputs 1e-4;
  - YOLOVPlusHead with agg_type "localagg", reconf on and off (and
    decouple_reg, which localagg does not read), lframe 0 and 2, and
    TSCD's head with agg_type "localagg" (reconf on and off): the dense
    outputs and proposals as in tests/test_torch_port_yolov.py; the
    refined logits (and TSCD's obj logits, offsets and boxes) held to
    JAX's (jitted, fp32) at a fixed tolerance a case, of the largest
    value: 5e-4, and 5e-3 where the case is ill-conditioned. The
    relation bias enters the logits as log(relu(b) + 1e-6), whose slope
    is up to 1e6 where b is near 0, so fp32 cannot give these logits to
    1e-4 where a row's biases all sit near 0. Measured on the CPU, of the
    largest value: the port from JAX 3.7e-3 in plus_reconf_off_decouple_L0
    (JAX 3.4e-3 from a float64 run, the port 2.9e-4), at most 1.5e-4 in
    the other cases. Besides, the port's outputs are held within 1e-3 of
    the largest value to a float64 rerun of the port's own aggregation and
    Linear heads on the inputs it captured (2.9e-4 measured at most);
  - the JAX parameter trees of both heads round-trip through
    utils.convert (transBlocks.i -> block_i, self_attn -> attn, the FFN's
    net.0 / net.3 -> fc1 / fc2, loc2feature's 1x1 conv).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.models import tscd_head as jth
from tscd_tpu.models import yolov_heads as jyh
from tscd_torch.models import tscd_head as pth
from tscd_torch.models import yolov_heads as pyh
from tscd_torch.models.tscd_head import decode_reg_offsets
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.utils.convert import flatten_tree, flax_from_state_dict, state_dict_from_flax
from torch_port_util import seeded_variables

T = torch.as_tensor
C, P, WIDTH, F, HEADS = 5, 8, 0.125, 4, 2
FPN = [(8, 8, 32), (4, 4, 64), (2, 2, 128)]     # 64 px, width 0.125


def close(got, want, tol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=tol * max(1.0, float(np.abs(want).max(initial=0))),
                               rtol=tol, err_msg=msg)


def _load(pm, variables):
    sd = state_dict_from_flax(variables, pm.state_dict())
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    return pm


OPTIONS = {
    "defaults": {},
    "fuse_dot": dict(loc_fuse_type="dot"),
    "no_loc_emb": dict(use_loc_emb=False, loc_fuse_type="identity"),
    "pure_pos_emb": dict(pure_pos_emb=True),
    "time_emd": dict(use_time_emd=True),
    "pure_pos_emb_time_emd": dict(pure_pos_emb=True, use_time_emd=True),
    "loc_conf": dict(loc_conf=True),
    "iou_base": dict(iou_base=True),
    "iou_base_window": dict(iou_base=True, iou_window=1),
    "reconf": dict(reconf=True),
    "reconf_iou_base_window": dict(reconf=True, iou_base=True, iou_window=1),
    "no_ffn": dict(use_ffn=False),
    "blocks_2_reconf": dict(blocks=2, reconf=True),
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_local_aggregation_option_matches_jax(case):
    opts = OPTIONS[case]
    rng = np.random.default_rng(1)
    Cd, N = 32, F * P
    x_cls, x_reg = (rng.normal(size=(N, Cd)).astype(np.float32) for _ in range(2))
    cxy = rng.uniform(20, 100, size=(N, 2)).astype(np.float32)
    cxy[P:2 * P] = cxy[:P] + 3.0              # overlaps across frames (iou_base)
    wh = rng.uniform(10, 40, size=(N, 2)).astype(np.float32)
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    cs = rng.uniform(0, 1, N).astype(np.float32)
    fs = rng.uniform(0, 0.01, N).astype(np.float32)     # some under loc_conf's 0.001
    valid = rng.uniform(size=N) > 0.2
    args = [jnp.asarray(a) for a in (x_cls, x_reg, boxes, cs, fs, valid)]
    jm = jyh.LocalAggregation(num_heads=HEADS, **opts)
    variables = seeded_variables(jm, 2, *args, F, P, 128, 128)
    pm = _load(pyh.LocalAggregation(Cd, HEADS, **opts).eval(), variables)
    want = jm.apply(variables, *args, F, P, 128, 128)
    with torch.no_grad():
        got = pm(*(T(a) for a in (x_cls, x_reg, boxes, cs, fs, valid)), F, P, 128, 128)
    close(got[0], want[0], msg="cls")
    close(got[1], want[1], msg="reg")
    if not opts.get("reconf"):
        assert np.array_equal(got[1].numpy(), x_reg)       # passed through


def test_iou_window_mask_matches_jax():
    for window in (1, 2):
        want = np.asarray(jyh.iou_window_mask(24, 3, 8, window))
        assert np.array_equal(pyh.iou_window_mask(24, 3, 8, window).numpy(), want)


def _float64_agg(pm, cap, names):
    """The captured aggregation call and the named Linear heads after it,
    again in float64 on deep copies."""
    agg = copy.deepcopy(pm.agg).double()
    args = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in cap["args"]]
    with torch.no_grad():
        c, r = agg(*args)
    return c, r, {n: copy.deepcopy(getattr(pm, n)).double() for n in names}


def _held(got, want, exact, tol, msg):
    """The port's fp32 `got` within `tol` of the largest value of JAX's fp32
    `want`, and within 1e-3 of the largest value of the float64 rerun
    `exact`."""
    got, want, exact = (np.asarray(t, np.float64) for t in (got, want, exact))
    for ref, t, name in ((want, tol, "JAX"), (exact, 1e-3, "float64")):
        err, lim = np.abs(got - ref).max(), t * max(1.0, float(np.abs(ref).max()))
        assert err <= lim, (msg, name, err, lim)


# (head, L, knobs, tolerance of the refined outputs against JAX's)
LOCALAGG_HEADS = {
    "plus_reconf_L0": ("p", 0, dict(reconf=True), 5e-4),
    "plus_reconf_decouple_L2": ("p", 2, dict(reconf=True, decouple_reg=True), 5e-4),
    "plus_reconf_off_L2": ("p", 2, dict(reconf=False, decouple_reg=False), 5e-4),
    "plus_reconf_off_decouple_L0": ("p", 0, dict(reconf=False, decouple_reg=True), 5e-3),
    "tscd_reconf": ("t", 1, dict(reconf=True), 5e-4),
    "tscd_reconf_off": ("t", 1, dict(reconf=False), 5e-4),
}


@pytest.mark.parametrize("case", sorted(LOCALAGG_HEADS))
def test_localagg_heads_match_jax(case):
    kind, L, knobs, tol = LOCALAGG_HEADS[case]
    rng = np.random.default_rng(0)
    xin = [rng.normal(size=(F,) + s).astype(np.float32) for s in FPN]
    jx = [jnp.asarray(x) for x in xin]
    te = get_timing_signal_1d(np.arange(F, dtype=np.float32), 256).astype(np.float32)
    if kind == "p":
        jm = jyh.YOLOVPlusHead(num_classes=C, width=WIDTH, heads=HEADS, num_proposals=P,
                               agg_type="localagg", **knobs)
        pm = pyh.YOLOVPlusHead(C, width=WIDTH, heads=HEADS, num_proposals=P,
                               agg_type="localagg", **knobs)
        jargs, pargs = (L, F - L), (L, F - L)
    else:
        jm = jth.TSCDHead(num_classes=C, width=WIDTH, heads=HEADS, num_proposals=P,
                          agg_type="localagg", **knobs)
        pm = pth.TSCDHead(C, width=WIDTH, heads=HEADS, num_proposals=P,
                          agg_type="localagg", **knobs)
        jargs, pargs = (jnp.asarray(te), L, F - L), (T(te), L)
    variables = seeded_variables(jm, 3, jx, *jargs)
    pm = _load(pm.eval(), variables)
    jout = jax.jit(lambda v, xs: jm.apply(v, xs, *jargs))(variables, jx)
    cap = {}
    pm.agg.register_forward_hook(lambda m, a, o: cap.update(args=a))
    with torch.no_grad():
        out = pm([T(x).permute(0, 3, 1, 2) for x in xin], *pargs)
    jp, pp = jout["proposals"], out["proposals"]
    for name in ("idx", "valid", "cls_id"):
        assert np.array_equal(np.asarray(getattr(jp, name)), getattr(pp, name).numpy()), name
    for name in ("raw_outputs", "decoded"):
        close(out[name], jout[name], msg=name)
    skip = {"hw", "proposals", "matcher_state", "raw_outputs", "decoded"}
    assert {k for k in out if k not in skip} == {k for k in jout if k not in skip}
    R = L if (kind == "t" or L > 0) else F
    reconf = knobs["reconf"]
    names = ["cls_pred"] + (["obj_pred"] + (["reg_pred"] if kind == "t" else [])
                            if reconf else [])
    c64, r64, lin = _float64_agg(pm, cap, names)
    c64, r64 = (t.reshape(F, P, -1)[:R] for t in (c64, r64))
    with torch.no_grad():
        exact = {"refined_cls_logits": lin["cls_pred"](c64)}
        if kind == "p" and reconf:
            exact["refined_obj_logits"] = lin["obj_pred"](r64)[..., 0]
        if kind == "t" and reconf:
            exact["matcher_obj_logits"] = lin["obj_pred"](r64)[..., 0]
            exact["matcher_reg_offsets"] = lin["reg_pred"](r64)
            exact["refined_boxes"] = decode_reg_offsets(exact["matcher_reg_offsets"],
                                                        pp.boxes[:R].double())
    for name, ex in exact.items():
        _held(out[name], jout[name], ex, tol, name)
    assert ("refined_obj_logits" in out) == (kind == "p" and reconf)
    assert ("refined_boxes" in out) == (kind == "t" and reconf)
    # the round trip of the tree through utils.convert
    back = flax_from_state_dict(pm.state_dict())
    for c in ("params", "batch_stats"):
        want = flatten_tree(variables.get(c, {}))
        got = flatten_tree(back[c])
        assert set(got) == set(want), (c, sorted(set(got) ^ set(want))[:6])
        for k in want:
            assert np.array_equal(got[k], want[k]), k
