"""TSCD head pieces of the port against the JAX package on the CPU:
proposal selection and feature gather, MCA aggregation (the fused branch
and the masked branch), a streamed RegMatcher with its first-frame
reset, TaskAligned, the wavelet edge block, NMS and the postprocess.

Tolerances: fp32 with another summation order, 1e-4 relative (boxes in
pixels 1e-4 relative); discrete outputs (indices, masks, class ids,
matcher validity) are exact. The traps of the reference are pinned:
LayerNorm eps 1e-6, the two `_l2norm` eps conventions, stable top-k and
NMS tie order, the Haar band signs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.models import aggregation as jagg
from tscd_tpu.models import matching as jmat
from tscd_tpu.models import tscd_head as jhead
from tscd_tpu.ops import nms as jnms
from tscd_tpu.ops import postprocess as jpost
from tscd_tpu.ops import wavelets as jwav
from tscd_torch.models import aggregation as pagg
from tscd_torch.models import matching as pmat
from tscd_torch.models import tscd_head as phead
from tscd_torch.models.yolo_head import flatten_levels
from tscd_torch.ops import nms as pnms
from tscd_torch.ops import postprocess as ppost
from tscd_torch.ops import wavelets as pwav
from torch_port_util import carry

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.from_numpy


def close(got, want, tol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=msg)


def test_proposals_and_gathered_features():
    rng = np.random.default_rng(0)
    F, L, width = 4, 1, 0.125
    shapes = [(16, 16, 32), (8, 8, 64), (4, 4, 128)]
    xin = [rng.normal(size=(F,) + s).astype(np.float32) for s in shapes]
    te = rng.normal(size=(F, 256)).astype(np.float32)
    jm = jhead.TSCDHead(num_classes=30, width=width, num_proposals=6)
    pm = phead.TSCDHead(30, width=width, num_proposals=6).eval()
    variables = carry(jm, pm, [jnp.asarray(x) for x in xin], jnp.asarray(te),
                      L, F - L)
    jout, inter = jax.jit(lambda v, xs: jm.apply(
        v, xs, jnp.asarray(te), L, F - L, stage="dense",
        capture_intermediates=True, mutable=["intermediates"]))(
        variables, [jnp.asarray(x) for x in xin])
    inter = inter["intermediates"]
    x_nchw = [T(x).permute(0, 3, 1, 2) for x in xin]
    with torch.no_grad():
        out = pm(x_nchw, T(te), L)
        stems = [pm.stems[k](x) for k, x in enumerate(x_nchw)]
        feats = {"cls_conv2": [pm.cls_convs2[k](s) for k, s in enumerate(stems)],
                 "reg_conv2": [pm.reg_convs2[k](s) for k, s in enumerate(stems)]}
        feats["edge"] = [pm.edge_enhance_reg[k](r[:L])
                         for k, r in enumerate(feats["reg_conv2"])]
    jp, pp = jout["proposals"], out["proposals"]
    assert np.array_equal(np.asarray(jp.idx), pp.idx.numpy())
    assert np.array_equal(np.asarray(jp.valid), pp.valid.numpy())
    assert np.array_equal(np.asarray(jp.cls_id), pp.cls_id.numpy())
    close(pp.boxes, jp.boxes, msg="boxes")
    close(pp.obj, jp.obj)
    close(pp.cls_scores, jp.cls_scores)
    close(out["decoded"], jout["decoded"], msg="decoded")
    idx = np.asarray(jp.idx)
    for name, suffix in (("cls_conv2", "_1"), ("reg_conv2", "_1"), ("edge", "")):
        jl = [np.asarray(inter[f"{name}_{k}{suffix}"]["__call__"][0])
              for k in range(3)]
        jflat = np.concatenate([a.reshape(a.shape[0], -1, a.shape[-1]) for a in jl], 1)
        pflat = flatten_levels(feats[name]).numpy()
        n = jflat.shape[0]
        close(np.take_along_axis(pflat, idx[:n, :, None], 1),
              np.take_along_axis(jflat, idx[:n, :, None], 1), msg=name)


def test_proposal_ties_rank_the_lower_anchor_first():
    dec = np.zeros((1, 40, 35), np.float32)
    dec[..., 2:4] = 4.0
    dec[..., 4] = 0.5
    dec[..., 5] = np.repeat([0.2, 0.4], 20)          # two tied score groups
    jp = jhead.select_frame_proposals(jnp.asarray(dec), 30, 25, 0.001, 0.75,
                                      False, 5)
    pp = phead.select_frame_proposals(T(dec), 30, 25, 0.001, 5)
    assert np.array_equal(np.asarray(jp.idx), pp.idx.numpy())
    assert pp.idx[0, :20].tolist() == list(range(20, 40))


def _agg_inputs(rng, F=4, P=6, C=32):
    return (rng.normal(size=(F, P, C)).astype(np.float32),
            rng.normal(size=(F, P, C)).astype(np.float32),
            rng.uniform(0, 1, (F, P)).astype(np.float32),
            rng.uniform(0, 1, (F, P)).astype(np.float32),
            rng.uniform(size=(F, P)) > 0.25)


@pytest.mark.parametrize("use_mask", [False, True])
def test_mcag2l_matches(use_mask):
    """use_mask=False runs the port's fused branch (the kernel's plain
    version on the CPU) against JAX's unfused branch; use_mask=True runs
    the masked branch on both sides. The low sim thresholds make the
    round-2 masks non-trivial."""
    ins = _agg_inputs(np.random.default_rng(1))
    L = 2
    kw = dict(sim_thresh=0.1, use_mask=use_mask, conf_sim_thresh=0.2)
    jm = jagg.MCAg2l(128, 4, reconf=True)
    pm = pagg.MCAg2l(32, 128, 4, reconf=True)
    jins = [jnp.asarray(a) for a in ins]
    variables = carry(jm, pm, *jins, L, **kw)
    jc, jr = jm.apply(variables, *jins, L, **kw)
    pc, pr = pm(*map(T, ins), L, **kw)
    close(pc.detach(), jc, msg="cls")
    close(pr.detach(), jr, msg="reg")


def _matcher_window(rng, L, P=6, C=32, Cr=128, p_valid=0.7):
    return (rng.normal(size=(L, P, C)).astype(np.float32),
            rng.normal(size=(L, P, Cr)).astype(np.float32),
            rng.normal(size=(L, P, Cr)).astype(np.float32),
            rng.normal(size=(L, P, C)).astype(np.float32),
            rng.normal(size=(L, 256)).astype(np.float32),
            rng.uniform(size=(L, P)) < p_valid)


def test_reg_matcher_stream_with_reset():
    """Three streamed windows of two local frames with the carried bank,
    then a fresh state (the sequence-start reset): outputs and every
    field of the bank match, the assignment-driven fields exactly."""
    rng = np.random.default_rng(2)
    jm = jmat.RegMatcher(num_heads=8, num_layers=1)
    pm = pmat.RegMatcher(32, num_heads=8, num_layers=1)
    w0 = _matcher_window(rng, 2)
    variables = carry(jm, pm, *map(jnp.asarray, w0), jmat.init_matcher_state(6, 32, 128))
    apply = jax.jit(jm.apply)
    js, ps = None, None
    for w in range(4):
        win = w0 if w == 0 else _matcher_window(rng, 2)
        if w in (0, 3):
            js, ps = jmat.init_matcher_state(6, 32, 128), pmat.init_matcher_state(6, 32, 128)
        jo, js = apply(variables, *map(jnp.asarray, win), js)
        with torch.no_grad():
            po, ps = pm(*map(T, win), ps)
        close(po, jo, msg=f"window {w} outputs")
        for name, a, b in zip(pmat.MatcherState._fields, ps, js):
            if b.dtype == jnp.bool_:
                assert np.array_equal(a.numpy(), np.asarray(b)), (w, name)
            else:
                close(a, b, msg=f"window {w} {name}")


def test_task_aligned_and_se_gate_match():
    rng = np.random.default_rng(3)
    reg = rng.normal(size=(2, 6, 128)).astype(np.float32)
    obj = rng.normal(size=(2, 6, 128)).astype(np.float32)
    valid = rng.uniform(size=(2, 6)) < 0.7
    jm, pm = jmat.TaskAligned(8, 1), pmat.TaskAligned(128, 8, 1)
    variables = carry(jm, pm, jnp.asarray(reg), jnp.asarray(obj), jnp.asarray(valid))
    with torch.no_grad():
        close(pm(T(reg), T(obj), T(valid)),
              jm.apply(variables, jnp.asarray(reg), jnp.asarray(obj), jnp.asarray(valid)))
    jg, pg = jmat.SEGate(), pmat.SEGate()
    variables = carry(jg, pg, jnp.asarray(reg), jnp.asarray(obj))
    with torch.no_grad():
        close(pg(T(reg), T(obj)), jg.apply(variables, jnp.asarray(reg), jnp.asarray(obj)))


def test_layernorm_and_l2norm_eps_traps():
    for mod in (pmat.RegMatcher(32), pmat.TaskAligned(128)):
        eps = {m.eps for m in mod.modules() if isinstance(m, torch.nn.LayerNorm)}
        assert eps == {1e-6}           # flax's default, not torch's 1e-5
    tiny = np.full((3, 4), 1e-7, np.float32)
    close(pmat._l2norm(T(tiny)), jmat._l2norm(jnp.asarray(tiny)), tol=1e-6)
    close(pagg._l2norm(T(tiny)), jagg._l2norm(jnp.asarray(tiny)), tol=1e-6)
    assert not np.allclose(pmat._l2norm(T(tiny)).numpy(),
                           pagg._l2norm(T(tiny)).numpy())


def test_position_geometry_matches():
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 100, (5, 2))
    b = np.concatenate([xy, xy + rng.uniform(5, 50, (5, 2))], 1).astype(np.float32)
    r = b[::-1].copy()
    pm = pmat.extract_position_matrix(T(b), T(r))
    close(pm, jmat.extract_position_matrix(jnp.asarray(b), jnp.asarray(r)))
    close(pmat.extract_position_embedding(pm),
          jmat.extract_position_embedding(jnp.asarray(pm.numpy())))
    off = rng.normal(0, 0.5, (5, 4)).astype(np.float32)
    off[0, 2] = 10.0                                 # beyond the dw clip
    close(phead.decode_reg_offsets(T(off), T(b)),
          jhead.decode_reg_offsets(jnp.asarray(off), jnp.asarray(b)))


@pytest.mark.parametrize("h,w", [(8, 8), (5, 7)])
def test_wavelet_edge_block_matches(h, w):
    x = np.random.default_rng(5).normal(size=(2, h, w, 8)).astype(np.float32)
    jm, pm = jwav.WaveletsHFBlock(), pwav.WaveletsHFBlock(8)
    variables = carry(jm, pm, jnp.asarray(x))
    with torch.no_grad():
        got = pm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, jm.apply(variables, jnp.asarray(x)))
    if h % 2 == 0:
        bands = pwav.haar_dwt2d(T(x).permute(0, 3, 1, 2))
        for g, j in zip(bands, jwav.haar_dwt2d(jnp.asarray(x))):
            close(g.permute(0, 2, 3, 1), j, tol=1e-6)


def _boxes(rng, K, span=60.0):
    xy = rng.uniform(0, span, (K, 2))
    return np.concatenate([xy, xy + rng.uniform(5, 30, (K, 2))], 1).astype(np.float32)


def test_nms_matches_including_ties_and_invalid():
    rng = np.random.default_rng(6)
    K = 64
    boxes = np.stack([_boxes(rng, K) for _ in range(2)])
    scores = np.round(rng.uniform(0, 1, (2, K)), 1).astype(np.float32)  # ties
    valid = rng.uniform(size=(2, K)) < 0.8
    cls = rng.integers(0, 3, (2, K))
    keep = pnms.nms_fixed(T(boxes), T(scores), T(valid), 0.5).numpy()
    keep_c = pnms.batched_class_aware_nms(T(boxes), T(scores), T(cls), T(valid),
                                          0.5).numpy()
    for b in range(2):
        args = [jnp.asarray(a[b]) for a in (boxes, scores, valid)]
        assert np.array_equal(keep[b], np.asarray(jnms.nms_fixed(*args, 0.5)))
        assert np.array_equal(keep_c[b], np.asarray(jnms.batched_class_aware_nms(
            args[0], args[1], jnp.asarray(cls[b]), args[2], 0.5)))


def test_postprocess_matches():
    rng = np.random.default_rng(7)
    L, P, C = 2, 6, 30
    boxes = np.stack([_boxes(rng, P) for _ in range(L)])
    obj = rng.uniform(0, 1, (L, P)).astype(np.float32)
    cls_scores = rng.uniform(0, 1, (L, P, C)).astype(np.float32) ** 4
    valid = rng.uniform(size=(L, P)) < 0.8
    got = ppost.postprocess_refined(T(boxes), T(obj), T(cls_scores), T(valid),
                                    0.01, 0.5, 100)
    cls_conf, cls_id = cls_scores.max(-1), cls_scores.argmax(-1)
    got_b = ppost.postprocess_best_class(T(boxes), T(obj), T(cls_conf), T(cls_id),
                                         T(valid), 0.01, 0.5, 100)
    for f in range(L):
        want = jpost.postprocess_refined(jnp.asarray(boxes[f]), jnp.asarray(obj[f]),
                                         jnp.asarray(cls_scores[f]),
                                         jnp.asarray(valid[f]), 0.01, 0.5, 100)
        want_b = jpost.postprocess_best_class(
            jnp.asarray(boxes[f]), jnp.asarray(obj[f]), jnp.asarray(cls_conf[f]),
            jnp.asarray(cls_id[f]), jnp.asarray(valid[f]), 0.01, 0.5, 100)
        for g, wnt in ((got, want), (got_b, want_b)):
            assert np.array_equal(g.mask[f].numpy(), np.asarray(wnt.mask))
            assert np.array_equal(g.cls_id[f].numpy(), np.asarray(wnt.cls_id))
            for a, b in zip((g.boxes, g.obj, g.score), (wnt.boxes, wnt.obj, wnt.score)):
                close(a[f], b, tol=1e-6)
