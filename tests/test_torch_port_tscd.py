"""The port's slice as a whole against the JAX package on the CPU, at the
selftest configuration of YOLOX_outputs/validate_ref (depth 0.33, width
0.125, P=6, 1 local + 3 global frames, 128 px):

  (a) the port's parameter names map onto exactly the JAX TSCD tree;
  (b) JAX weights carried into the port give the same refined and
      original detections over 3 streamed windows;
  (c) the reference checkpoint ref_random.pth, loaded by the port and by
      torch_to_flax into JAX, gives the same detections.

Tolerances: fp32 on both sides with another summation order, 1e-4
relative (boxes in pixels, scores in [0, 1]); masks and class ids exact.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tscd_tpu.models.matching import init_matcher_state as jinit
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.models.tscd import tscd_eval_postprocess as jpost
from tscd_tpu.utils.convert import load_torch_checkpoint, torch_to_flax
from tscd_torch.core.predict import make_predict_fn
from tscd_torch.exp.tscd_large import selftest_exp
from tscd_torch.models.tscd import TSCD, random_init_, tscd_eval_postprocess
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.utils.convert import load_reference_pth, state_dict_from_flax
from torch_port_util import perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PTH = os.path.join(REPO, "YOLOX_outputs", "validate_ref", "ref_random.pth")
EXP = selftest_exp()
L, G = EXP.lframe_val, EXP.gframe_val
P, HIDDEN = EXP.num_proposals, int(256 * EXP.width)


def _windows(n=3, seed=11):
    rng = np.random.default_rng(seed)
    H, W = EXP.test_size
    return [(rng.uniform(0, 255, (L + G, H, W, 3)).astype(np.float32),
             get_timing_signal_1d(np.arange(w, w + L + G))) for w in range(n)]


def _jax_model():
    return JTSCD(num_classes=EXP.num_classes, depth=EXP.depth, width=EXP.width,
                 num_proposals=P, minimal_limit=EXP.minimal_limit,
                 heads=EXP.heads)


@pytest.fixture(scope="module")
def jax_side():
    jm = _jax_model()
    x, te = _windows(1)[0]
    init = jax.jit(lambda key: jm.init(key, jnp.asarray(x), jnp.asarray(te),
                                       L, G, False))
    # random BN statistics, scales and biases, so that folding, eps and
    # the original (still-detector) branch all matter
    variables = perturb(init(jax.random.PRNGKey(0)))

    @jax.jit
    def step(v, x, te, st):
        out = jm.apply(v, x, te, L, G, False, st)
        refined, original = jpost(out, L, EXP.num_classes,
                                  nms_thresh=EXP.nmsthre, conf_thre=EXP.test_conf)
        return refined, original, out["matcher_state"]

    return variables, step


def _rows(d, f):
    """Frame f's kept detections as [x1, y1, x2, y2, obj, score, cls] rows."""
    m = np.asarray(d.mask[f])
    cols = [np.asarray(d.boxes[f])[m]] + [np.asarray(getattr(d, k)[f])[m][:, None]
                                          for k in ("obj", "score", "cls_id")]
    return np.concatenate([c.astype(np.float32) for c in cols], 1)


def _match(got, want):
    """For each JAX row, the index of the port row of the same class whose
    values agree within the tolerance (each port row used once)."""
    free, order = list(range(len(got))), []
    for row in want:
        hit = next((i for i in free if got[i, 6] == row[6] and np.allclose(
            got[i, :6], row[:6], atol=1e-4, rtol=1e-4)), None)
        assert hit is not None, f"no port detection matches {row}"
        free.remove(hit)
        order.append(hit)
    return np.asarray(order, dtype=np.int64)


def _assert_same_detections(pd, jd, msg, ordered):
    """Masks exact; per frame the same rows, class ids exact and values
    within 1e-4. With ordered=False a frame's rows are compared as a set."""
    assert np.array_equal(pd.mask.numpy(), np.asarray(jd.mask)), msg
    for f in range(pd.mask.shape[0]):
        got, want = _rows(pd, f), _rows(jd, f)
        if not ordered:
            got = got[_match(got, want)]
        assert np.array_equal(got[:, 6], want[:, 6]), msg
        np.testing.assert_allclose(got[:, :6], want[:, :6], atol=1e-4,
                                   rtol=1e-4, err_msg=msg)


def _stream(port, jvars, step, windows, near_ties=False):
    """Runs both sides over the windows with carried state; compares the
    detections and the matcher bank. With near_ties the inputs leave ranks
    and assignments to fp32 rounding: detections are compared per frame as
    sets and the bank, whose row order the assignment sets, is not."""
    js, ps = jinit(P, HIDDEN, 4 * HIDDEN), None
    n_det = 0
    for w, (x, te) in enumerate(windows):
        jr, jo, js = step(jvars, jnp.asarray(x), jnp.asarray(te), js)
        out = port(torch.from_numpy(x), torch.from_numpy(te), L, G,
                   matcher_state=ps)
        pr, po = tscd_eval_postprocess(out, L, EXP.num_classes,
                                       nms_thresh=EXP.nmsthre,
                                       conf_thre=EXP.test_conf)
        ps = out["matcher_state"]
        for name, jd, pd in (("refined", jr, pr), ("original", jo, po)):
            _assert_same_detections(pd, jd, f"window {w} {name}",
                                    ordered=not near_ties)
            n_det += int(np.asarray(jd.mask).sum())
        if near_ties:
            continue
        for a, b in zip(ps, js):
            np.testing.assert_allclose(a.numpy().astype(np.float32),
                                       np.asarray(b).astype(np.float32),
                                       atol=1e-4, rtol=1e-4)
    return n_det


def test_port_names_map_onto_the_jax_tree(jax_side):
    variables, _ = jax_side
    port = EXP.get_model(device="cpu")
    conv = torch_to_flax({k: v.numpy() for k, v in port.state_dict().items()})
    for coll in ("params", "batch_stats"):
        got = {k: v.shape for k, v in traverse_util.flatten_dict(conv[coll]).items()}
        want = {k: v.shape for k, v in traverse_util.flatten_dict(variables[coll]).items()}
        assert got == want, coll


def test_jax_weights_stream_three_windows(jax_side):
    variables, step = jax_side
    port = EXP.get_model(device="cpu")
    port.load_state_dict(state_dict_from_flax(variables, port.state_dict()))
    assert _stream(port, variables, step, _windows()) > 0


# reference modules the port has no counterpart for: the matcher's
# never-called self-attention/FFN layers and edge embedding, the fixed
# Haar filter buffers, the box-position bias no ported caller uses, and
# the reconf-only layers the non-reconf `agg` builds but never runs
_UNUSED_REF = ("transformer_self_attention_layers", "transformer_ffn_layers",
               "edge_feature_embedding", ".dwt.", ".idwt.",
               "multihead_attn.position_embedding", "head.agg.mca.linear_reg.",
               "head.agg.linear_obj.")


def test_reference_checkpoint_gives_same_detections(jax_side):
    _, step = jax_side
    port = EXP.get_model(device="cpu")
    res = port.load_state_dict(load_reference_pth(REF_PTH), strict=False)
    assert res.missing_keys == []
    assert res.unexpected_keys
    assert all(any(s in k for s in _UNUSED_REF) for k in res.unexpected_keys)
    assert all(any(s in k for k in res.unexpected_keys) for s in _UNUSED_REF)
    jvars = torch_to_flax(load_torch_checkpoint(REF_PTH))
    # the checkpoint's random weights make the aggregated embeddings nearly
    # parallel: the matcher's costs, and the final scores, differ only in
    # their last fp32 digits
    assert _stream(port, jvars, step, _windows(seed=12), near_ties=True) > 0


def test_predict_fn_rows_and_resume():
    port = random_init_(EXP.get_model(device="cpu"), 0)
    predict = make_predict_fn(port, L, G, EXP.nmsthre, EXP.test_conf)
    (x0, te0), (x1, te1) = _windows(2)
    dets, st = predict(x0, te0, False, None)
    assert len(dets) == L and dets[0].ndim == 2 and dets[0].shape[1] == 7
    assert np.isfinite(dets[0]).all() and bool(st.has_state)
    carried, _ = predict(x1, te1, True, st)
    fresh, _ = predict(x1, te1, False, st)      # resume=False ignores st
    fresh2, _ = predict(x1, te1, True, None)
    assert np.array_equal(fresh[0], fresh2[0])
    assert carried[0].shape[1] == 7


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSCD(depth=0.33, width=0.125)


def test_port_imports_no_jax():
    """Every module of tscd_torch, and chip_smoke.py, imports with jax,
    flax and tscd_tpu blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'tscd_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import tscd_torch\n"
        "for info in pkgutil.walk_packages(tscd_torch.__path__, 'tscd_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tscd_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
