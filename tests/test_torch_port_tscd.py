"""The port's slice as a whole against the JAX package on the CPU, at the
selftest configuration of YOLOX_outputs/validate_ref (depth 0.33, width
0.125, P=6, 1 local + 3 global frames, 128 px):

  (a) the port's parameter names map onto exactly the JAX TSCD tree, the
      default one and that of each model knob that changes it;
  (b) JAX weights carried into the port give the same refined and
      original detections over 3 streamed windows;
  (c) the reference checkpoint ref_random.pth, loaded by the port and by
      torch_to_flax into JAX, gives the same detections.

Tolerances: fp32 on both sides with another summation order, 1e-4
relative (boxes in pixels, scores in [0, 1]); masks and class ids exact.
"""

import ast
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

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# the model knobs whose trees differ from the default's
_TREES = ({"agg_type": "mca_aware"}, {"reconf": False}, {"decouple_reg": False},
          {"agg_type": "mca_aware", "decouple_reg": False}, {"act": "relu"})


def test_port_names_map_onto_the_jax_tree(jax_side):
    """The default tree, then the tree of each knob that changes it (its
    shapes from jax.eval_shape); the port's state_dict carried back to
    flax (`flax_from_state_dict`) lands on the same paths."""
    from tscd_torch.utils.convert import flax_from_state_dict
    variables, _ = jax_side
    trees = [({}, variables)]
    x, te = _windows(1)[0]
    for knobs in _TREES:
        jm = JTSCD(num_classes=EXP.num_classes, depth=EXP.depth, width=EXP.width,
                   num_proposals=P, minimal_limit=EXP.minimal_limit, heads=EXP.heads,
                   **knobs)
        trees.append((knobs, jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(te), L, G))))
    for knobs, tree in trees:
        exp = selftest_exp()
        for k, v in knobs.items():
            setattr(exp, k, v)
        sd = exp.get_model(device="cpu").state_dict()
        conv = torch_to_flax({k: v.numpy() for k, v in sd.items()})
        back = flax_from_state_dict(sd)
        for coll in ("params", "batch_stats"):
            want = {k: v.shape for k, v in traverse_util.flatten_dict(tree[coll]).items()}
            for got in (conv[coll], back[coll]):
                got = {k: v.shape for k, v in traverse_util.flatten_dict(got).items()}
                assert got == want, (knobs, coll)


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
    """Every module of tscd_torch (data, eval, postprocess and tools
    included), and chip_smoke.py, imports with jax, flax, tscd_tpu, cv2 and
    PIL blocked (the card's machine has none of them)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'tscd_tpu', 'cv2', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import tscd_torch\n"
        "names = [info.name for info in pkgutil.walk_packages(tscd_torch.__path__, 'tscd_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('tscd_torch.data.vid', 'tscd_torch.eval.vid_evaluator',\n"
        "             'tscd_torch.eval.fast_cocoeval', 'tscd_torch.tools.tscd_eval',\n"
        "             'tscd_torch.exp.build', 'tscd_torch.ops.kernels.nms',\n"
        "             'tscd_torch.tools.tscd_demo', 'tscd_torch.utils.visualize',\n"
        "             'tscd_torch.utils.video', 'tscd_torch.postprocess.repp'):\n"
        "    assert name in names, name\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tscd_tpu', 'cv2',"
        " 'PIL')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def _code_strings(tree):
    """String constants of a module that are not docstrings."""
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_port_sources_reach_nothing_of_tscd_tpu():
    """No import of tscd_tpu, no path into tscd_tpu/ in the port's code
    (docstrings and comments may name its files), and no C++ or CUDA
    source that includes one: the port builds nothing from there."""
    root = os.path.join(REPO, "tscd_torch")
    n = 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            if f.endswith(".py"):
                tree = ast.parse(open(path).read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Import):
                        assert not any(a.name.split(".")[0] == "tscd_tpu"
                                       for a in node.names), path
                    if isinstance(node, ast.ImportFrom):
                        assert (node.module or "").split(".")[0] != "tscd_tpu", path
                assert not [v for v in _code_strings(tree) if "tscd_tpu" in v], path
                n += 1
            elif f.endswith((".cu", ".cuh", ".cpp", ".h")):
                includes = [ln for ln in open(path) if ln.lstrip().startswith("#include")]
                assert not [ln for ln in includes if "tscd_tpu" in ln], path
                n += 1
    assert n > 40
    from tscd_torch.eval import fast_cocoeval
    assert os.path.commonpath([str(fast_cocoeval._SRC), root]) == root
