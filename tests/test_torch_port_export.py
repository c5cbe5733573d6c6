"""The port's export path against the JAX package on the CPU: the hand
kernels as torch ops (`tscd_torch/ops/kernels/ops.py`), `torch.export`
of the port's models (`tscd_torch/tools/export.py`), the host decode and
NMS of the deploy runner (`csrc/host/yolox_deploy.cpp`), the C++ ops'
schemas (`csrc/torch_ops.cpp`) and `select_proposals`. On the CPU each
op is its kernel's plain version; the AOTInductor package and the C++
runner need the card (tests/test_torch_port_cuda.py, chip_smoke.py phase
`export`).

  - Each op's fake implementation gives its real output's shape, dtype
    and device (`torch.library.opcheck`'s fake-tensor check).
  - `torch.export` of a tiny YOLOX (--raw at fp32, and --int8 with the
    C_in gate at 16) and of the selftest TSCD's streaming step (2
    windows, the state carried): the saved program's graph holds the
    hand kernels' ops and none of their plain versions, and its outputs
    equal the eager port's bit for bit.
  - The exported tiny YOLOX on the weights of a JAX YOLOX against JAX's
    own export round trip (jax.export, tools/export.py): raw outputs
    within 1e-4 of the largest value (fp32 in two frameworks' orders; JAX
    holds its own round trip to 1e-4 relative).
  - The deploy decode and NMS, the port's build against JAX's
    (tscd_tpu.native.load_library("yolox_deploy")) through ctypes on the
    same raw output: equal rows. The synthetic image equals the JAX
    runner test's.
  - csrc/torch_ops.cpp defines each op it registers with the Python op's
    schema, character for character.
  - select_proposals (single and batched) against JAX's on decoded
    predictions with tied objectness: the same anchors in the same
    order, the masks and -inf-dead slots equal, values exact.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.models.yolox import YOLOX as JYOLOX
from tscd_tpu.native import load_library
from tscd_tpu.ops import postprocess as jpost
from tscd_torch.exp import get_exp
from tscd_torch.exp.tscd_large import selftest_exp
from tscd_torch.models import blocks as pblk
from tscd_torch.models.yolox import YOLOX
from tscd_torch.ops import postprocess as ppost
from tscd_torch.ops.kernels import focus_stem as pfs
from tscd_torch.ops.kernels import int8_conv as q8
from tscd_torch.ops.kernels import ops
from tscd_torch.tools import export as ex
from tscd_torch.utils import native
from tscd_torch.utils.convert import state_dict_from_flax
from torch_port_util import seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
HW = 64
C = 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the ops -------------------------------------------------------------------

def _op_cases():
    rng = np.random.default_rng(0)
    f = lambda *s: T(rng.normal(size=s).astype(np.float32))   # noqa: E731
    x8 = T(rng.integers(0, 256, (2, 16, 12, 3), dtype=np.uint8))
    stem = (f(8, 12, 3, 3), f(8).abs() + 0.5, f(8))
    xq = q8.quantize_reference(f(2, 40, 6, 5), torch.tensor([3.0]), "dynamic")
    wq = q8.pack_reference(f(24, 40, 3, 3), torch.full((24,), 0.02))
    boxes = torch.sort(f(2, 40, 4).abs() * 20, -1).values[..., [0, 1, 2, 3]]
    boxes = torch.cat([boxes[..., :2], boxes[..., :2] + boxes[..., 2:] + 1], -1)
    q = lambda n: f(1, 2, n, 8)   # noqa: E731
    return {
        "focus_stem": (f(2, 16, 12, 3) * 50, *stem),
        "focus_stem_bf16": (x8, *stem),
        "fused_dual_attention": (q(5), q(9), q(9), q(5), q(9), q(9), f(1, 9).abs(),
                                 T(rng.uniform(size=(1, 9)) < 0.7), None, 25.0),
        "linear_sum_assignment": (f(2, 6, 6),),
        "nms_pack": (boxes, 0.5),
        "nms_sorted": (boxes, T(rng.uniform(size=(2, 40)) < 0.8), 0.5),
        "int8_absmax": (f(2, 3, 4, 5),),
        "int8_quantize": (f(2, 40, 6, 5), f(40).abs() + 0.1, 1),
        "int8_conv": (xq, wq, torch.full((24,), 0.02), f(24), torch.tensor([3.0]), 1, 1, False,
                      1, 0),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_each_ops_fake_gives_its_real_outputs_shapes(name):
    op = getattr(torch.ops.tscd, name).default
    torch.library.opcheck(op, _op_cases()[name], test_utils="test_faketensor")


def test_every_op_is_registered_with_its_schema():
    assert set(ops.schemas()) == set(_op_cases())
    got = ops.schemas()["int8_conv"]
    assert got.startswith("int8_conv(Tensor xq, Tensor wq, Tensor s_w, Tensor bias, Tensor sx,")


def test_torch_ops_cpp_defines_the_python_schemas():
    src = open(os.path.join(REPO, "tscd_torch", "csrc", "torch_ops.cpp")).read()
    defs = re.findall(r'm\.def\(((?:\s*"[^"]*")+)\)', src)
    cpp = ["".join(re.findall(r'"([^"]*)"', d)) for d in defs]
    impls = re.findall(r'm\.impl\("(\w+)"', src)
    want = ops.schemas()
    assert [s.split("(")[0] for s in cpp] == impls == [
        "focus_stem", "focus_stem_bf16", "int8_absmax", "int8_quantize", "int8_conv"]
    for s in cpp:
        assert s == want[s.split("(")[0]]


# -- torch.export --------------------------------------------------------------

def _yolox_exp():
    exp = get_exp(None, "yolox_s")
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, C
    exp.test_size = (HW, HW)
    return exp


@pytest.mark.parametrize("kind", ["raw", "int8"])
def test_yolox_export_equals_eager(kind, tmp_path):
    old = pblk.INT8_MIN_CIN
    pblk.INT8_MIN_CIN = 16
    try:
        rec = ex.export(_yolox_exp(), output=str(tmp_path / "y.pt2"), raw=True,
                        int8=kind == "int8", device="cpu")
    finally:
        pblk.INT8_MIN_CIN = old
    want = {"tscd.focus_stem.default"} | ({"tscd.int8_absmax.default", "tscd.int8_conv.default",
                                           "tscd.int8_quantize.default"} if kind == "int8"
                                          else set())
    assert set(rec["ops"]) == want
    assert rec["equal"] and rec["output_shape"] == [1, 84, 5 + C]


def test_tscd_video_step_exports_and_equals_eager_over_two_windows(tmp_path):
    rec = ex.export(selftest_exp(), output=str(tmp_path / "v.pt2"), video=True, device="cpu")
    assert set(rec["ops"]) == {"tscd.focus_stem.default", "tscd.fused_dual_attention.default",
                               "tscd.linear_sum_assignment.default", "tscd.nms_sorted.default"}
    assert rec["equal"] and rec["max_abs_diff_windows"] == [0.0, 0.0]


def test_exported_yolox_matches_jax_export_and_holds_no_plain_version(tmp_path):
    """The port's exported raw YOLOX on a JAX YOLOX's weights against JAX's
    jax.export round trip; and its graph holds the stem's op, not
    focus_stem_plain's s2d and 3x3 conv: no convolution with 12 input
    channels (the plain version's), and exporting launched nothing."""
    from jax import export as jax_export
    jm = JYOLOX(num_classes=C, depth=0.33, width=0.25)
    x = np.random.default_rng(0).uniform(0, 255, (1, HW, HW, 3)).astype(np.float32)
    v = seeded_variables(jm, 3, jnp.asarray(x), False, True)
    pm = YOLOX(C, 0.33, 0.25, device="cpu")
    pm.load_state_dict(state_dict_from_flax(v, pm.state_dict()))
    blob = jax_export.export(jax.jit(lambda img: jm.apply(v, img, False, False)["outputs"]))(
        jax.ShapeDtypeStruct((1, HW, HW, 3), jnp.float32)).serialize()
    want = np.asarray(jax_export.deserialize(blob).call(x))
    path = str(tmp_path / "y.pt2")
    n0 = pfs.focus_stem.launches
    ep, _ = ex.export_program(ex.StillForward(pm, True), (T(x),), path)
    with torch.no_grad():
        got = torch.export.load(path).module()(T(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("tscd.focus_stem.default") == 1
    convs = [n for n in ep.graph.nodes
             if n.target in (torch.ops.aten.conv2d.default, torch.ops.aten.convolution.default)]
    assert convs and all(n.args[1].meta["val"].shape[1] != 12 for n in convs)
    assert pfs.focus_stem.launches == n0


# -- the deploy decode + NMS ---------------------------------------------------

def test_deploy_decode_nms_equals_jaxs_build():
    rng = np.random.default_rng(0)
    hw = [(8, 8), (4, 4), (2, 2)]
    A = sum(h * w for h, w in hw)
    raw = rng.normal(0, 1, (A, 5 + C)).astype(np.float32)
    raw[:, 4] -= 1.0
    got = native.yolox_decode_nms(raw, hw, (8, 16, 32), C, 0.1, 0.45, 100)
    lib = load_library("yolox_deploy")
    lib.yolox_decode_nms.restype = ctypes.c_int32
    out = np.zeros((100, 7), np.float32)
    n = lib.yolox_decode_nms(
        raw.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(A), ctypes.c_int64(C),
        np.asarray(hw, np.int32).ctypes.data_as(ctypes.c_void_p),
        np.asarray((8, 16, 32), np.int32).ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(3),
        ctypes.c_float(0.1), ctypes.c_float(0.45), ctypes.c_int32(100),
        out.ctypes.data_as(ctypes.c_void_p))
    assert n > 5 and got.shape == (n, 7)
    np.testing.assert_array_equal(got, out[:n])
    i = np.arange(32 * 48 * 3, dtype=np.uint64)
    np.testing.assert_array_equal(   # tests/test_pjrt_runner.py's synth_image
        native.synth_image(32, 48),
        ((i * np.uint64(2654435761)) % np.uint64(256)).astype(np.float32).reshape(1, 32, 48, 3))


# -- select_proposals ----------------------------------------------------------

def _decoded(seed, A=900, n_cls=8, span=200):
    rng = np.random.default_rng(seed)
    d = np.empty((A, 5 + n_cls), np.float32)
    d[:, :2] = rng.uniform(0, span, (A, 2))
    d[:, 2:4] = rng.uniform(4, 60, (A, 2))
    d[:, 4] = rng.choice(np.linspace(0.05, 0.95, 19), A)     # ties in objectness
    d[:, 5:] = rng.uniform(0, 1, (A, n_cls))
    d[:40, 5:] = 0.5                                          # ties in the best class
    return d


@pytest.mark.parametrize("nms_thre,top_k,pre_topk,span,n_cls", [
    (0.75, 30, 750, 200, 8), (0.3, 60, 300, 10, 2)])
def test_select_proposals_matches_jax(nms_thre, top_k, pre_topk, span, n_cls):
    """The second case crowds two classes' boxes, so that NMS leaves fewer
    than top_k: dead slots, -inf-scored and masked off, as JAX's."""
    ds = np.stack([_decoded(s, n_cls=n_cls, span=span) for s in (1, 2)])
    n_cls = ds.shape[-1] - 5
    got = ppost.select_proposals_batch(T(ds), n_cls, nms_thre, top_k, pre_topk)
    want = jpost.select_proposals_batch(jnp.asarray(ds), n_cls, nms_thre, top_k, pre_topk)
    for field in jpost.Proposals._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    one = ppost.select_proposals(T(ds[1]), n_cls, nms_thre, top_k, pre_topk)
    for a, b in zip(one, got):
        assert torch.equal(a, b[1])
    assert bool(got.mask.all()) == (span > 10)
