"""TSCD and the YOLOV family of the port on the other backbones
(`backbone_name`) against the JAX package on the CPU, on seeded JAX
variables (`torch_port_util.seeded_tree`) carried across by the port's
converter:

  - TSCD on Swin_Tiny (depth 0.33, width 0.25, P 8, heads 2, 1 + 2
    frames at 96 px: Swin's stage maps 24, 12, 6 and 3, the first two
    padded to 28 and 14, windows 7, 7, 6 and 3, JAX's tables of stages 2
    and 3 cut to 11^2 and 5^2 rows) over two windows with the matcher
    state carried: the refined and original detections; a JAX-saved
    .msgpack of it loads into the port through the eval CLI's
    `load_weights`, and the port's msgpack checkpoint saved for 96 px
    frames holds JAX's tree exactly;
  - YOLOV on Focal (focalnet_tscd, 0 + 4 frames at 64 px) over two
    windows: the raw outputs and the refined detections;
  - the exp knob and the CLI override `backbone_name ...` reach the
    models, and an unknown name raises ValueError.

Tolerances as tests/test_torch_port_tscd.py's: fp32 on both sides,
detections 1e-4 (boxes in pixels, scores in [0, 1]), compared per frame
as sets, since random weights leave ranks to rounding; masks and class
ids exact; raw outputs 1e-4 of the largest.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.models.matching import init_matcher_state as jinit
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.models.tscd import tscd_eval_postprocess as jpost
from tscd_tpu.models.yolov import YOLOV as JYOLOV
from tscd_tpu.models.yolov import yolov_eval_postprocess as jypost
from tscd_tpu.train.checkpoint import load_checkpoint as jload_checkpoint
from tscd_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from tscd_torch.models.pafpn_variants import (YOLOPAFPN_Focal, YOLOPAFPN_Swin,
                                              build_pafpn_backbone)
from tscd_torch.models.tscd import TSCD, tscd_eval_postprocess
from tscd_torch.models.yolov import YOLOV, yolov_eval_postprocess
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.utils.convert import flatten_tree, flax_from_state_dict, state_dict_from_flax
from torch_port_util import seeded_like, seeded_tree

C, DEPTH, WIDTH, P, HEADS = 5, 0.33, 0.25, 8, 2
L, G, SIZE = 1, 2, 96
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(n, frames, size, seed):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, (frames, size, size, 3)).astype(np.float32),
             get_timing_signal_1d(np.arange(w, w + frames))) for w in range(n)]


def _rows(d, f):
    """Frame f's kept detections as [x1, y1, x2, y2, obj, score, cls] rows."""
    m = np.asarray(d.mask[f])
    cols = [np.asarray(d.boxes[f])[m]] + [np.asarray(getattr(d, k)[f])[m][:, None]
                                          for k in ("obj", "score", "cls_id")]
    return np.concatenate([c.astype(np.float32) for c in cols], 1)


def _same_detections(pd, jd, msg):
    """Masks exact; per frame the same rows as a set, class ids exact and
    values within TOL."""
    assert np.array_equal(pd.mask.numpy(), np.asarray(jd.mask)), msg
    n = 0
    for f in range(pd.mask.shape[0]):
        got, want = _rows(pd, f), _rows(jd, f)
        free = list(range(len(got)))
        for row in want:
            hit = next((i for i in free if got[i, 6] == row[6] and np.allclose(
                got[i, :6], row[:6], atol=TOL, rtol=TOL)), None)
            assert hit is not None, f"{msg}: no port detection matches {row}"
            free.remove(hit)
        n += len(want)
    return n


def _load(pm, variables):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # Swin's tables of shrunk windows at 96 px
        sd = state_dict_from_flax(variables, pm.state_dict())
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    return pm


# -- TSCD on Swin_Tiny ---------------------------------------------------------

def _port_tscd():
    return TSCD(num_classes=C, depth=DEPTH, width=WIDTH, num_proposals=P, heads=HEADS,
                backbone_name="Swin_Tiny", device="cpu")


@pytest.fixture(scope="module")
def tscd_swin():
    jm = JTSCD(num_classes=C, depth=DEPTH, width=WIDTH, num_proposals=P, heads=HEADS,
               backbone_name="Swin_Tiny")
    windows = _windows(2, L + G, SIZE, 31)
    x, te = windows[0]
    variables = seeded_tree(jm, 32, jnp.asarray(x), jnp.asarray(te), L, G)

    @jax.jit
    def step(v, x, te, st):
        out = jm.apply(v, x, te, L, G, False, st)
        refined, original = jpost(out, L, C)
        return refined, original, out["matcher_state"]

    return variables, step, windows


def test_tscd_swin_tiny_matches_jax_over_two_windows(tscd_swin):
    variables, step, windows = tscd_swin
    port = _load(_port_tscd(), variables)
    assert isinstance(port.backbone, YOLOPAFPN_Swin)
    assert port.head.stems[0].conv.in_channels == int(192 * WIDTH)
    hidden = int(256 * WIDTH)
    js, ps, n = jinit(P, hidden, 4 * hidden), None, 0
    for w, (x, te) in enumerate(windows):
        jr, jo, js = step(variables, jnp.asarray(x), jnp.asarray(te), js)
        with torch.no_grad():
            out = port(torch.from_numpy(x), torch.from_numpy(te), L, G, matcher_state=ps)
        pr, po = tscd_eval_postprocess(out, L, C)
        ps = out["matcher_state"]
        assert bool(ps.has_state)
        for name, jd, pd in (("refined", jr, pr), ("original", jo, po)):
            n += _same_detections(pd, jd, f"window {w} {name}")
    assert n > 0


def test_tscd_swin_msgpack_round_trip(tscd_swin, tmp_path):
    """A JAX-saved .msgpack loads into the port (the eval CLI's
    load_weights) as the converter carries the variables; the port's
    msgpack checkpoint holds JAX's tree exactly, as JAX reads it."""
    from tscd_torch.tools.tscd_eval import load_weights
    from tscd_torch.train.checkpoint import save_checkpoint
    variables, _, _ = tscd_swin
    path = jsave_checkpoint({"params": variables["params"],
                             "batch_stats": variables["batch_stats"]}, str(tmp_path), name="jax")
    port = _port_tscd()
    with pytest.warns(UserWarning, match="keep the model's own"):
        load_weights(port, path)
    want = state_dict_from_flax(variables, port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(v, want[k]), k
    back = jload_checkpoint(save_checkpoint({"model": port.state_dict(), "start_epoch": 2},
                                            str(tmp_path), name="port.msgpack",
                                            frame_size=(SIZE, SIZE)))
    assert int(back["start_epoch"]) == 2
    for coll in ("params", "batch_stats"):
        a, b = flatten_tree(back[coll]), flatten_tree(variables[coll])
        assert a.keys() == b.keys(), coll
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_tscd_swin_parameter_groups_equal_jax(tscd_swin):
    """The stage-2 recipe's SGD groups over a Swin TSCD (the whole pyramid,
    network and neck, frozen; the head's stem-LR groups; LayerNorm scales
    and biases undecayed) equal `_label_params` over JAX's tree."""
    from tscd_torch.exp.tscd_base import TSCDExp
    from tscd_torch.train.optim import label_params
    from tscd_torch.utils.convert import backbone_layout, flax_param_path
    from tscd_tpu.train.optim import _label_params
    variables, _, _ = tscd_swin
    exp = TSCDExp()
    named = list(_port_tscd().named_parameters())
    bb = backbone_layout(n for n, _ in named)
    got = {"/".join(flax_param_path(n, p.dim(), None, bb)): lab
           for n, lab in label_params(named, exp.freeze_prefixes(), exp.stem_lr_prefixes()).items()
           for p in [dict(named)[n]]}
    want = {"/".join(k): v for k, v in flatten_tree(_label_params(
        variables["params"], exp.freeze_prefixes(), exp.stem_lr_prefixes())).items()}
    assert got == want
    assert {v for k, v in want.items() if k.startswith("backbone/")} == {"frozen"}


def test_fuse_model_folds_the_neck_and_head_and_keeps_layernorms():
    """At bf16, `fuse_model` folds every BatchNorm of the neck and head of a
    Swin TSCD from the fp32 weights; Swin's LayerNorms and relative-position
    tables keep fp32 parameters, its Linear layers are bf16."""
    from tscd_torch.models.blocks import BaseConv
    from tscd_torch.utils.model_utils import fuse_model
    kw = dict(num_classes=C, depth=DEPTH, width=WIDTH, num_proposals=P, heads=HEADS,
              backbone_name="Swin_Tiny", device="cpu")
    sd32 = TSCD(**kw).state_dict()
    model = fuse_model(TSCD(dtype=torch.bfloat16, **kw), sd32)
    assert all(m.bn is None for m in model.modules() if isinstance(m, BaseConv))
    net = model.backbone.backbone
    for name, m in net.named_modules():
        if isinstance(m, (torch.nn.LayerNorm, torch.nn.Linear, torch.nn.Conv2d)):
            want = torch.float32 if isinstance(m, torch.nn.LayerNorm) else torch.bfloat16
            assert {p.dtype for p in m.parameters()} == {want}, name
    assert net.layers[0].blocks[0].attn.relative_position_bias_table.dtype == torch.float32
    assert torch.equal(net.norm3.weight, sd32["backbone.backbone.norm3.weight"])


# -- YOLOV on Focal --------------------------------------------------------------

def test_yolov_focal_matches_jax_over_two_windows():
    """Its variables' tree is the port's carried to flax (the trees are
    held to JAX's in tests/test_torch_port_backbones.py and the YOLOV
    files); JAX's apply reads each leaf at its shape."""
    F = 4
    jm = JYOLOV(num_classes=C, depth=DEPTH, width=WIDTH, num_proposals=P, heads=HEADS,
                backbone_name="Focal")
    windows = _windows(2, F, 64, 41)
    port = YOLOV(num_classes=C, depth=DEPTH, width=WIDTH, num_proposals=P, heads=HEADS,
                 backbone_name="Focal", device="cpu")
    variables = seeded_like(flax_from_state_dict(port.state_dict()), 42)

    @jax.jit
    def step(v, x):
        out = jm.apply(v, x, 0, F)
        return out["raw_outputs"], jypost(out, F, C)[0]

    port = _load(port, variables)
    assert isinstance(port.backbone, YOLOPAFPN_Focal)
    n = 0
    for w, (x, _) in enumerate(windows):
        jraw, jref = step(variables, jnp.asarray(x))
        with torch.no_grad():
            out = port(torch.from_numpy(x), 0, F)
        raw = np.asarray(jraw)
        err = float(np.abs(out["raw_outputs"].numpy() - raw).max())
        assert err <= TOL * float(np.abs(raw).max()), f"window {w} raw outputs: {err}"
        ref, _ = yolov_eval_postprocess(out, F, C)
        n += _same_detections(ref, jref, f"window {w} refined")
    assert n > 0


# -- the exp knob, the CLI override, unknown names ------------------------------

EXP_FILE = """
from tscd_torch.exp.tscd_base import TSCDExp


class Exp(TSCDExp):
    def __init__(self):
        super().__init__()
        self.backbone_name = "Swin_Tiny"
        self.depth, self.width = 0.33, 0.25
        self.minimal_limit = 8
        self.heads = 2
"""


def test_exp_knob_and_cli_override_reach_the_model(tmp_path):
    from tscd_torch.exp import get_exp
    from tscd_torch.tools import tscd_demo, tscd_eval, tscd_train, vid_eval
    exp_file = tmp_path / "swin_exp.py"
    exp_file.write_text(EXP_FILE)
    model = get_exp(str(exp_file)).get_model(device="cpu")
    assert isinstance(model.backbone, YOLOPAFPN_Swin)
    assert model.backbone.out_channels == (192, 384, 768)
    # every CLI's trailing `key value` pairs go through exp.merge
    parsers = {"tscd_eval": (tscd_eval.make_parser(), ["-c", "w.pth"]),
               "vid_eval": (vid_eval.make_parser(), ["-c", "w.pth"]),
               "tscd_train": (tscd_train.make_parser(), []),
               "tscd_demo": (tscd_demo.make_parser(), ["-c", "w.pth", "--path", "d"])}
    for name, (parser, flags) in parsers.items():
        args = parser.parse_args(["-f", str(exp_file), *flags, "backbone_name", "Swin_Base"])
        exp = get_exp(args.exp_file, args.exp).merge(args.opts)
        assert exp.backbone_name == "Swin_Base", name
    model = exp.get_model(device="cpu")
    assert isinstance(model.backbone, YOLOPAFPN_Swin)
    assert model.backbone.out_channels == (256, 512, 1024)
    assert model.backbone.backbone.patch_embed.proj.out_channels == 128
    yexp = get_exp(None, "yolov_selftest").merge(["backbone_name", "Focal"])
    assert isinstance(yexp.get_model(device="cpu").backbone, YOLOPAFPN_Focal)


def test_unknown_backbone_name_raises():
    with pytest.raises(ValueError, match="ViT"):
        build_pafpn_backbone("ViT", 0.33, 0.25)
