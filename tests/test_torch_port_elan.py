"""The YOLOv7 ELAN family of the port (`models.elan`) against the JAX
package on the CPU.

JAX's variables come from the module's shapes (`jax.eval_shape` of its
init, no init compile) with seeded values (`torch_port_util.
seeded_variables`: BN statistics off identity, so that folding and eps
show); the port's converter (`utils.convert.state_dict_from_flax`)
carries them into the port, whose names are the reference's: JAX's own
reader of reference ELAN checkpoints (`tscd_tpu.utils.convert.
backbone_to_flax("elan-<arch>")`) maps the port's state_dict onto the
same tree. JAX's side is jitted.

Tolerances: fp32 both sides, another summation order: each output within
1e-4 of its largest absolute value (TOL); train mode's new running
statistics likewise, JAX's batch statistics summed in a tree
(`torch_port_util.pairwise_batch_stats`) as in the port's other
train-mode comparisons. bf16 (as tests/test_torch_port_backbones.py
holds whole bf16 networks): the bf16 port's mean distance from the bf16
JAX model within BF16_SPREAD x JAX's own bf16-to-fp32 mean distance.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.models import elan as jel
from tscd_tpu.utils.convert import backbone_to_flax as jax_backbone_to_flax
from tscd_torch.models import elan as pel
from tscd_torch.models.build import create_model
from tscd_torch.utils.convert import (backbone_to_flax, elan_layout, flatten_tree,
                                     flax_from_state_dict, state_dict_from_flax)
from torch_port_util import assert_close, pairwise_batch_stats, seeded_like, seeded_variables

TOL = 1e-4
BF16_SPREAD = 2.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames(seed, n, size):
    return np.random.default_rng(seed).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def carried(make, variables):
    """The port module `make()` built on the meta device (no init: the
    weights are JAX's), in eval mode with JAX's `variables`."""
    with torch.device("meta"):
        pm = make()
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()), assign=True)
    return pm.eval()


def neck_of(arch, dtype=jnp.float32):
    """JAX's neck of `arch` over its backbone's maps, and the port's."""
    if arch in pel.P6_ARCHS:
        ch = pel.backbone_channels(arch)[-4:]
        return jel.ELANFPNP6(arch, ch, dtype=dtype), pel.ELANFPNP6(arch, ch)
    ch = pel.backbone_channels(arch)[-3:]
    return jel.ELANFPN(arch, ch, dtype=dtype), pel.ELANFPN(arch, ch)


def return_idx(arch):
    return (2, 3, 4, 5) if arch in pel.P6_ARCHS else (2, 3, 4)


SIZE = 64


@functools.lru_cache(maxsize=None)
def jax_trees(arch):
    """JAX's ELANNet and neck of `arch` and their variables' shapes
    (jax.eval_shape of each init on a 64 px frame), shared by the tests
    of the arch."""
    x = jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.float32)
    jb = jel.ELANNet(arch, return_idx(arch))
    jn, _ = neck_of(arch)
    chs = pel.backbone_channels(arch)[-len(return_idx(arch)):]
    feats = tuple(jax.ShapeDtypeStruct((1, SIZE // 2 ** i, SIZE // 2 ** i, c), jnp.float32)
                  for i, c in zip(return_idx(arch), chs))
    init = lambda m: lambda *a: m.init(jax.random.PRNGKey(0), *a, False)  # noqa: E731
    return jb, jn, jax.eval_shape(init(jb), x), jax.eval_shape(init(jn), feats)


# tiny: EConv stems, max-pool stages, SPPELAN, EConv outputs; L: MPConv,
# SPPCSPC, RepConv outputs; W6: the Focus stem, EConv downsamples and
# ELANFPNP6; E6E: DownC and ELAN2Layer in the backbone and the P6 neck
@pytest.mark.parametrize("arch", ["tiny", "L", "W6", "E6E"])
def test_elannet_and_neck_match_jax(arch):
    x = frames(1, 1, SIZE)
    jb, jn, sb, sn = jax_trees(arch)
    vb, vn = seeded_like(sb, 2), seeded_like(sn, 3)
    want_maps, want_neck = jax.jit(lambda v, w, a: (lambda m: (m, jn.apply(w, m, False)))(
        jb.apply(v, a, False)))(vb, vn, jnp.asarray(x))
    pb = carried(lambda: pel.ELANNet(arch, return_idx(arch)), vb)
    pn = carried(lambda: neck_of(arch)[1], vn)
    with torch.no_grad():
        maps = pb(torch.from_numpy(x))
        neck = pn([torch.from_numpy(np.array(m)).permute(0, 3, 1, 2) for m in want_maps])
    assert len(maps) == len(want_maps) and len(neck) == len(want_neck)
    for pm, variables in ((pb, vb), (pn, vn)):     # and back to JAX's tree, exactly
        back = flax_from_state_dict(pm.state_dict())
        for coll in ("params", "batch_stats"):
            got, want = flatten_tree(back[coll]), flatten_tree(variables[coll])
            assert got.keys() == want.keys()
            assert all(np.array_equal(got[k], want[k]) for k in want)
    for k, (g, w) in enumerate(zip(maps, want_maps)):
        assert_close(nhwc(g), w, f"{arch} backbone map {k}")
    for k, (g, w) in enumerate(zip(neck, want_neck)):
        assert_close(nhwc(g), w, f"{arch} neck map {k}")


def shape_tree(tree):
    return {c: {k: tuple(np.shape(v)) for k, v in flatten_tree(tree.get(c, {})).items()}
            for c in ("params", "batch_stats")}


@pytest.mark.parametrize("arch", pel.ARCHS)
def test_elan_names_are_the_references(arch):
    """For every arch, the port's ELANNet and neck names (built on the meta
    device; each tensor a zero-stride array of its shape) are what JAX's
    reader of reference ELAN checkpoints (`backbone_to_flax("elan-<arch>")`)
    takes to exactly JAX's tree (`jax_trees`, from jax.eval_shape: no
    forward), and the port's own reader maps them onto the same tree."""
    _, _, sb, sn = jax_trees(arch)
    with torch.device("meta"):
        pms = (pel.ELANNet(arch, return_idx(arch)), neck_of(arch)[1])
    for pm, want in zip(pms, (sb, sn)):
        sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in pm.state_dict().items()}
        assert shape_tree(jax_backbone_to_flax(sd, f"elan-{arch}")) == shape_tree(want)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)     # the arrays are read-only
            assert shape_tree(backbone_to_flax(sd, f"elan-{arch}")) == shape_tree(want)


def test_elan_layout_finds_the_network_and_neck():
    names = create_model("yolov7", num_classes=3, arch="tiny", device="cpu").state_dict()
    assert elan_layout(names) == (("backbone.", "fpn."), True)
    with torch.device("meta"):
        names = pel.ELANNet("E6E").state_dict()
    assert elan_layout(names) == (("",), False)
    assert "stem.conv.conv.weight" in names and "blocks.0.1.elan_layer2.conv3.bn.bias" in names


# -- YOLOv7 ----------------------------------------------------------------
@pytest.fixture(scope="module")
def yolov7_tiny():
    """JAX's YOLOv7-tiny (5 classes), its seeded variables, the port's
    model carrying them, the frames (2 at 64 px) and JAX's eval outputs."""
    x = frames(4, 2, 64)
    jm = jel.YOLOv7(num_classes=5, arch="tiny")
    variables = seeded_variables(jm, 5, jnp.asarray(x), False)
    pm = pel.YOLOv7(5, "tiny", device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    return jm, variables, pm, x, jax.jit(lambda v, a: jm.apply(v, a, False))(variables,
                                                                            jnp.asarray(x))


def test_yolov7_tiny_decoded_matches_jax(yolov7_tiny):
    jm, variables, pm, x, want = yolov7_tiny
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got["hw"] == [tuple(h) for h in want["hw"]]
    assert_close(got["outputs"].numpy(), want["outputs"], "raw outputs")
    assert_close(got["decoded"].numpy(), want["decoded"], "decoded")


def test_yolov7_tiny_train_mode_matches_jax(yolov7_tiny):
    """BN on the batch's statistics: the decoded outputs and the new
    running statistics (EConv's momentum 0.97) against JAX's mutable
    batch_stats."""
    jm, variables, pm, x, _ = yolov7_tiny
    with pairwise_batch_stats():
        want, mut = jax.jit(lambda v, a: jm.apply(v, a, True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), train=True)
    assert_close(got["decoded"].numpy(), want["decoded"], "train-mode decoded")
    new = state_dict_from_flax({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                               pm.state_dict())
    stats = got["batch_stats"]
    assert set(stats) == {k for k in new if k.endswith(("running_mean", "running_var"))}
    for k, v in stats.items():
        assert_close(v.numpy(), new[k].numpy(), k)
    assert torch.equal(pm.state_dict()["backbone.stem.0.bn.running_var"],
                       torch.from_numpy(np.asarray(variables["batch_stats"]["backbone"]["stem_0"]
                                                   ["bn"]["var"])))


def test_yolov7_tiny_bf16_matches_jax(yolov7_tiny):
    """The bf16 port against JAX's bf16 model on the same weights (raw
    outputs): mean |port - JAX bf16| within BF16_SPREAD x JAX's own mean
    |bf16 - fp32|, as tests/test_torch_port_backbones.py holds whole bf16
    networks. The max-abs rule of tests/test_torch_port_bf16.py is noise
    here: JAX's own jitted and eager bf16 runs differ by more (0.078 at
    a scale of 4.7, against 0.058 from fp32; the port: 0.086 from the
    jitted, 0.063 from the eager)."""
    _, variables, _, x, want32 = yolov7_tiny
    j16 = jel.YOLOv7(num_classes=5, arch="tiny", dtype=jnp.bfloat16)
    want16 = jax.jit(lambda v, a: j16.apply(v, a, False))(variables, jnp.asarray(x))["outputs"]
    p16 = pel.YOLOv7(5, "tiny", dtype=torch.bfloat16, device="cpu")
    p16.load_state_dict(state_dict_from_flax(variables, p16.state_dict()))
    with torch.no_grad():
        got = p16(torch.from_numpy(x))["outputs"]
    assert got.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    w16, w32 = np.asarray(want16, np.float32), np.asarray(want32["outputs"])
    spread = float(np.abs(w16 - w32).mean())
    gap = float(np.abs(got.float().numpy() - w16).mean())
    assert 0 < gap <= BF16_SPREAD * spread, (gap, spread)


def test_implicit_priors_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    for jcls, pcls, leaf in ((jel.ImplicitA, pel.ImplicitA, "ia"), (jel.ImplicitM, pel.ImplicitM,
                                                                   "im")):
        value = rng.normal(size=(1, 1, 1, 8)).astype(np.float32)
        want = jcls(8).apply({"params": {leaf: value}}, jnp.asarray(x))
        pm = pcls(8)
        pm.load_state_dict(state_dict_from_flax({"params": {leaf: value}}, pm.state_dict()))
        with torch.no_grad():
            got = nhwc(pm(torch.from_numpy(x).permute(0, 3, 1, 2)))
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_create_model_builds_yolov7_and_yolov8():
    from tscd_torch.models.yolov8 import YOLOv8
    v7 = create_model("yolov7", num_classes=5, arch="tiny", device="cpu")
    v8 = create_model("yolov8", num_classes=5, depth=0.33, width=0.25, device="cpu")
    assert isinstance(v7, pel.YOLOv7) and isinstance(v8, YOLOv8)
    assert v7.device.type == v8.device.type == "cpu"
    x = torch.from_numpy(frames(7, 1, 64))
    with torch.no_grad():
        assert v7(x)["decoded"].shape == (1, 8 * 8 + 4 * 4 + 2 * 2, 10)
        assert v8(x)["decoded"].shape == (1, 8 * 8 + 4 * 4 + 2 * 2, 9)
    with pytest.raises(ValueError, match="P5 arch"):
        create_model("yolov7", arch="W6", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_model("yolov8")
