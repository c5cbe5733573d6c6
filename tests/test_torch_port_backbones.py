"""The other backbones of the port (`models.swin`, `focalnet`, `resnet`,
`darknet.Darknet`, `pafpn_variants`, `pafpn_p6`) against the JAX package
on the CPU.

JAX's variables come from the module's shapes (`jax.eval_shape` of its
init) with seeded values (`torch_port_util.seeded_tree`: BN statistics
off identity, layerscale gammas near 1, relative-position tables of unit
scale, so that folding, the residual branches and a wrong offset show). The
port's converter (`utils.convert.state_dict_from_flax`) carries them
into the port, whose parameter names are the reference's: JAX's own
reader of reference checkpoints (`tscd_tpu.utils.convert.
backbone_to_flax`) maps the port's state_dict onto the same tree.

Tolerance: both sides fp32, another summation order; each output map
within 1e-4 of its largest absolute value (TOL); the gradients of a
scalar loss within 1e-4 of each gradient's largest value.
"""

import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from tscd_tpu.models import focalnet as jfocal
from tscd_tpu.models import pafpn_p6 as jp6
from tscd_tpu.models import pafpn_variants as jvar
from tscd_tpu.models import resnet as jres
from tscd_tpu.models import swin as jswin
from tscd_tpu.utils.convert import backbone_to_flax as jax_backbone_to_flax
from tscd_torch.models import darknet, focalnet, pafpn_p6, pafpn_variants, resnet, swin
from tscd_torch.utils.convert import (backbone_to_flax, flatten_tree, flax_from_state_dict,
                                     state_dict_from_flax)
from torch_port_util import seeded_tree

TOL = 1e-4
SWIN_SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames(seed, n, h, w=None):
    return np.random.default_rng(seed).uniform(0, 255, (n, h, w or h, 3)).astype(np.float32)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_maps_close(got, want, what):
    """Each map within TOL of its largest absolute value."""
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, f"{what} map {k}: {g.shape} != {w.shape}"
        err = float(np.abs(g - w).max())
        assert err <= TOL * float(np.abs(w).max()), f"{what} map {k}: {err}"


def carried(jm, pm, variables, frame_size=None):
    """The port module `pm` in eval mode with JAX's `variables`, and its
    state_dict carried back to flax (for JAX's tree built at `frame_size`),
    which lands on JAX's tree exactly."""
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    back = flax_from_state_dict(pm.state_dict(), frame_size)
    for coll in ("params", "batch_stats"):
        a = {k: np.asarray(v) for k, v in flatten_tree(back[coll]).items()}
        b = {k: np.asarray(v) for k, v in flatten_tree(variables.get(coll, {})).items()}
        assert a.keys() == b.keys(), coll
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    return pm.eval()


def net_maps(out):
    return [out[k] for k in ("dark3", "dark4", "dark5")]


# -- Swin ------------------------------------------------------------------
# window 4 on 128 px: stage maps 32, 16, 8, 4, every window exact and
# every odd block shifted with the mask; window 7 on 96 px: maps 24, 12,
# 6, 3, padded to 28 and 14 (shifted), then ws = 6 and 3, shift off and
# JAX's tables of 11^2 and 5^2 rows in the port's 13^2 tables
SWIN_CASES = {"exact_window_shifted": (4, 128), "padded_shrunk_window": (7, 96)}


@pytest.fixture(scope="module", params=sorted(SWIN_CASES))
def swin_case(request):
    """JAX's small Swin, its seeded variables, the port's Swin carrying
    them, the frames and JAX's fp32 maps."""
    ws, size = SWIN_CASES[request.param]
    jm = jswin.SwinTransformer(window_size=ws, **SWIN_SMALL)
    x = frames(1, 2, size)
    variables = seeded_tree(jm, 2, jnp.asarray(x))
    shrunk = request.param == "padded_shrunk_window"
    with pytest.warns(UserWarning, match="keep the model's own") if shrunk \
            else contextlib.nullcontext():
        pm = carried(jm, swin.SwinTransformer(window_size=ws, **SWIN_SMALL), variables,
                     (size, size))
    return jm, pm, variables, x, net_maps(jax.jit(jm.apply)(variables, jnp.asarray(x)))


def test_swin_matches_jax(swin_case):
    jm, pm, variables, x, want = swin_case
    with torch.no_grad():
        got = [nhwc(t) for t in net_maps(pm(torch.from_numpy(x)))]
    assert_maps_close(got, want, "swin")


def test_swin_checkpoint_is_jax_layout_at_its_frame_size(swin_case, tmp_path):
    """The port's msgpack checkpoint of the small Swin, saved with the
    frames' size, is the tree JAX builds at that size: at 96 px (window
    7) JAX's tables of stages 2 and 3 have 11^2 and 5^2 rows, cut from
    the port's 13^2 (at 128 px with window 4 every table is whole), and
    JAX's checkpoint reader returns JAX's own variables exactly."""
    from tscd_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
    from tscd_torch.train.checkpoint import save_checkpoint
    jm, pm, variables, x, _ = swin_case
    path = save_checkpoint({"model": pm.state_dict()}, str(tmp_path), name="swin.msgpack",
                           frame_size=x.shape[1:3])
    got = flatten_tree(jax_load_checkpoint(path)["params"])
    want = flatten_tree(variables["params"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=str(k))
    tables = {k[0]: v.shape[0] for k, v in want.items() if k[-1] == "relative_position_bias_table"}
    assert tables["layer3_block0"] == (25 if x.shape[1] == 96 else 49)


def test_swin_names_are_the_references(swin_case):
    """JAX's reader of reference Swin checkpoints takes the port's
    state_dict to JAX's tree: the port's names are the reference's. With
    the index buffers a reference file holds, the port's converter drops
    them; JAX's keeps each as an `attn` param (its test for the name looks
    among the module's parts, where the buffer is the leaf), which flax
    then leaves unread."""
    jm, pm, variables, x, _ = swin_case
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    for i, layer in enumerate(pm.layers):
        for b, blk in enumerate(layer.blocks):
            sd[f"layers.{i}.blocks.{b}.attn.relative_position_index"] = \
                swin.relative_position_index(blk.attn.window_size)
    ref = {k: v for k, v in flatten_tree(jax_backbone_to_flax(sd, "swin")["params"]).items()
           if k[-1] != "relative_position_index"}
    ours = flatten_tree(backbone_to_flax(sd, "swin")["params"])
    a, b = ref, ours
    assert a.keys() == b.keys() == flatten_tree(flax_from_state_dict(pm.state_dict())["params"]).keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=str(k))


def test_swin_static_tensors_are_built_once():
    """The mask and the index come from the cache on a second forward,
    the same tensor objects, as a captured CUDA graph needs."""
    pm = swin.SwinTransformer(window_size=4, **SWIN_SMALL).eval()
    x = torch.from_numpy(frames(3, 1, 64))
    with torch.no_grad():
        pm(x)
        before = {k: id(v) for k, v in swin._STATIC.items()}
        pm(x)
    assert {k: id(v) for k, v in swin._STATIC.items()} == before
    assert any(k[0] == "shift_mask" for k in before) and any(k[0] == "rel_index" for k in before)


def test_swin_gradients_match_jax():
    """d loss / d every parameter through the small Swin (window 4, 128
    px: maps 32, 16, 8, 4), loss a fixed seeded weighting of the three
    maps, against jax.grad."""
    jm = jswin.SwinTransformer(window_size=4, **SWIN_SMALL)
    x = frames(4, 1, 128)
    variables = seeded_tree(jm, 5, jnp.asarray(x))
    pm = carried(jm, swin.SwinTransformer(window_size=4, **SWIN_SMALL), variables)
    rng = np.random.default_rng(6)
    shapes = [m.shape for m in net_maps(jax.eval_shape(jm.apply, variables, jnp.asarray(x)))]
    ws = [rng.normal(size=s).astype(np.float32) for s in shapes]

    def jloss(params):
        maps = net_maps(jm.apply({"params": params}, jnp.asarray(x)))
        return sum(jnp.sum(m * w) for m, w in zip(maps, ws))

    jg = jax.jit(jax.grad(jloss))(variables["params"])
    loss = sum((nhwc_t(m) * torch.from_numpy(w)).sum()
               for m, w in zip(net_maps(pm(torch.from_numpy(x))), ws))
    loss.backward()
    want = state_dict_from_flax({"params": jg}, {n: p for n, p in pm.named_parameters()})
    for n, p in pm.named_parameters():
        w = want[n].numpy()
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= TOL * float(np.abs(w).max()), f"{n}: {err}"


def nhwc_t(t):
    return t.permute(0, 2, 3, 1)


# -- FocalNet --------------------------------------------------------------
# focalnet_tscd's flags (conv-embed stem k7 s4 and k3 s2 downsamples,
# post-LN, layerscale, 4 focal levels of windows 3: kernels 3, 5, 7, 9)
# at embed 16 on 64 px (maps 16, 8, 4, 2)
FOCAL_SMALL = dict(embed_dim=16, depths=(2, 1, 2, 1))


@pytest.fixture(scope="module")
def focal_case():
    jm = jfocal.build_focalnet("focalnet_tscd", **FOCAL_SMALL)
    x = frames(7, 2, 64)
    variables = seeded_tree(jm, 8, jnp.asarray(x))
    return jm, variables, x, net_maps(jax.jit(jm.apply)(variables, jnp.asarray(x)))


def test_focalnet_tscd_flags_match_jax(focal_case):
    jm, variables, x, want = focal_case
    pm = carried(jm, focalnet.build_focalnet("focalnet_tscd", **FOCAL_SMALL), variables)
    with torch.no_grad():
        got = [nhwc(t) for t in net_maps(pm(torch.from_numpy(x)))]
    assert_maps_close(got, want, "focalnet")
    ref = flatten_tree(jax_backbone_to_flax({k: v.numpy() for k, v in pm.state_dict().items()},
                                            "focalnet")["params"])
    assert ref.keys() == flatten_tree(variables["params"]).keys()


# -- ResNet ----------------------------------------------------------------
def test_resnet50_matches_jax():
    jm = jres.ResNet(50)
    x = frames(9, 2, 64)
    variables = seeded_tree(jm, 10, jnp.asarray(x))
    pm = carried(jm, resnet.ResNet(50), variables)
    want = net_maps(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = [nhwc(t) for t in net_maps(pm(torch.from_numpy(x)))]
    assert_maps_close(got, want, "resnet50")
    ref = jax_backbone_to_flax({k: v.numpy() for k, v in pm.state_dict().items()}, "resnet")
    for coll in ("params", "batch_stats"):
        assert flatten_tree(ref[coll]).keys() == flatten_tree(variables[coll]).keys()


# -- Darknet-53 + YOLOFPN, the P6 PAFPN ------------------------------------
def test_darknet53_yolofpn_matches_jax():
    jm = jvar.YOLOFPN(53)
    x = frames(11, 1, 64)
    variables = seeded_tree(jm, 12, jnp.asarray(x))
    pm = carried(jm, pafpn_variants.YOLOFPN(53), variables)
    assert isinstance(pm.backbone, darknet.Darknet)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = [nhwc(t) for t in pm(torch.from_numpy(x))]
    assert_maps_close(got, want, "yolofpn")


def test_pafpn_p6_matches_jax():
    jm = jp6.YOLOPAFPNP6(0.33, 0.125)
    x = frames(13, 2, 128)
    variables = seeded_tree(jm, 14, jnp.asarray(x))
    pm = carried(jm, pafpn_p6.YOLOPAFPNP6(0.33, 0.125), variables)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = [nhwc(t) for t in pm(torch.from_numpy(x))]
    assert [g.shape[1] for g in got] == [128 // s for s in (8, 16, 32, 64)]
    assert_maps_close(got, want, "p6")


# -- the neck over Swin, in the reference layout ---------------------------
class _JaxSwinPAFPN(jvar._BackbonePAFPN):
    """JAX's wrapper over the small Swin (window 4)."""

    def make_backbone(self):
        return jswin.SwinTransformer(window_size=4, dtype=self.dtype, name="backbone",
                                     **SWIN_SMALL)


def test_neck_over_swin_matches_jax():
    """`_BackbonePAFPN` (network under `backbone`, the neck's convs on the
    wrapper: `backbone.layers...`, `lateral_conv0...`) over the small Swin
    at depth 0.33 (CSP depth max(round(1), 1)), width 0.5, out (128, 256,
    512) x width, against JAX's wrapper (`backbone`, `neck`)."""
    kw = dict(depth=0.33, width=0.5, out_channels=(128, 256, 512))
    jm = _JaxSwinPAFPN(**kw)
    x = frames(15, 2, 128)
    variables = seeded_tree(jm, 16, jnp.asarray(x))
    net = swin.SwinTransformer(window_size=4, **SWIN_SMALL)
    pm = carried(jm, pafpn_variants._BackbonePAFPN(net, **kw), variables)
    names = pm.state_dict()
    assert "lateral_conv0.conv.weight" in names and "C3_n4.m.0.conv2.bn.running_var" in names
    assert "backbone.layers.1.blocks.1.attn.relative_position_bias_table" in names
    assert not any(k.startswith("neck.") for k in names)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = [nhwc(t) for t in pm(torch.from_numpy(x))]
    assert [g.shape[-1] for g in got] == [64, 128, 256]
    assert_maps_close(got, want, "swin pafpn")


def test_convert_swin_weights_tool_matches_jax(tmp_path):
    """tscd_torch.tools.convert_swin_weights on an official-style Swin
    checkpoint (the small Swin's weights, its index buffers and masks, the
    classifier's `norm` and `head`) writes the tree JAX's
    tools/convert_swin_weights.py makes, less the index buffers JAX's keeps
    (test_swin_names_are_the_references), and JAX's checkpoint reader
    reads it."""
    import importlib.util
    import os

    from tscd_tpu.train.checkpoint import load_checkpoint
    from tscd_torch.tools import convert_swin_weights
    net = swin.SwinTransformer(window_size=7, **SWIN_SMALL)
    sd = dict(net.state_dict())
    for i, layer in enumerate(net.layers):
        for b, blk in enumerate(layer.blocks):
            sd[f"layers.{i}.blocks.{b}.attn.relative_position_index"] = torch.from_numpy(
                swin.relative_position_index(7))
            if b % 2:
                sd[f"layers.{i}.blocks.{b}.attn_mask"] = torch.zeros(4, 49, 49)
    sd.update({"norm.weight": torch.ones(256), "norm.bias": torch.zeros(256),
               "head.weight": torch.zeros(1000, 256), "head.bias": torch.zeros(1000)})
    src, dst = str(tmp_path / "swin.pth"), str(tmp_path / "swin.msgpack")
    torch.save({"model": sd}, src)
    convert_swin_weights.main([src, dst])
    got = flatten_tree(load_checkpoint(dst)["params"])
    tool = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "convert_swin_weights.py")
    spec = importlib.util.spec_from_file_location("jax_convert_swin_weights", tool)
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    want = {k: v for k, v in flatten_tree(jtool.translate_swin(
        {k: v.numpy() for k, v in sd.items()})).items() if k[-1] != "relative_position_index"}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("offset", [0.0, 10.0])
def test_patch_norm_matches_flax_layer_norm(offset):
    """Swin's `patch_norm` on its real input, the 4 x 4 conv of raw 0-255
    pixels: flax's LayerNorm (variance E[x^2] - E[x]^2 in fp32) against
    the port's (torch's two-pass variance), with the conv's bias moved so
    that each pixel's channel mean is `offset` x its spread (0: as random
    weights give it). Prints the gap (`pytest -s`); held to TOL."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(frames(18, 2, 64)).permute(0, 3, 1, 2)
    w = torch.from_numpy(rng.standard_normal((96, 3, 4, 4), np.float32) / np.float32(np.sqrt(48)))
    y = torch.nn.functional.conv2d(x, w, stride=4).permute(0, 2, 3, 1)
    y = y + offset * y.std(-1, keepdim=True).mean()
    norm = torch.nn.LayerNorm(96, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 96).astype(np.float32)))
        norm.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 96).astype(np.float32)))
        got = swin.layer_norm(norm, y, torch.float32).numpy()
    params = {"params": {"scale": norm.weight.detach().numpy(),
                         "bias": norm.bias.detach().numpy()}}
    want = np.asarray(jax.jit(nn.LayerNorm(epsilon=1e-5).apply)(params, jnp.asarray(y.numpy())))
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"patch_norm, channel mean {offset} x spread: port - flax {gap:.3g} of the largest")
    assert gap <= TOL


# -- bf16 ------------------------------------------------------------------
# Whole networks: JAX's module at dtype=bfloat16, jitted (as JAX runs
# it), against the port's at torch.bfloat16 on the same carried weights.
# XLA keeps some intermediates of a jitted bf16 chain in fp32 where the
# port rounds after each op, so the two differ by bf16 noise: each map's
# mean |port - JAX bf16| is held to BF16_SPREAD x JAX's own mean
# |bf16 - fp32| (measured on these inputs: 1.04-1.12 x for Swin at window
# 4 and 7, 1.12-1.43 x for focalnet_tscd; the largest single element's gap
# is noise, up to 2.97 x JAX's for focalnet_tscd). A bf16 network that ran
# its logits, its LayerNorm statistics or FocalNet's stream at another
# precision stays inside that spread too (measured by patching each into
# the port: 1.0-1.5 x), so which parts run in fp32 is held by the module
# tests after these, on inputs where another choice shows.
BF16_SPREAD = 2.0
BF = torch.bfloat16


def bf16_ulp(scale):
    """One bf16 ulp at magnitude `scale`."""
    return float(2.0 ** (np.floor(np.log2(scale)) - 7))


def mean_gap(got, want):
    """Mean |got - want| over mean |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def assert_bf16_spread(pm, x, jm16, variables, want32, what):
    want16 = net_maps(jax.jit(jm16.apply)(variables, jnp.asarray(x)))
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    with torch.no_grad():
        out = net_maps(pm.eval()(torch.from_numpy(x)))
    for k, (g, w16, w32) in enumerate(zip(out, want16, want32)):
        assert g.dtype == BF and w16.dtype == jnp.bfloat16, f"{what} map {k}: {g.dtype}"
        gap, ref = mean_gap(nhwc(g.float()), w16), mean_gap(w16, w32)
        assert gap <= BF16_SPREAD * ref, f"{what} map {k}: {gap} against JAX's {ref}"


def test_swin_bf16_within_jax_bf16_spread(swin_case):
    jm, _, variables, x, want32 = swin_case
    ws = jm.window_size
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the shrunk tables, as in swin_case
        assert_bf16_spread(swin.SwinTransformer(window_size=ws, dtype=BF, **SWIN_SMALL), x,
                           jswin.SwinTransformer(window_size=ws, dtype=jnp.bfloat16,
                                                 **SWIN_SMALL), variables, want32, "swin")


def test_focalnet_tscd_bf16_within_jax_bf16_spread(focal_case):
    _, variables, x, want32 = focal_case
    assert_bf16_spread(focalnet.build_focalnet("focalnet_tscd", dtype=BF, **FOCAL_SMALL), x,
                       jfocal.build_focalnet("focalnet_tscd", dtype=jnp.bfloat16, **FOCAL_SMALL),
                       variables, want32, "focalnet")


@pytest.mark.parametrize("ws,shift", [(4, 2), (7, 0)], ids=["window4_shifted", "window7"])
def test_window_attention_logits_are_fp32_at_bf16(ws, shift):
    """Swin's attention at bf16 with exact projections (q = x, k = a signed
    permutation of x's channels, v = x, proj the identity, so both sides
    see the same bf16 q, k and v), the relative-position bias and, shifted,
    the -100 mask, on logits up to ~35: the port equals JAX's
    (fp32 logits, bias, mask and softmax; attn @ v at bf16) within one
    bf16 ulp of the output's scale (measured: 0). Logits rounded to bf16
    before the softmax miss by 2.5-4.6 ulps here, a bf16 softmax by
    3.0-3.25 (measured by patching each into the port)."""
    dim, heads, H = 32, 2, (8 if shift else 7)
    rng = np.random.default_rng(ws)
    x = torch.from_numpy(rng.standard_normal((2 * (H // ws) ** 2, ws * ws, dim),
                                             np.float32) * 3).to(BF)
    perm = np.eye(dim, dtype=np.float32)[rng.permutation(dim)] * rng.choice([-1, 1], dim)
    kernel = np.concatenate([np.eye(dim), perm, np.eye(dim)], 1).astype(np.float32)
    table = rng.standard_normal(((2 * ws - 1) ** 2, heads)).astype(np.float32)
    params = {"qkv": {"kernel": kernel, "bias": np.zeros(3 * dim, np.float32)},
              "proj": {"kernel": np.eye(dim, dtype=np.float32),
                       "bias": np.zeros(dim, np.float32)},
              "relative_position_bias_table": table}
    mask = swin.shift_attn_mask(H, H, ws, shift) if shift else None
    want = np.asarray(jax.jit(jswin.WindowAttention(dim, ws, heads, dtype=jnp.bfloat16).apply)(
        {"params": params}, jnp.asarray(x.float().numpy(), jnp.bfloat16),
        None if mask is None else jnp.asarray(mask, jnp.bfloat16)), np.float32)
    pm = swin.WindowAttention(dim, ws, heads, dtype=BF)
    with torch.no_grad():
        pm.qkv.weight.copy_(torch.from_numpy(kernel.T))
        pm.qkv.bias.zero_()
        pm.proj.weight.copy_(torch.eye(dim))
        pm.proj.bias.zero_()
        pm.relative_position_bias_table.copy_(torch.from_numpy(table))
        got = pm(x, None if mask is None else torch.from_numpy(mask))
    assert got.dtype == BF
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= bf16_ulp(np.abs(want).max()), err


@pytest.mark.parametrize("offset", [0.0, 30.0])
def test_layer_norm_at_bf16_matches_flax(offset):
    """`swin.layer_norm` writing bf16 from an fp32 input (FocalNet's fp32
    residual stream) whose channel mean is `offset` x its spread, against
    flax's LayerNorm(dtype=bfloat16): within one bf16 ulp of the output's
    scale (measured: 0.12 and 0.5). Statistics of the input rounded to
    bf16 first miss by 6 ulps at offset 30 (measured by patching it into
    the port)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 8, 8, 64)) + offset).astype(np.float32)
    norm = torch.nn.LayerNorm(64, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32)))
        norm.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 64).astype(np.float32)))
        got = swin.layer_norm(norm, torch.from_numpy(x), BF)
    params = {"params": {"scale": norm.weight.detach().numpy(),
                         "bias": norm.bias.detach().numpy()}}
    want = np.asarray(jax.jit(nn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16).apply)(
        params, jnp.asarray(x)), np.float32)
    assert got.dtype == BF
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= bf16_ulp(np.abs(want).max()), err


def _block(kind):
    """(JAX's block at bf16, the port's) of Swin (window 4, shifted) or
    focalnet_tscd (post-LN, layerscale, 4 levels of window 3), dim 16."""
    if kind == "swin":
        return (jswin.SwinBlock(16, 2, 4, 2, dtype=jnp.bfloat16),
                swin.SwinBlock(16, 2, 4, 2, dtype=BF))
    flags = dict(mlp_ratio=4.0, focal_level=4, focal_window=3, use_postln=True,
                 use_layerscale=True)
    return (jfocal.FocalBlock(16, dtype=jnp.bfloat16, **flags),
            focalnet.FocalBlock(16, dtype=BF, **flags))


@pytest.mark.parametrize("kind", ["swin", "focalnet"])
def test_residual_stream_dtype_at_bf16_is_jaxs(kind):
    """The residual stream's dtype after a block at bf16, from a bf16 and
    from an fp32 stream, is JAX's (jax.eval_shape): Swin's stays bf16 from
    bf16; FocalNet's fp32 layerscale gammas make it fp32, as JAX's type
    promotion does."""
    jm, pm = _block(kind)
    x = np.random.default_rng(9).standard_normal((1, 8, 8, 16)).astype(np.float32)
    for dt, jdt in ((BF, jnp.bfloat16), (torch.float32, jnp.float32)):
        xj = jax.ShapeDtypeStruct(x.shape, jdt)
        want = jax.eval_shape(lambda v, z: jm.apply(v, z), jax.eval_shape(
            lambda z: jm.init(jax.random.PRNGKey(0), z), xj), xj).dtype
        with torch.no_grad():
            got = pm(torch.from_numpy(x).to(dt)).dtype
        assert str(got).split(".")[-1] == str(want), (kind, dt, got, want)
