"""The DETR decoder and set criterion (`models.decoder`) and the layer zoo
(`models.custom_layers`) of the port against the JAX package on the CPU.

JAX's variables come from the module's shapes (`jax.eval_shape`, no init
compile) with seeded values (`seeded`: kernels normal with variance
1 / fan_in, biases N(0, 0.1), LayerNorm scales U(0.5, 1.5), the query
embedding N(0, 1)); the port's converter (`utils.convert.
state_dict_from_flax`) carries them in, reshaping flax's attention
kernels into nn.Linear weights. JAX's side runs as its own tests run it
on the CPU: the Hungarian solver through its XLA lowering, jitted.

Tolerances: fp32 both sides, another summation order: each output
within 1e-4 of its largest absolute value (TOL), each gradient within
1e-4 of its largest absolute value; the matchings exactly; DropBlock,
whose random seeds cannot be matched, under one seed mask (JAX's
`jax.random.bernoulli` patched to return it), within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tscd_tpu.models import custom_layers as jcl
from tscd_tpu.models import decoder as jdec
from tscd_torch.models import custom_layers as pcl
from tscd_torch.models import decoder as pdec
from tscd_torch.utils.convert import flatten_tree, flax_from_state_dict, state_dict_from_flax
from torch_port_util import assert_close

TOL = 1e-4
T = torch.from_numpy
C, Q, DIM, HEADS, N = 5, 16, 32, 4, 40


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(module, seed, *args):
    """Seeded variables of the flax `module` (from jax.eval_shape)."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in traverse_util.flatten_dict(shapes["params"]).items():
        if k[-1] == "kernel":        # an attention's q/k/v kernel is (dim, heads, head_dim)
            qkv = k[-2] in ("query", "key", "value")
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0] if qkv else np.prod(s.shape[:-1]))
        elif k[-1] == "bias":
            v = rng.normal(0, 0.1, s.shape)
        elif k[-1] == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif k[-1] == "query_embed":
            v = rng.normal(size=s.shape)
        else:
            raise ValueError(f"no seeded init for {k}")
        out[k] = v.astype(np.float32)
    return {"params": traverse_util.unflatten_dict(out)}


# -- the decoder -----------------------------------------------------------
@pytest.fixture(scope="module")
def decoder():
    """JAX's TransformerDecoder (dim 32, 4 heads, 2 layers, 16 queries, 5
    classes), its seeded variables, the port's decoder carrying them, a
    (40, 32) memory."""
    rng = np.random.default_rng(0)
    mem = rng.normal(size=(N, DIM)).astype(np.float32)
    jm = jdec.TransformerDecoder(num_classes=C, dim=DIM, heads=HEADS, num_layers=2,
                                 num_queries=Q)
    variables = seeded(jm, 1, jnp.asarray(mem))
    pm = pdec.TransformerDecoder(C, DIM, DIM, HEADS, 2, Q)
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    return jm, variables, pm, mem


def test_decoder_matches_jax(decoder):
    jm, variables, pm, mem = decoder
    want = jax.jit(jm.apply)(variables, jnp.asarray(mem))
    with torch.no_grad():
        got = pm(T(mem))
    for k in ("pred_logits", "pred_boxes"):
        assert_close(got[k].numpy(), want[k], k)


def test_decoder_memory_valid_matches_jax(decoder):
    """The cross-attention's key mask, on the first layer of the decoder:
    JAX's (1, 1, 1, N) mask broadcasts a leading axis of 1 into its layer's
    output, so its masked decoder runs one layer only (a second layer's
    attention raises on the ranks) and returns (1, 1, Q, .); the port's
    stays (L, Q, .)."""
    _, variables, _, mem = decoder
    keep = ("query_embed", "input_proj", "layer0", "cls_0", "box_0")
    one = {"params": {k: v for k, v in variables["params"].items() if k in keep}}
    jm = jdec.TransformerDecoder(num_classes=C, dim=DIM, heads=HEADS, num_layers=1,
                                 num_queries=Q)
    pm = pdec.TransformerDecoder(C, DIM, DIM, HEADS, 1, Q)
    pm.load_state_dict(state_dict_from_flax(one, pm.state_dict()))
    valid = np.arange(N) < 29
    want = jax.jit(jm.apply)(one, jnp.asarray(mem), jnp.asarray(valid))
    with torch.no_grad():
        got = pm(T(mem), T(valid))
        full = pm(T(mem), T(np.ones(N, bool)))["pred_logits"]
    for k in ("pred_logits", "pred_boxes"):
        w = np.asarray(want[k])
        assert w.shape[:2] == (1, 1)
        assert_close(got[k].numpy(), w[:, 0], k)
    assert float((full - got["pred_logits"]).abs().max()) > 1e-3     # the mask matters


def test_decoder_names_round_trip(decoder):
    """The port's state_dict goes back to exactly JAX's tree, the attention
    kernels in flax's (dim, heads, head_dim) and (heads, head_dim, dim)."""
    _, variables, pm, _ = decoder
    back = flatten_tree(flax_from_state_dict(pm.state_dict(), heads=HEADS)["params"])
    want = flatten_tree(variables["params"])
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))
    assert back[("layer0", "cross_attn", "out", "kernel")].shape == (HEADS, DIM // HEADS, DIM)
    with pytest.raises(ValueError, match="heads"):
        flax_from_state_dict(pm.state_dict())


def gts(seed, n_valid):
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0.2, 0.8, (Q, 4)).astype(np.float32)
    classes = rng.integers(0, C, Q).astype(np.int32)
    return boxes, classes, np.arange(Q) < n_valid


@pytest.mark.parametrize("n_valid", [3, 16])
def test_hungarian_match_equals_jax(decoder, n_valid):
    """col4row on the decoder's last-layer predictions, equal element for
    element, with 3 valid gts (13 columns at the solver's `big`) and all."""
    jm, variables, pm, mem = decoder
    out = jax.jit(jm.apply)(variables, jnp.asarray(mem))
    boxes, classes, valid = gts(2, n_valid)
    args = (out["pred_logits"][-1], out["pred_boxes"][-1], classes, boxes, valid)
    want = np.asarray(jax.jit(jdec.hungarian_match)(*map(jnp.asarray, args)))
    got = pdec.hungarian_match(*(T(np.array(a)) for a in args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_hungarian_match_identity_with_tied_logits():
    """test_extras.py:77: all-zero logits (every class cost tied) and the
    queries on the gt boxes -> the identity, as JAX's."""
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0.2, 0.7, (8, 4)).astype(np.float32)
    args = (np.zeros((8, C), np.float32), boxes, np.zeros(8, np.int32), boxes, np.ones(8, bool))
    want = np.asarray(jdec.hungarian_match(*map(jnp.asarray, args)))
    got = pdec.hungarian_match(*map(T, args))
    np.testing.assert_array_equal(want, np.arange(8))
    np.testing.assert_array_equal(got.numpy(), want)


def test_set_criterion_losses_and_gradients_match_jax(decoder):
    """set_criterion over both layers (3 valid gts of 16): each loss, and
    d total / d every decoder parameter against jax.grad."""
    jm, variables, pm, mem = decoder
    boxes, classes, valid = gts(3, 3)

    def jtotal(params):
        o = jm.apply({"params": params}, jnp.asarray(mem))
        parts = jdec.set_criterion(o, jnp.asarray(classes), jnp.asarray(boxes),
                                   jnp.asarray(valid), C)
        return parts["total_loss"], parts

    (_, want), grads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(variables["params"])
    parts = pdec.set_criterion(pm(T(mem)), T(classes), T(boxes), T(valid), C)
    parts["total_loss"].backward()
    for k in ("total_loss", "loss_ce", "loss_bbox", "loss_giou"):
        np.testing.assert_allclose(float(parts[k].detach()), float(want[k]), rtol=TOL,
                                   err_msg=k)
    named = dict(pm.named_parameters())
    gwant = state_dict_from_flax({"params": grads}, named)
    # parameters with no gradient, whose gradients on both sides are fp32
    # noise, held under 1e-6 of the largest gradient: every key bias (it
    # adds one score to all of a query's keys, which the softmax drops),
    # and in layer 0's self-attention, which reads values of tgt = 0 (one
    # bias for every key), the value weight and the query and key weights
    # and query bias
    floor = 1e-6 * max(float(np.abs(g.numpy()).max()) for g in gwant.values())
    zero = {n for n in named if n.endswith("key.bias")} | {
        f"layer0.self_attn.{n}" for n in ("query.weight", "query.bias", "key.weight",
                                          "value.weight")}
    for n, p in named.items():
        if n in zero:
            assert max(float(p.grad.abs().max()), float(np.abs(gwant[n].numpy()).max())) < floor
        else:
            assert float(np.abs(gwant[n].numpy()).max()) > floor, n
            assert_close(p.grad.numpy(), gwant[n].numpy(), f"d total / d {n}")
    pm.zero_grad(set_to_none=True)


# -- the layer zoo ---------------------------------------------------------
def nchw(a):
    return T(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_coordconv_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 9, 12, 4)).astype(np.float32)
    jm = jcl.CoordConv(6)
    variables = seeded(jm, 5, jnp.asarray(x))
    pm = pcl.CoordConv(4, 6)
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    with torch.no_grad():
        got = nhwc(pm(nchw(x)))
    assert_close(got, jax.jit(jm.apply)(variables, jnp.asarray(x)), "coordconv")


def test_deform_conv_matches_jax():
    """Seeded (non-zero) offset weights, scaled so that the offsets reach
    several pixels: samples between pixels, clamped at the edge, and
    wholly outside the map (zero)."""
    x = np.random.default_rng(6).normal(size=(2, 8, 8, 6)).astype(np.float32)
    jm = jcl.DeformConv2d(5)
    variables = seeded(jm, 7, jnp.asarray(x))
    variables["params"]["offset_conv"]["kernel"] *= 4.0
    pm = pcl.DeformConv2d(6, 5)
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    with torch.no_grad():
        got = nhwc(pm(nchw(x)))
        off = pm.offset_conv(torch.nn.functional.pad(nchw(x), (1, 1, 1, 1)))[:, :18]
    assert float(off.abs().max()) > 3.0            # some taps land off the map
    assert_close(got, jax.jit(jm.apply)(variables, jnp.asarray(x)), "deform conv")


@pytest.mark.parametrize("block_size", [3, 4])
def test_dropblock_matches_jax(block_size, monkeypatch):
    """Eval mode is the identity; in train mode the same seed mask (JAX's
    bernoulli patched to return it) drops the same blocks (an even block's
    "SAME" pool pads 1 before and 2 after) and scales the same; the
    port's own draw is its `drop` of `torch.rand < gamma`."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 10, 10, 3)).astype(np.float32)
    db = jcl.DropBlock(block_size, 0.8)
    pm = pcl.DropBlock(block_size, 0.8)
    np.testing.assert_array_equal(np.asarray(db.apply({}, jnp.asarray(x), False)), x)
    assert pm(nchw(x)).equal(nchw(x))
    seed = rng.uniform(size=x.shape) < pm.gamma(10, 10)
    assert 0 < seed.sum() < seed.size // 10
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(seed))
    want = db.apply({}, jnp.asarray(x), True, rng=jax.random.PRNGKey(0))
    got = nhwc(pm.drop(nchw(x), nchw(seed)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    assert (got == 0).any() and (got != 0).any()
    gen = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    drawn = torch.rand(nchw(x).shape, generator=gen()) < pm.gamma(10, 10)
    assert pm(nchw(x), True, gen()).equal(pm.drop(nchw(x), drawn))
