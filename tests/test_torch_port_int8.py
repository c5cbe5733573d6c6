"""The port's int8 (w8a8) serving mode against the JAX package's
`int8_eval` (tscd_tpu/models/blocks.py:32-353), on the CPU, where the hand
int8 conv (`ops.kernels.int8_conv`) takes its plain versions; the same
numpy-seeded inputs and weights on both sides.

  - BaseConv at fp32, k 1 and 3, stride 1 and 2, `valid`, dynamic and
    static (JAX's calibrated `quant` carried across): within 1e-5 of JAX's
    largest output (the int8 sums are exact; the dequant epilogue and the
    activation are fp32 ops in the same order; what is left is XLA's and
    torch's exp and log, which decide a rounding flip at most).
  - BaseConv at bf16: the cast conv output (act id) bit-identical to JAX's
    with dynamic scales, within one bf16 ulp with static ones (XLA's log
    and exp are not torch's: a channel's x_scale an ulp apart flips a
    rounding now and then); leaky ReLU within one bf16 ulp (JAX multiplies
    by 0.1 rounded to bf16, torch by 0.1 in fp32); SiLU within two bf16
    ulps (JAX's bf16 SiLU rounds the sigmoid and the product one by one,
    torch computes it in fp32 and rounds once, as the port's bf16 fp path
    does).
  - Calibration: a BaseConv's scales equal JAX's exactly (1e-7 relative
    allowed); the selftest TSCD's 70 within 1e-5 relative (the maxima of
    fp32 activations that two conv implementations sum in other orders);
    a frame-chunked calibration equals the one-shot one exactly.
  - Which convs quantize, and how many: C_in below the mode's threshold,
    groups > 1 and train-mode BN keep the fp route bit for bit; the
    threshold is on C_in; the selftest TSCD runs as many int8 convs as JAX
    traces `_int8_forward` calls (12 dynamic, 70 static).
  - `prepare_int8` leaves the state_dict's keys, shapes and values alone.
  - The conv kernel's K order (tap-major, channel-minor, C_in padded to
    32): packed weights times the unfolded int8 input equal the plain
    version's sums exactly; and a numpy mirror of the CUDA kernels' index
    maps (the conv's cp.async tiles, swizzle, ldmatrix fragments, mma
    operands and epilogue; the quantize pass's transpose) gives the plain
    versions' results exactly, since a CUDA kernel cannot run here.
  - Whole models at fp32, dynamic and static: the selftest TSCD (raw,
    refined class and box outputs) and YOLOX at depth 0.33, width 0.25,
    96 px (decoded outputs). Rounding flips from ulp-level differences
    upstream are expected, so: mean |port - JAX int8| <= 0.1 x mean |JAX
    int8 - JAX fp32|, and max |port - JAX int8| <= JAX's own max |int8 -
    fp32|. With static scales every conv from C_in 32 quantizes, and on
    these random weights one flip sets off others layer after layer: JAX
    itself, each of its calibrated scales moved one fp32 ulp up or down
    at random, lands as far from its own static output (selftest TSCD
    raw outputs: mean 2e-7 to 0.027 over 8 draws, against an int8-to-fp32
    distance of 0.039). XLA's log and exp are not torch's (2% and 9% of
    fp32 inputs differ in the last bit), so the port's x_scale differs by
    such ulps; the static bound is the larger of that rule and the
    farthest of 8 such draws of JAX's (`chip_smoke.int8_spread_rule`, the
    rule the card's int8 window is held to as well), and at most 7 x the
    0.1 rule: 0.7 x mean |JAX int8 - fp32|, so that a route that did not
    quantize would fail. The draws reach 4.2 (YOLOX) to 10.4 (TSCD
    refined boxes) x the 0.1 rule; the port's static distance is 0.21 to
    0.49 x mean |JAX int8 - fp32| (1e-5 x on the refined boxes).
  - tscd_eval --int8 and --int8-calib 2 on the selftest fixture give the
    detections and the mAP of a direct evaluate under the same mode; the
    other four CLIs take --int8.
  - The accuracy tool's dataset equals the JAX tool's byte for byte.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from tscd_tpu.models import blocks as jblk
from tscd_tpu.models import matching as jmat
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.models.yolox import YOLOX as JYOLOX
from tscd_torch.exp.tscd_large import selftest_exp
from tscd_torch.models import blocks as pblk
from tscd_torch.models.tscd import TSCD
from tscd_torch.models.yolox import YOLOX
from tscd_torch.ops.kernels import int8_conv as q8
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.utils.convert import scales_from_flax_quant, state_dict_from_flax
from tscd_torch.utils.model_utils import prepare_int8, set_int8_scales
from torch_port_util import seeded_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "YOLOX_outputs", "validate_ref", "vid")
REF_PTH = os.path.join(REPO, "YOLOX_outputs", "validate_ref", "ref_random.pth")
EXP = selftest_exp()
L, G = EXP.lframe_val, EXP.gframe_val
P, C = EXP.num_proposals, EXP.num_classes
BF = torch.bfloat16
T = torch.from_numpy


class Counting:
    """Counts the calls of `owner.name` while installed."""

    def __init__(self, owner, name):
        self.owner, self.name, self.n = owner, name, 0
        self.orig = getattr(owner, name)

    def __enter__(self):
        def call(*a, **k):
            self.n += 1
            return self.orig(*a, **k)
        setattr(self.owner, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _x(seed, n=2, c=128, hw=12):
    """N(0, 2) activations with an outlier channel (x20), NCHW."""
    x = np.random.default_rng(seed).normal(0, 2, (n, c, hw, hw)).astype(np.float32)
    x[:, 7] *= 20
    return x


def _baseconv(cin, cout, k, stride=1, act="silu", jdtype=jnp.float32, seed=0):
    """A JAX BaseConv with non-trivial BN statistics (as
    tests/test_int8_eval.py) and the port's with the same weights,
    prepared for int8. Returns (JAX module, variables, port module)."""
    rng = np.random.default_rng(seed)
    jm = jblk.BaseConv(cout, k, stride, act=act, dtype=jdtype)
    v = {"params": {"conv": {"kernel": (rng.normal(size=(k, k, cin, cout))
                                        / np.sqrt(k * k * cin)).astype(np.float32)},
                    "bn": {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                           "bias": rng.normal(0, 0.1, cout).astype(np.float32)}},
         "batch_stats": {"bn": {"mean": rng.normal(0, 0.1, cout).astype(np.float32),
                                "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)}}}
    pdtype = torch.float32 if jdtype == jnp.float32 else BF
    pm = pblk.BaseConv(cin, cout, k, stride, act=act, dtype=pdtype)
    sd = {"conv.weight": T(v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1).copy()),
          "bn.weight": T(v["params"]["bn"]["scale"]), "bn.bias": T(v["params"]["bn"]["bias"]),
          "bn.running_mean": T(v["batch_stats"]["bn"]["mean"]),
          "bn.running_var": T(v["batch_stats"]["bn"]["var"]),
          "bn.num_batches_tracked": torch.tensor(0)}
    pm.load_state_dict(sd)
    prepare_int8(pm, sd)
    return jm, v, pm


def _nhwc(x, dtype=jnp.float32):
    return jnp.asarray(x.transpose(0, 2, 3, 1)).astype(dtype)


def _nchw(y):
    return np.asarray(jnp.asarray(y).astype(jnp.float32)).transpose(0, 3, 1, 2)


def _pair(jm, v, pm, x, mode, valid=False, jdtype=jnp.float32):
    """(JAX's output, the port's output) NCHW fp32 of one BaseConv in
    `mode` (dynamic or static; static calibrates both on x first, the
    port taking JAX's scales), with the two packages' scales."""
    xj, xp = _nhwc(x, jdtype), T(x).to(pm.conv.weight.dtype)
    scales = None
    if mode == "static":
        vq = jblk.quantize_int8(lambda vv, a, **kw: jm.apply(vv, a, valid=valid, **kw), v, xj)
        scales = (np.asarray(vq["quant"]["act_scale"]),
                  pblk.quantize_int8(pm, xp, valid=valid)[""].numpy())
        set_int8_scales(pm, {"": torch.tensor(scales[0])})
        with jblk.int8_eval(static=True):
            want = jm.apply(vq, xj, valid=valid)
        with pblk.int8_eval(static=True), torch.no_grad():
            got = pm(xp, valid=valid)
    else:
        with jblk.int8_eval():
            want = jm.apply(v, xj, valid=valid)
        with pblk.int8_eval(), torch.no_grad():
            got = pm(xp, valid=valid)
    return _nchw(want), got.float().numpy(), scales


BASECONV_CASES = [(1, 1, False), (3, 1, False), (3, 2, False), (3, 1, True), (1, 2, False)]


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("k,stride,valid", BASECONV_CASES)
def test_baseconv_fp32_matches_jax(k, stride, valid, mode):
    jm, v, pm = _baseconv(128, 96, k, stride, seed=k + 3 * stride)
    want, got, scales = _pair(jm, v, pm, _x(k + stride), mode, valid)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if scales is not None:     # the same activations: the same maxima
        np.testing.assert_allclose(scales[1], scales[0], rtol=1e-7, atol=0)


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps of |want| (bf16 keeps 8 significant bits)."""
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    return np.abs(got - want) / ulp


@pytest.mark.parametrize("act,mode,ulps", [
    ("id", "dynamic", 0), ("id", "static", 1), ("lrelu", "dynamic", 1), ("lrelu", "static", 1),
    ("silu", "dynamic", 2), ("silu", "static", 2)])
def test_baseconv_bf16_matches_jax(act, mode, ulps):
    jm, v, pm = _baseconv(128, 96, 3, act=act, jdtype=jnp.bfloat16, seed=5)
    want, got, _ = _pair(jm, v, pm, _x(6), mode, jdtype=jnp.bfloat16)
    assert _bf16_ulps(got, want).max() <= ulps


def test_static_without_scales_raises_and_jax_knobs_not_ported():
    _, _, pm = _baseconv(128, 32, 1)
    with pblk.int8_eval(static=True), pytest.raises(ValueError, match="calibrated"):
        pm(T(_x(0)))
    # scope and QAT run (tests/test_torch_port_int8_train.py); what JAX has
    # and the port does not: QAT with static scales, and a scope over
    # convs whose paths were never stamped
    with pblk.int8_eval(static=True, qat=True), pytest.raises(NotImplementedError,
                                                             match="static"):
        pm(T(_x(0)))
    with pblk.int8_eval(scope=(("backbone",),)), pytest.raises(ValueError,
                                                              match="stamp_int8_paths"):
        pblk.BaseConv(128, 8, 1)(T(_x(1)))
    with pytest.raises(ValueError, match="prepare_int8"):
        with pblk.int8_eval():
            pblk.BaseConv(128, 8, 1)(T(_x(1)))


# -- which convs quantize --------------------------------------------------


def _calls(pm, x, **mode):
    with Counting(q8, "int8_conv") as c, pblk.int8_eval(**mode), torch.no_grad():
        y = pm(x)
    return y, c.n


def test_fp_route_kept_below_threshold_for_groups_and_train_bn():
    x64 = T(_x(2, c=64))
    _, _, pm = _baseconv(64, 256, 3)       # C_out 256: the gate is on C_in
    with torch.no_grad():
        fp = pm(x64)
    y, n = _calls(pm, x64)
    assert n == 0 and torch.equal(y, fp)
    dw = pblk.DWConv(128, 64, 3)
    prepare_int8(dw)
    x = T(_x(3))
    with torch.no_grad():
        fp_d = dw.dconv(x)
    with Counting(q8, "int8_conv") as c, pblk.int8_eval(), torch.no_grad():
        d = dw.dconv(x)
        dw(x)
    assert torch.equal(d, fp_d) and c.n == 1     # the pointwise conv only
    _, _, pm = _baseconv(128, 32, 1)
    stats_fp, stats_q = {}, {}
    fp = pm(x, stats_fp)
    with Counting(q8, "int8_conv") as c, pblk.int8_eval():
        y = pm(x, stats_q)
    assert c.n == 0 and torch.equal(y, fp)
    _, _, pm = _baseconv(128, 16, 1)        # C_out 16, C_in 128: quantizes
    assert _calls(pm, x)[1] == 1


def test_static_and_calibrate_quantize_from_cin_32():
    _, _, pm = _baseconv(32, 64, 3)
    x = T(_x(4, c=32))
    assert _calls(pm, x)[1] == 0
    with Counting(q8, "int8_conv") as c:
        scales = pblk.quantize_int8(pm, x)
    assert c.n == 0 and scales[""].shape == (32,)     # calibration runs fp convs
    set_int8_scales(pm, scales)
    assert _calls(pm, x, static=True)[1] == 1


def test_prepare_int8_keeps_state_dict():
    m = TSCD(num_classes=C, depth=EXP.depth, width=EXP.width, num_proposals=P,
             minimal_limit=EXP.minimal_limit, heads=EXP.heads, device="cpu")
    before = {k: v.clone() for k, v in m.state_dict().items()}
    prepare_int8(m)
    after = m.state_dict()
    assert list(after) == list(before)
    for k, v in before.items():
        assert after[k].shape == v.shape and torch.equal(after[k], v), k
    with pytest.raises(ValueError, match="fp32"):
        prepare_int8(TSCD(num_classes=C, depth=EXP.depth, width=EXP.width, num_proposals=P,
                          minimal_limit=EXP.minimal_limit, heads=EXP.heads, device="cpu",
                          dtype=BF))


def test_graph_key_follows_mode_and_preparation():
    _, _, pm = _baseconv(128, 8, 1)
    assert pblk.int8_graph_key(pm) is None
    with pblk.int8_eval():
        dyn = pblk.int8_graph_key(pm)
    with pblk.int8_eval(static=True):
        sta = pblk.int8_graph_key(pm)
    prepare_int8(pm)
    with pblk.int8_eval():
        again = pblk.int8_graph_key(pm)
    assert len({dyn, sta, again}) == 3 and None not in (dyn, sta, again)


def test_prepare_int8_again_replaces_weights_and_scales_touch_only_scales():
    """A second `prepare_int8` after new weights serves the new ones (as a
    fresh preparation does, bit for bit); `set_int8_scales` keeps the
    weights and raises on a name that is no prepared BaseConv."""
    _, _, pm = _baseconv(128, 32, 3, seed=1)
    x = T(_x(2))
    _, _, fresh = _baseconv(128, 32, 3, seed=2)
    pm.load_state_dict(fresh.state_dict())
    old = pm._int8
    prepare_int8(pm)
    assert pm._int8 is not old
    with pblk.int8_eval(), torch.no_grad():
        assert torch.equal(pm(x), fresh(x))
    dynamic = pm._int8.dynamic
    token = pm._int8_token
    set_int8_scales(pm, pblk.quantize_int8(pm, x))
    assert pm._int8.dynamic is dynamic and pm._int8.static is not None
    assert pm._int8_token != token
    with pytest.raises(KeyError, match="prepare_int8"):
        set_int8_scales(pm, {"conv": torch.ones(128)})
    with pytest.raises(KeyError, match="prepare_int8"):
        set_int8_scales(pblk.BaseConv(128, 8, 1), {"": torch.ones(128)})


def test_mode_defaults_and_sticky_toggle_as_jax():
    """The mode is off by default, with JAX's C_in gates; `set_int8_eval`
    turns it on in the calling context only, as JAX's (the mode is a
    ContextVar)."""
    import contextvars
    assert pblk.int8_mode() == pblk.Int8Mode() and not pblk.int8_eval_enabled()
    assert (pblk.INT8_MIN_CIN, pblk.INT8_MIN_CIN_STATIC) == (128, 32)

    def sticky():
        pblk.set_int8_eval(True)
        return pblk.int8_eval_enabled(), pblk.int8_mode()
    on, mode = contextvars.copy_context().run(sticky)
    assert on and mode == pblk.Int8Mode(enable=True)
    assert not pblk.int8_eval_enabled()


# -- the kernels' arithmetic and index maps --------------------------------


def _int8_case(seed, F=2, H=7, W=7, C=48, N=72, k=3):
    rng = np.random.default_rng(seed)
    x = T(rng.normal(0, 1, (F, C, H, W)).astype(np.float32))
    w = T(rng.normal(0, 1, (N, C, k, k)).astype(np.float32))
    s_w = torch.clamp_min(w.abs().amax((1, 2, 3)), 1e-8) / 127.0
    xq = q8.quantize_int8_activation(x, q8.abs_max(x), "dynamic")
    return x, w, xq, q8.pack_int8_weight(w, s_w), s_w


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (3, 1, 0), (1, 1, 0)])
def test_packed_weights_in_kernel_k_order(k, stride, pad):
    """A row of the packed weights is K = (ky, kx, c) with c padded to 32:
    times the input unfolded in that order, the plain version's sums."""
    x, w, xq, wq, _ = _int8_case(k + stride, k=k)
    Fn, H, W, Cp = xq.shape
    assert wq.shape == (w.shape[0], k, k, Cp) and Cp == 64
    assert torch.equal(wq[..., 48:], torch.zeros_like(wq[..., 48:]))
    xp = torch.nn.functional.pad(xq.long(), (0, 0, pad, pad, pad, pad))
    Ho, Wo = q8.out_size(H, k, stride, pad), q8.out_size(W, k, stride, pad)
    cols = torch.stack([xp[:, ky:ky + stride * (Ho - 1) + 1:stride,
                           kx:kx + stride * (Wo - 1) + 1:stride]
                        for ky in range(k) for kx in range(k)], 3)    # (F, Ho, Wo, taps, Cp)
    sums = cols.reshape(Fn * Ho * Wo, -1) @ wq.reshape(wq.shape[0], -1).long().T
    want = q8.int8_conv_reference(xq, wq, stride, pad)
    assert torch.equal(sums.reshape(Fn, Ho, Wo, -1).permute(0, 3, 1, 2).int(), want)


def _swz(r, h):
    """int8_conv.cu's swz: byte offset of row r's 16-byte half h."""
    return r * 32 + ((h ^ ((r >> 2) & 1)) << 4)


def _ldmatrix_x4(smem, addr):
    """ldmatrix .x4 .b16: lane l gives the address of row l % 8 of matrix
    l // 8; lane t receives from each matrix the 4 bytes of row t // 4 at
    byte 4 (t % 4). Returns (4, 32, 4) uint8: matrix, lane, bytes."""
    t = np.arange(32)
    src = addr.reshape(4, 8)[:, t // 4] + 4 * (t % 4)           # (4, 32)
    return smem[src[..., None] + np.arange(4)]


def _mma_m16n8k32(a, b):
    """mma.m16n8k32 s8: a (4, 32, 4) and b (2, 32, 4) fragments -> the
    (4, 32) int sums c0..c3 of each lane, by the PTX fragment layouts."""
    t = np.arange(32)
    g, q = t // 4, t % 4
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for r, (row, col) in enumerate(((g, 0), (g + 8, 0), (g, 16), (g + 8, 16))):
        A[row[:, None], col + 4 * q[:, None] + np.arange(4)] = a[r].view(np.int8)
    for r in range(2):
        B[16 * r + 4 * q[:, None] + np.arange(4), g[:, None]] = b[r].view(np.int8)
    Cm = A @ B
    return np.stack([Cm[g, 2 * q], Cm[g, 2 * q + 1], Cm[g + 8, 2 * q], Cm[g + 8, 2 * q + 1]])


def simulate_conv_kernel(xq, wq, stride, pad):
    """numpy mirror of int8_conv_mma's index maps: each block's 4-stage
    loads (one 16-byte copy a thread into the swizzled rows), each warp's
    ldmatrix fragments and m16n8k32 products, the epilogue's output
    positions. Returns the int32 sums (F, N, Ho, Wo)."""
    xb, wb = xq.numpy().view(np.uint8), wq.numpy().view(np.uint8)
    Fn, H, W, Cp = xb.shape
    N, k = wb.shape[:2]
    Ho, Wo = q8.out_size(H, k, stride, pad), q8.out_size(W, k, stride, pad)
    M, K, cpc = Fn * Ho * Wo, k * k * Cp, Cp // 32
    BN = 64 if N <= 64 else 128
    WN, NI = BN // 4, BN // 32
    xf, wf = xb.reshape(-1), wb.reshape(-1)
    out = np.full((Fn, N, Ho, Wo), -2 ** 31, np.int64)
    n_tiles = -(-N // BN)
    tid = np.arange(256)
    lrow, lh = tid >> 1, tid & 1
    lane = np.arange(32)
    lr, lm = lane & 7, lane >> 3
    for bid in range(-(-M // 128) * n_tiles):
        m0, n0 = (bid // n_tiles) * 128, (bid % n_tiles) * BN
        m = m0 + lrow
        m_ok = m < M
        f, rem = m // (Ho * Wo), m % (Ho * Wo)
        iy0, ix0 = (rem // Wo) * stride - pad, (rem % Wo) * stride - pad
        n_ok = (lrow < BN) & (n0 + lrow < N)
        acc = np.zeros((8, 4, NI, 4, 32), np.int64)
        for kc in range(K // 32):
            tap, cc = kc // cpc, kc % cpc
            iy, ix = iy0 + tap // k, ix0 + tap % k
            ok = m_ok & (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            As, Bs = np.zeros(128 * 32, np.uint8), np.zeros(BN * 32, np.uint8)
            src = ((f * H + iy) * W + ix) * Cp + cc * 32 + lh * 16
            for i in np.nonzero(ok)[0]:
                As[_swz(lrow[i], lh[i]) + np.arange(16)] = xf[src[i] + np.arange(16)]
            for i in np.nonzero(n_ok)[0]:
                Bs[_swz(lrow[i], lh[i]) + np.arange(16)] = \
                    wf[(n0 + lrow[i]) * K + kc * 32 + lh[i] * 16 + np.arange(16)]
            for warp in range(8):
                wm, wn = warp >> 2, warp & 3
                af = [_ldmatrix_x4(As, _swz(wm * 64 + (lm & 1) * 8 + lr + 16 * i, lm >> 1))
                      for i in range(4)]
                bf = []
                for j in range(0, NI, 2):
                    r = _ldmatrix_x4(Bs, _swz(wn * WN + (lm >> 1) * 8 + lr + j * 8, lm & 1))
                    bf += [r[:2], r[2:]]
                for i in range(4):
                    for j in range(NI):
                        acc[warp, i, j] += _mma_m16n8k32(af[i], bf[j])
        g, q = lane >> 2, lane & 3
        for warp in range(8):
            wm, wn = warp >> 2, warp & 3
            for i in range(4):
                for half in range(2):
                    mm = m0 + wm * 64 + i * 16 + g + half * 8
                    for j in range(NI):
                        for e in range(2):
                            n = n0 + wn * WN + j * 8 + 2 * q + e
                            keep = (mm < M) & (n < N)
                            fo, ro = mm[keep] // (Ho * Wo), mm[keep] % (Ho * Wo)
                            out[fo, n[keep], ro // Wo, ro % Wo] = acc[warp, i, j, half * 2 + e][keep]
    return out


@pytest.mark.parametrize("shape", [
    dict(F=2, H=7, W=7, C=48, N=72, k=3, stride=2, pad=1),      # C_in 48, N ragged, BN 128
    dict(F=2, H=12, W=11, C=32, N=40, k=1, stride=1, pad=0),    # M over two tiles, BN 64
    dict(F=1, H=6, W=6, C=64, N=136, k=3, stride=1, pad=0)])    # k 3 with pad 0, two N tiles
def test_conv_kernel_index_maps(shape):
    sh = dict(shape)
    stride, pad = sh.pop("stride"), sh.pop("pad")
    _, _, xq, wq, _ = _int8_case(7, **sh)
    want = q8.int8_conv_reference(xq, wq, stride, pad).numpy()
    np.testing.assert_array_equal(simulate_conv_kernel(xq, wq, stride, pad), want)


def simulate_quantize_kernel(x, scale, mode):
    """numpy mirror of int8_quantize's index maps: blocks of 64 pixels x 32
    channels, thread t reading channels 8 (t >> 6) + i of pixel t & 63 into
    two words of a 9-word shared row, written out as words 0..511 of the
    block (pixel w >> 3, word w & 7). Returns (F, H, W, Cp) int8."""
    xn = x.float().numpy()
    Fn, Cn, H, W = xn.shape
    HW, Cp = H * W, q8.padded_channels(Cn)
    div = q8._divisor(scale, mode, x.shape).expand(Fn, Cn, 1, 1).numpy()[..., 0, 0]
    out = np.zeros(Fn * HW * Cp, np.uint8)
    t = np.arange(256)
    p, g = t & 63, t >> 6
    for f in range(Fn):
        for by in range(Cp // 32):
            for bx in range(-(-HW // 64)):
                tile = np.zeros(64 * 9, np.uint32)
                words = np.zeros((256, 2), np.uint32)
                for i in range(8):
                    c = by * 32 + 8 * g + i
                    ok = (c < Cn) & (bx * 64 + p < HW)
                    v = np.where(ok, xn[f].reshape(Cn, HW)[np.minimum(c, Cn - 1),
                                                          np.minimum(bx * 64 + p, HW - 1)], 0)
                    s = div[f, np.minimum(c, Cn - 1)]
                    qv = np.where(ok, np.clip(np.rint(v / s), -127, 127), 0).astype(np.int64)
                    words[:, i >> 2] |= ((qv & 0xFF) << (8 * (i & 3))).astype(np.uint32)
                tile[p * 9 + 2 * g], tile[p * 9 + 2 * g + 1] = words[:, 0], words[:, 1]
                for w in np.concatenate([t, t + 256]):
                    pp, j = w >> 3, w & 7
                    if bx * 64 + pp < HW:
                        o = (f * HW + bx * 64 + pp) * Cp + by * 32 + 4 * j
                        out[o:o + 4] = np.frombuffer(tile[pp * 9 + j].tobytes(), np.uint8)
    return out.view(np.int8).reshape(Fn, H, W, Cp)


@pytest.mark.parametrize("mode", ["dynamic", "channel"])
def test_quantize_kernel_index_maps(mode):
    x = T(_x(8, n=2, c=48, hw=9))
    scale = q8.abs_max(x) if mode == "dynamic" else x.abs().amax((0, 2, 3)) / 127.0
    want = q8.quantize_int8_activation(x, scale, mode).numpy()
    np.testing.assert_array_equal(simulate_quantize_kernel(x, scale, mode), want)


def test_plain_versions_follow_jax_arithmetic():
    """Round half to even after a true division; weights unclipped; the
    epilogue forms s_x * s_w first and adds the bias after."""
    x = T(np.array([[[[0.5, 1.5, 2.5, -0.5, 254.0, -300.0]]]], np.float32))
    q = q8.quantize_reference(x, torch.tensor([1.0]), "channel")
    assert q.shape == (1, 1, 6, 32)
    assert q[0, 0, :, 0].tolist() == [0, 2, 2, 0, 127, -127]
    acc = torch.tensor([[[[3]]]], dtype=torch.int32)
    s_x, s_w, b = torch.tensor([0.1]), torch.tensor([0.3]), torch.tensor([0.7])
    y = q8.epilogue_reference(acc, s_x, s_w, b, "id", torch.float32)
    assert y.item() == np.float32(np.float32(3) * np.float32(np.float32(0.1) * np.float32(0.3))
                                  + np.float32(0.7))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    _, _, xq, wq, s_w = _int8_case(9)
    b = torch.zeros(wq.shape[0])
    amax = torch.ones(1)
    with pytest.raises(ValueError, match="one of amax and s_x"):
        q8.int8_conv(xq, wq, s_w, b, stride=1, pad=1, act="silu", out_dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 32"):
        q8.int8_conv(xq[..., :40], wq[..., :40], s_w, b, stride=1, pad=1, act="silu",
                     out_dtype=torch.float32, amax=amax)
    with pytest.raises(ValueError, match="int8"):
        q8.int8_conv(xq.float(), wq, s_w, b, stride=1, pad=1, act="silu",
                     out_dtype=torch.float32, amax=amax)
    with pytest.raises(ValueError, match="activations"):
        q8.int8_conv(xq, wq, s_w, b, stride=1, pad=1, act="gelu", out_dtype=torch.float32,
                     amax=amax)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        q8.quantize_int8_activation(torch.zeros(1, 4, 2, 2, dtype=torch.float16), amax)


# -- whole models ----------------------------------------------------------


def _assert_close_int8(got, want, ref, what, nudged=()):
    """chip_smoke.int8_spread_rule: mean |got - want| <= 0.1 x mean |want -
    ref| and max |got - want| <= max |want - ref|, or, where larger, the
    largest of JAX's own distances from `want` of the `nudged` runs (JAX
    static, its scales moved by an ulp, `_nudged`), the mean bound at most
    chip_smoke.INT8_SPREAD_CAP x the 0.1 rule."""
    dist, bound, ok = chip_smoke.int8_spread_rule(got, want, ref, nudged)
    assert ok, (what, dist, bound)


NUDGES = chip_smoke.INT8_NUDGES


def _nudged(quant):
    """NUDGES draws of JAX's calibrated scales with each element moved one
    fp32 ulp up or down (a coin each), the size of the port's x_scale
    differences."""
    def draw(seed):
        rng = np.random.default_rng(seed)
        return jax.tree_util.tree_map(lambda a: np.nextafter(
            np.asarray(a), np.where(rng.uniform(size=np.shape(a)) < 0.5, np.float32(np.inf),
                                    np.float32(0))), quant)
    return [draw(seed) for seed in range(NUDGES)]


class _JaxCount:
    """Counts BaseConv._int8_forward calls while JAX traces."""

    def __enter__(self):
        self.n, orig = 0, jblk.BaseConv._int8_forward
        self.orig = orig

        def counting(mod, *a, **k):
            self.n += 1
            return orig(mod, *a, **k)
        jblk.BaseConv._int8_forward = counting
        return self

    def __exit__(self, *exc):
        jblk.BaseConv._int8_forward = self.orig


@pytest.fixture(scope="module")
def tscd():
    """The selftest TSCD, seeded JAX weights carried into the port, one
    window from a fresh state: JAX fp32, int8 dynamic, its calibration and
    int8 static (each jitted once, counting `_int8_forward` while it
    traces), and the port likewise (counting int8_conv calls)."""
    rng = np.random.default_rng(11)
    H, W = EXP.test_size
    x = rng.integers(0, 256, (L + G, H, W, 3), dtype=np.uint8).astype(np.float32)
    te = get_timing_signal_1d(np.arange(L + G))
    jm = JTSCD(num_classes=C, depth=EXP.depth, width=EXP.width, num_proposals=P,
               minimal_limit=EXP.minimal_limit, heads=EXP.heads)
    jx, jte = jnp.asarray(x), jnp.asarray(te)
    v = seeded_variables(jm, 0, jx, jte, L, G, False)
    st = jmat.init_matcher_state(P, int(256 * EXP.width), 4 * int(256 * EXP.width))
    j, counts = {}, {}
    j["fp"] = jax.jit(lambda v, x, t, s: jm.apply(v, x, t, L, G, False, s))(v, jx, jte, st)
    with jblk.int8_eval(), _JaxCount() as c:
        j["dynamic"] = jax.jit(lambda v, x, t, s: jm.apply(v, x, t, L, G, False, s))(
            v, jx, jte, st)
    counts["jax dynamic"] = c.n
    with jblk.int8_eval(calibrate=True):
        quant = jax.jit(lambda v, x, t, s: jm.apply(v, x, t, L, G, False, s,
                                                    mutable=["quant"])[1])(v, jx, jte, st)
    with jblk.int8_eval(static=True), _JaxCount() as c:
        static = jax.jit(lambda v, x, t, s: jm.apply(v, x, t, L, G, False, s))
        j["static"] = static({**v, "quant": quant["quant"]}, jx, jte, st)
        j["nudged"] = [static({**v, "quant": q}, jx, jte, st) for q in _nudged(quant["quant"])]
    counts["jax static"] = c.n
    pm = TSCD(num_classes=C, depth=EXP.depth, width=EXP.width, num_proposals=P,
              minimal_limit=EXP.minimal_limit, heads=EXP.heads, device="cpu")
    sd = state_dict_from_flax(v, pm.state_dict())
    pm.load_state_dict(sd)
    prepare_int8(pm, sd)
    px, pte = T(x), T(te)
    p = {}
    with Counting(q8, "int8_conv") as c, pblk.int8_eval(), torch.no_grad():
        p["dynamic"] = pm(px, pte, L, G)
    counts["port dynamic"] = c.n
    scales = pblk.quantize_int8(pm, px, pte, L, G)
    jscales = scales_from_flax_quant(jax.tree_util.tree_map(np.asarray, quant["quant"]), pm)
    set_int8_scales(pm, jscales)
    with Counting(q8, "int8_conv") as c, pblk.int8_eval(static=True), torch.no_grad():
        p["static"] = pm(px, pte, L, G)
    counts["port static"] = c.n
    return dict(jax=j, port=p, counts=counts, scales=scales, jscales=jscales)


def test_tscd_int8_conv_count_matches_jax(tscd):
    c = tscd["counts"]
    assert c["port dynamic"] == c["jax dynamic"] == 12, c
    assert c["port static"] == c["jax static"] == 70, c


def test_tscd_calibration_matches_jax(tscd):
    got, want = tscd["scales"], tscd["jscales"]
    assert set(got) == set(want) and len(want) == 70
    for name, s in want.items():
        assert got[name].shape == s.shape
        assert float((got[name] - s).abs().max()) <= 1e-5 * float(s.abs().max()), name


TSCD_OUTPUTS = ("raw_outputs", "refined_cls_logits", "refined_boxes")


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_tscd_int8_forward_matches_jax(tscd, mode):
    j = tscd["jax"]
    for key in TSCD_OUTPUTS:
        nudged = [np.asarray(n[key]) for n in j["nudged"]] if mode == "static" else []
        _assert_close_int8(tscd["port"][mode][key].numpy(), np.asarray(j[mode][key]),
                           np.asarray(j["fp"][key]), f"{mode} {key}", nudged)


class _Stack(torch.nn.Module):
    """A run of the backbone's blocks (every BaseConv with C_in >= 32)."""

    def __init__(self):
        super().__init__()
        self.seq = torch.nn.Sequential(
            pblk.BaseConv(32, 64, 3, 2), pblk.CSPLayer(64, 64, n=1),
            pblk.BaseConv(64, 128, 3, 2), pblk.SPPBottleneck(128, 128),
            pblk.CSPLayer(128, 128, n=1, shortcut=False))

    def forward(self, x):
        return pblk.run(self.seq, x, None)


def test_calibration_chunked_equals_one_shot():
    """Calibration observes the fp forward, each conv frame by frame: two
    chunks of two frames fold to the one-shot scales of all four, exactly.
    (A run of BaseConvs that all calibrate: an fp conv over the batch
    upstream, such as the Focus stem's plain version on the CPU, would sum
    in a batch-dependent order; on the card the stem is the hand kernel,
    pixel by pixel.)"""
    torch.manual_seed(0)
    pm = _Stack()
    prepare_int8(pm)
    x = T(_x(4, n=4, c=32, hw=32))
    whole = pblk.quantize_int8(pm, x)
    chunked = pblk.quantize_int8_scan(pm, [(x[:2],), (x[2:],)])
    assert set(whole) == set(chunked) and len(whole) == 14
    for name in whole:
        assert torch.equal(whole[name], chunked[name]), name


@pytest.fixture(scope="module")
def yolox():
    """YOLOX at depth 0.33, width 0.25 (as test_yolox_int8_forward_close),
    two 96 px images, seeded JAX weights carried into the port."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 255, (2, 96, 96, 3)).astype(np.float32)
    jm = JYOLOX(num_classes=5, depth=0.33, width=0.25, dtype=jnp.float32)
    jx = jnp.asarray(x)
    v = seeded_variables(jm, 1, jx)
    j = {"fp": jax.jit(lambda v, x: jm.apply(v, x)["decoded"])(v, jx)}
    with jblk.int8_eval():
        j["dynamic"] = jax.jit(lambda v, x: jm.apply(v, x)["decoded"])(v, jx)
    with jblk.int8_eval(calibrate=True):
        quant = jax.jit(lambda v, x: jm.apply(v, x, mutable=["quant"])[1])(v, jx)
    with jblk.int8_eval(static=True):
        static = jax.jit(lambda v, x: jm.apply(v, x)["decoded"])
        j["static"] = static({**v, "quant": quant["quant"]}, jx)
        j["nudged"] = [static({**v, "quant": q}, jx) for q in _nudged(quant["quant"])]
    pm = YOLOX(num_classes=5, depth=0.33, width=0.25, device="cpu")
    sd = state_dict_from_flax(v, pm.state_dict())
    pm.load_state_dict(sd)
    prepare_int8(pm, sd)
    return dict(jax=j, pm=pm, x=T(x), quant=quant["quant"])


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_yolox_int8_forward_matches_jax(yolox, mode):
    pm = yolox["pm"]
    if mode == "static":
        set_int8_scales(pm, scales_from_flax_quant(
            jax.tree_util.tree_map(np.asarray, yolox["quant"]), pm))
    with pblk.int8_eval(static=mode == "static"), torch.no_grad():
        got = pm(yolox["x"])["decoded"].numpy()
    assert np.isfinite(got).all()
    j = yolox["jax"]
    nudged = [np.asarray(n) for n in j["nudged"]] if mode == "static" else []
    _assert_close_int8(got, np.asarray(j[mode]), np.asarray(j["fp"]), mode, nudged)


# -- the CLIs ----------------------------------------------------------------


def _recorded_rows(monkeypatch):
    """Records every window's detection rows that predict functions made
    from now on hand to the evaluator."""
    from tscd_torch.core import predict
    rows = []
    orig = predict.detection_rows

    def record(refined):
        out = orig(refined)
        rows.append(out)
        return out
    monkeypatch.setattr(predict, "detection_rows", record)
    return rows


@pytest.mark.parametrize("calib", [0, 2])
def test_tscd_eval_int8_matches_direct_evaluate(calib, monkeypatch):
    """`tscd_eval --int8` (dynamic) and `--int8-calib 2` (static, the first
    2 val windows) on the selftest fixture give the detections and mAP of
    a direct evaluate of the same model under the same mode; the int8
    detections differ from the fp ones."""
    import random

    from tscd_torch.exp import get_exp
    from tscd_torch.tools import tscd_eval
    opts = ["data_dir", FIXTURE, "val_seq_path", EXP.val_seq_path]
    flags = ["--int8"] if calib == 0 else ["--int8-calib", str(calib)]
    rows = _recorded_rows(monkeypatch)
    cli = tscd_eval.main(["--exp", "selftest", "-c", REF_PTH, "--device", "cpu", "--tnum", "4",
                          *flags, *opts])
    cli_rows, rows[:] = list(rows), []

    exp = get_exp(None, "selftest")
    exp.merge(opts)
    exp.tnum = 4
    random.seed(int(exp.seed))
    np.random.seed(int(exp.seed) & 0xFFFFFFFF)
    model = exp.get_model(device="cpu")
    tscd_eval.load_weights(model, REF_PTH)
    loader = exp.get_eval_loader()
    predict = exp.get_predict_fn(model)
    prepare_int8(model)
    mode = dict()
    if calib:
        F = L + G
        chunks = [(b["imgs"][:F], b["time_embedding"][:F]) for _, b in zip(range(calib), loader)]
        set_int8_scales(model, pblk.quantize_int8_scan(
            model, chunks, fn=lambda i, t: predict.dispatch_eager(i, t, False, None)))
        mode = dict(static=True)
    rows[:] = []
    with pblk.int8_eval(**mode):
        direct = exp.get_evaluator(loader).evaluate(predict)
    assert cli["mAP"] == direct["mAP"] and cli["AP50"] == direct["AP50"]
    assert len(cli_rows) == len(rows) > 0
    for a, b in zip(cli_rows, rows):
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa, fb)
    rows[:] = []
    tscd_eval.main(["--exp", "selftest", "-c", REF_PTH, "--device", "cpu", "--tnum", "4", *opts])
    assert any(not np.array_equal(fa, fb) for a, b in zip(cli_rows, rows) for fa, fb in zip(a, b))


def test_other_clis_take_int8(tmp_path):
    """eval, vid_eval, tscd_demo (dynamic and --int8-calib 2) and demo run
    with --int8 on the CPU."""
    from tscd_torch.tools import demo, tscd_demo, vid_eval
    frames = os.path.join(FIXTURE, "Data", "VID", "val")
    video = os.path.join(frames, sorted(os.listdir(frames))[0])
    opts = ["data_dir", FIXTURE, "val_seq_path", EXP.val_seq_path]
    res = vid_eval.main(["--exp", "selftest", "-c", REF_PTH, "--device", "cpu", "--tnum", "2",
                         "--int8", *opts])
    assert "mAP" in res
    ckpt = os.path.join(REPO, "YOLOX_outputs", "validate_ref", "converted_ckpt.msgpack")
    for flags in (["--int8"], ["--int8-calib", "2"]):
        out = tscd_demo.main(["--exp", "selftest", "-c", ckpt, "--path", video, "--device", "cpu",
                              "--output_dir", str(tmp_path), *flags])
        assert len(out["dets"]) == len(os.listdir(video))
    frame = os.path.join(video, sorted(os.listdir(video))[0])
    (_, drawn, *_), = demo.main(["image", "-n", "ovis_still_selftest", "--path", frame,
                                 "--device", "cpu", "--int8"])
    assert drawn.ndim == 3
    from tscd_torch.exp import get_exp
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.tools import eval as still_eval
    still = tmp_path / "still.pth"
    torch.save(random_init_(get_exp(None, "ovis_still_selftest").get_model(device="cpu"), 0)
               .state_dict(), still)
    res = still_eval.main(["--exp", "ovis_still_selftest", "-c", str(still), "--device", "cpu",
                           "--int8"])
    assert "mAP" in res and "AP50" in res


def test_calib_windows_follow_jax_demos():
    from tscd_torch.tools.tscd_demo import calib_windows
    import random
    crng = random.Random(42)
    want = []
    for lo in range(0, 10, 3):
        li = list(range(lo, min(lo + 3, 10)))
        while len(li) < 3:
            li.append(li[-1])
        pool = [i for i in range(10) if i not in li] or li
        want.append(li + [crng.choice(pool) for _ in range(2)])
    assert calib_windows(3, 2, 10, 2) == want[:2]
    assert calib_windows(0, 4, 10, 5) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 9, 9]]


def test_accuracy_tool_dataset_matches_jax(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_int8_width", os.path.join(REPO, "tools", "measure_int8_accuracy_width.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    from tscd_torch.tools.measure_int8_accuracy_width import make_dataset
    jroot = jtool.make_dataset(str(tmp_path / "jax"), n_imgs=4)
    proot = make_dataset(str(tmp_path / "port"), n_imgs=4)
    for sub in ("train2017", "annotations"):
        names = sorted(os.listdir(os.path.join(jroot, sub)))
        assert names == sorted(os.listdir(os.path.join(proot, sub))) and names
        for n in names:
            a = open(os.path.join(jroot, sub, n), "rb").read()
            b = open(os.path.join(proot, sub, n), "rb").read()
            assert a == b, n
    with open(os.path.join(proot, "annotations", "instances_val2017.json")) as f:
        assert len(json.load(f)["images"]) == 4
