"""The port's bf16 compute path and BN folding against the JAX package on
the CPU, at the selftest configuration (depth 0.33, width 0.125, P = 6,
1 local + 3 global frames, 128 px), the JAX modules built with
dtype=bfloat16 and jitted (XLA's roundings under jit are what JAX runs).

Tolerances, each with its reason:
  - per module, the same bf16 inputs on both sides: within 2 bf16 ulps of
    the output's scale (max |JAX output|), since the two round at other
    places (XLA keeps some intermediates in fp32 under jit);
  - the stem's plain version against the Pallas kernel (interpret mode):
    2 bf16 ulps of the output's scale (the products are exact, the sums
    differ in order, the result is rounded to bf16);
  - the attention's plain version against the Pallas kernel on the same
    bf16 q/k/v, and the matcher's cost: both compute in fp32 from the
    same bf16 values, 1e-5 and 1e-6;
  - discrete decisions (top-k with bf16 ties, Hungarian, NMS), fed the
    JAX stage's own inputs: exact;
  - the whole dense forward: the bf16 port no farther from the bf16 JAX
    model than the bf16 JAX model is from the fp32 JAX model (max abs
    over raw_outputs); the BN-folded bf16 port likewise against the JAX
    model with folded parameters (`fuse_conv_bn_params`,
    `fused_batch_stats`), since folding moves the bf16 roundings;
  - BN folding: the state-dict fold equals `fuse_conv_bn_params` within
    1e-6; a folded fp32 port forward equals the unfolded JAX forward
    within 1e-4 (fp32, another summation order).

The port's attention follows the Pallas kernel, which normalises q and k
in fp32; the JAX model on the CPU takes its unfused branch, which
normalises them in bf16, so the refined (aggregated) outputs of the two
bf16 models are compared stage by stage here, not end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tscd_tpu.models import blocks as jblk
from tscd_tpu.models import matching as jmat
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.models.tscd import tscd_eval_postprocess as jpost
from tscd_tpu.models.tscd_head import select_frame_proposals as jselect
from tscd_tpu.ops.hungarian import masked_linear_sum_assignment as jlsa
from tscd_tpu.ops.pallas import focus_stem as jfs
from tscd_tpu.ops.pallas import fused_attention as jfa
from tscd_tpu.utils.model_utils import fuse_conv_bn_params, fused_batch_stats
from tscd_torch.core.predict import make_predict_fn
from tscd_torch.exp.tscd_large import selftest_exp
from tscd_torch.models import blocks as pblk
from tscd_torch.models import matching as pmat
from tscd_torch.models.tscd import TSCD, random_init_, tscd_eval_postprocess
from tscd_torch.models.tscd_head import FrameProposals, select_frame_proposals
from tscd_torch.ops.hungarian import masked_linear_sum_assignment
from tscd_torch.ops.kernels import focus_stem as pfs
from tscd_torch.ops.kernels import fused_attention as pfa
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.utils.convert import flax_module_path, state_dict_from_flax
from tscd_torch.utils.model_utils import fuse_conv_bn_state_dict, fuse_model
from torch_port_util import carry, perturb

EXP = selftest_exp()
L, G = EXP.lframe_val, EXP.gframe_val
P, C = EXP.num_proposals, EXP.num_classes
BF = torch.bfloat16
T = torch.from_numpy


def bf16_values(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, as fp32."""
    return T(np.ascontiguousarray(a, np.float32)).to(BF).float().numpy()


def ulp(scale: float) -> float:
    """One bf16 ulp at magnitude `scale`."""
    return float(2.0 ** (np.floor(np.log2(scale)) - 7))


def within_ulps(got, want, n=2, msg=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= n * ulp(scale), f"{msg}: {err} > {n} bf16 ulps at {scale}"


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


# -- per module ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["BaseConv", "CSPLayer"])
def test_conv_blocks_at_bf16(kind):
    x = bf16_values(np.random.default_rng(1).normal(size=(2, 8, 16, 16)))
    if kind == "BaseConv":
        jm = jblk.BaseConv(16, 3, 2, dtype=jnp.bfloat16)
        pm = pblk.BaseConv(8, 16, 3, 2, dtype=BF).eval()
    else:
        jm = jblk.CSPLayer(16, n=1, dtype=jnp.bfloat16)
        pm = pblk.CSPLayer(8, 16, n=1, dtype=BF).eval()
    xj = jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16)
    variables = carry(jm, pm, xj)
    assert all(m.weight.dtype == BF for m in pm.modules()
               if isinstance(m, torch.nn.Conv2d))
    want = jax.jit(jm.apply)(variables, xj)
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = pm(T(x).to(BF))
    assert got.dtype == BF
    within_ulps(_f32(got).transpose(0, 2, 3, 1), _f32(want), msg=kind)


def _stem_inputs(rng, F=2, H=128, W=128, O=8):
    x = rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8)
    w3 = rng.normal(0, 0.1, (O, 12, 3, 3)).astype(np.float32)        # OIHW
    scale = rng.uniform(0.5, 1.5, O).astype(np.float32)
    shift = rng.normal(0, 0.5, O).astype(np.float32)
    return x, w3, scale, shift


def test_stem_bf16_plain_matches_pallas_kernel():
    x, w3, scale, shift = _stem_inputs(np.random.default_rng(2))
    want = jfs._focus_stem_impl(jnp.asarray(x, jnp.float32),
                                jnp.asarray(w3.transpose(2, 3, 1, 0)),
                                jnp.asarray(scale), jnp.asarray(shift),
                                jnp.bfloat16, interpret=True)
    got = pfs.focus_stem(T(x), T(w3), T(scale), T(shift), out_dtype=BF)
    assert got.dtype == BF and got.shape == (2, 8, 64, 64) and got.is_contiguous()
    within_ulps(_f32(got).transpose(0, 2, 3, 1), _f32(want), msg="stem")
    # fp32 frames are rounded to bf16 as they are read: integer pixels
    # give the uint8 result bit for bit
    again = pfs.focus_stem(T(x.astype(np.float32)), T(w3), T(scale), T(shift),
                           out_dtype=BF)
    assert torch.equal(got, again)


# -- the bf16 stem kernel's index maps, on the CPU -------------------------
# focus_stem_mma (tscd_torch/csrc/focus_stem.cu) computes D = W . X on the
# tensor cores: W the (channel, k) matrix of `weight_fragments`, X the
# taps of each output pixel read straight from the staged halo, and 1 at
# k = 108..110, where W holds the shift's three bf16 parts. A CUDA kernel
# cannot run here, so its index maps are held to the plain version and to
# JAX in numpy: the K order (tap k = (6 ky + kx) 3 + c is element
# 6j + k mod 18 of padded row 2i + ky), the fragment layout of the weights
# (decoded with mma.sync.m16n8k16's register map) and, lane by lane, the
# kernel's halo offsets and pixel order.

STEM_SHAPES = [  # F, H, W, O, border
    (2, 32, 64, 64, True),     # W/2 = 32: the Pallas kernel's strips
    (1, 18, 70, 8, True),      # W/2 = 35 odd, O = 8 (the selftest's width)
    (2, 20, 38, 64, False),    # W/2 = 19 odd
    (1, 2, 34, 24, False),     # H/2 = 1, O = 24
]


def _stem_case(F, H, W, O, border, seed=21):
    rng = np.random.default_rng(seed)
    x, w3, scale, shift = _stem_inputs(rng, F, H, W, O)
    if border:
        for edge in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
            x[edge] = 255
    return x, w3, scale, shift


def _decode_weights(frags: np.ndarray) -> np.ndarray:
    """(O_pad, 112) from the A fragments, by mma.sync.m16n8k16's map:
    lane 4 gid + tid, register r = rh + 2 kh holds row gid + 8 rh at
    columns 2 tid + 8 kh (low half) and + 1 (high half)."""
    chunks = frags.shape[0]
    wm = np.zeros((chunks * pfs.CHUNK, pfs.MMA_K), np.float32)
    for c, s, mt, lane, r, half in np.ndindex(*frags.shape):
        gid, tid, rh, kh = lane // 4, lane % 4, r % 2, r // 2
        wm[32 * c + 16 * mt + gid + 8 * rh, 16 * s + 8 * kh + 2 * tid + half] = \
            frags[c, s, mt, lane, r, half]
    return wm


def _padded_frames(x: np.ndarray) -> np.ndarray:
    """(F, H + 4, 3 (W + 4)) bf16 values: rows and columns -2, -1, H, H+1 zero."""
    F, H, W, _ = x.shape
    xp = np.zeros((F, H + 4, W + 4, 3), np.float32)
    xp[:, 2:-2, 2:-2] = bf16_values(x.astype(np.float32))
    return xp.reshape(F, H + 4, 3 * (W + 4))


def _silu_bf16(y: np.ndarray) -> torch.Tensor:
    return torch.nn.functional.silu(T(y)).to(BF)


def _stem_im2col(x, w3, scale, shift):
    """The plain im2col GEMM of the bf16 kernel: X[f, i, j, k] is element
    6j + k mod 18 of padded row 2i + k // 18 for k < 108, then 1, 1, 1, 0;
    W from `weight_fragments`, K = 112. (F, O, H/2, W/2) bf16."""
    F, H, W, _ = x.shape
    O = w3.shape[0]
    xp = _padded_frames(x)
    i = np.arange(H // 2)[:, None, None]
    j = np.arange(W // 2)[None, :, None]
    k = np.arange(pfs.TAPS)[None, None, :]
    X = np.zeros((F, H // 2, W // 2, pfs.MMA_K), np.float32)
    X[..., :pfs.TAPS] = xp[:, 2 * i + k // 18, 6 * j + k % 18]
    X[..., pfs.TAPS:pfs.TAPS + 3] = 1.0
    wm = _decode_weights(pfs.weight_fragments(T(w3), T(scale), T(shift)).float().numpy())
    y = np.einsum("fijk,ok->foij", X, wm[:O])
    return _silu_bf16(y.astype(np.float32))


def _stem_lane_mirror(x, w3, scale, shift):
    """focus_stem_mma's data movement, lane by lane: tiles of 4 output rows
    x up to 288 pixels, the halo of 12 rows of 6 cw + 18 elements, items of
    32 channels x 32 pixels; each lane's X registers loaded at the kernel's
    offsets, the fragments multiplied as mma.sync multiplies them, and each
    accumulator stored to the pixel the kernel stores it to."""
    F, H, W, _ = x.shape
    O, H2, W2 = w3.shape[0], H // 2, W // 2
    frags = pfs.weight_fragments(T(w3), T(scale), T(shift)).float().numpy()
    chunks = frags.shape[0]
    groups = min(-(-W2 // 32), 9)
    cw = 32 * groups
    rs = 6 * cw + 18
    assert rs % 64 == 18
    rows = bf16_values(x.astype(np.float32)).reshape(F, H, 3 * W)
    lane = np.arange(32)
    gid, tid = lane // 4, lane % 4
    lane_px = 8 * (gid // 2) + gid % 2
    # element offsets of each lane's registers (s, h): ky * rs + t; at
    # k = 108..111 the registers hold 1, 1, 1, 0 (the shift's taps)
    k = 16 * np.arange(7)[:, None, None] + 8 * np.arange(2)[None, :, None] + 2 * tid
    offs = np.where(k < pfs.TAPS, (k // 18) * rs + k % 18, 0)            # (7, 2, 32)
    pad = k >= pfs.TAPS
    ones = np.stack([np.ones(32), (tid == 2).astype(float)])              # (half, lane)
    y = np.full((F, chunks * pfs.CHUNK, H2, W2), np.nan, np.float32)
    for f, i0, j0 in np.ndindex(F, -(-H2 // 4), -(-W2 // cw)):
        i0, j0 = 4 * i0, j0 * cw
        halo = np.zeros((12, rs), np.float32)
        for r in range(12):
            iy = 2 * i0 - 2 + r
            if 0 <= iy < H:
                e = 6 * j0 - 6 + np.arange(rs)
                ok = (e >= 0) & (e < 3 * W)
                halo[r, ok] = rows[f, iy, e[ok]]
        flat = halo.reshape(-1)
        for lr, grp, chunk in np.ndindex(4, groups, chunks):
            i, jg = i0 + lr, j0 + 32 * grp
            if i >= H2 or jg >= W2:
                continue
            acc = np.zeros((2, 4, 16, 8), np.float32)      # [mt][q] D, 16 x 8
            for s, q in np.ndindex(7, 4):
                base = 2 * lr * rs + 6 * (32 * grp + lane_px + 2 * q)
                B = np.zeros((16, 8), np.float32)
                for h in range(2):
                    at = base + offs[s, h]
                    for e in range(2):
                        val = np.where(pad[s, h], ones[e], flat[np.minimum(at + e, flat.size - 1)])
                        B[2 * tid + 8 * h + e, gid] = val
                for mt in range(2):
                    A = np.zeros((16, 16), np.float32)
                    for r, e in np.ndindex(4, 2):
                        A[gid + 8 * (r % 2), 2 * tid + 8 * (r // 2) + e] = \
                            frags[chunk, s, mt, :, r, e]
                    acc[mt, q] += A @ B
            for mt, q, n in np.ndindex(2, 4, 8):
                px = jg + 8 * (n // 2) + 2 * q + n % 2
                if px < W2:
                    o = chunk * 32 + 16 * mt + np.arange(16)
                    y[f, o, i, px] = acc[mt, q, :, n]
    y = y[:, :O]
    assert not np.isnan(y).any(), "an output the kernel never writes"
    return _silu_bf16(y)


def _stem_want(x, w3, scale, shift):
    return pfs.focus_stem_plain(T(x), T(w3), T(scale), T(shift), BF)


def _stem_jax(x, w3, scale, shift):
    """JAX's bf16 stem, NHWC: the Pallas kernel (interpret mode) where its
    strips fit (W/2 % 16 == 0), else its oracle `_xla_reference`."""
    args = (jnp.asarray(x, jnp.float32), jnp.asarray(w3.transpose(2, 3, 1, 0)),
            jnp.asarray(scale), jnp.asarray(shift), jnp.bfloat16)
    if (x.shape[2] // 2) % jfs.TJ == 0:
        return jfs._focus_stem_impl(*args, interpret=True)
    return jfs._xla_reference(*args, compute_dtype=jnp.bfloat16)


def _bf16_close(got, want, n, msg):
    within_ulps(_f32(got), _f32(want), n=n, msg=msg)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=2.0 ** -7)


@pytest.mark.parametrize("F,H,W,O,border", STEM_SHAPES)
def test_stem_im2col_k_order_matches_plain_and_jax(F, H, W, O, border):
    x, w3, scale, shift = _stem_case(F, H, W, O, border)
    got = _stem_im2col(x, w3, scale, shift)
    _bf16_close(got, _stem_want(x, w3, scale, shift), 1, "im2col vs plain")
    want = _stem_jax(x, w3, scale, shift)
    within_ulps(_f32(got).transpose(0, 2, 3, 1), _f32(want), n=2, msg="im2col vs JAX")


def test_weight_fragments_layout():
    """The decoded matrix is the bf16-rounded folded kernel in (ky, kx, c)
    order, then the shift's three bf16 parts, which sum to it exactly in
    fp32, and zeros: at k = 111 and in the channels padded to 32."""
    x, w3, scale, shift = _stem_case(1, 4, 4, 24, False)
    shift = shift * np.float32(np.pi)          # more significant bits than bf16 holds
    frags = pfs.weight_fragments(T(w3), T(scale), T(shift))
    assert frags.dtype == BF and frags.shape == (1, 7, 2, 32, 4, 2) and frags.is_contiguous()
    wm = _decode_weights(frags.float().numpy())
    w6 = pfs.rearrange_weight(T(w3), T(scale)).to(BF).float().numpy()
    np.testing.assert_array_equal(wm[:24, :108], w6.transpose(0, 2, 3, 1).reshape(24, 108))
    parts = wm[:24, 108:111]
    assert (parts[:, 0] != shift).any()
    np.testing.assert_array_equal((parts[:, 0] + parts[:, 1]) + parts[:, 2], shift)
    assert not wm[24:].any() and not wm[:, 111].any()


@pytest.mark.parametrize("F,H,W,O,border", STEM_SHAPES + [
    (1, 4, 600, 8, True)])         # W/2 = 300: two column tiles
def test_stem_mma_lane_mirror_matches_plain(F, H, W, O, border):
    x, w3, scale, shift = _stem_case(F, H, W, O, border)
    got = _stem_lane_mirror(x, w3, scale, shift)
    assert got.shape == (F, O, H // 2, W // 2)
    _bf16_close(got, _stem_want(x, w3, scale, shift), 1, "lane mirror vs plain")


def test_focus_module_at_bf16_reads_uint8_frames():
    """The bf16 backbone hands the stem its uint8 frames (no cast), and
    the Focus module's fp32 weights fold as the kernel expects."""
    rng = np.random.default_rng(3)
    x, w3, gamma, beta = _stem_inputs(rng, F=1, H=64, W=64)
    mod = pblk.Focus(3, 8, dtype=BF).eval()
    with torch.no_grad():
        mod.conv.conv.weight.copy_(T(w3))
        mod.conv.bn.weight.copy_(T(gamma))
        mod.conv.bn.bias.copy_(T(beta))
    assert mod.conv.conv.weight.dtype == torch.float32
    s = gamma / np.sqrt(1 + 1e-5)
    with torch.no_grad():
        got = mod(T(x))
    want = pfs.focus_stem_plain(T(x), T(w3), T(s), T(beta), BF)
    assert torch.equal(got, want)


def test_attention_plain_on_bf16_matches_pallas_kernel():
    rng = np.random.default_rng(4)
    h, q, k, d = 4, 6, 24, 8
    qkv = [bf16_values(rng.normal(size=s)) for s in
           [(h, q, d), (h, k, d), (h, k, d), (h, q, d), (h, k, d), (h, k, d)]]
    score = rng.uniform(0, 1, k).astype(np.float32)
    valid = rng.uniform(size=k) > 0.25
    want = jfa.fused_dual_attention(*(jnp.asarray(a, jnp.bfloat16) for a in qkv),
                                    jnp.asarray(score), jnp.asarray(valid),
                                    interpret=True)
    got = pfa.fused_dual_attention(*(T(a).to(BF)[None] for a in qkv),
                                   T(score)[None], T(valid)[None])
    for g, w, name in zip(got, want, ("out_cls", "out_reg", "attn")):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_match_cost_at_bf16():
    """bf16 embeddings normalised as the jitted JAX function rounds them;
    the products are exact in fp32, so only the summation order differs."""
    rng = np.random.default_rng(5)
    embs = [bf16_values(rng.normal(size=(P, 128))) for _ in range(4)]
    want = jax.jit(jmat.dual_match_cost)(*(jnp.asarray(a, jnp.bfloat16) for a in embs))
    got = pmat.dual_match_cost(*(T(a).to(BF) for a in embs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_task_aligned_at_bf16():
    rng = np.random.default_rng(6)
    reg, obj = (bf16_values(rng.normal(size=(2, P, 128))) for _ in range(2))
    valid = rng.uniform(size=(2, P)) < 0.7
    jm = jmat.TaskAligned(8, 1, dtype=jnp.bfloat16)
    pm = pmat.TaskAligned(128, 8, 1, dtype=BF)
    jins = (jnp.asarray(reg, jnp.bfloat16), jnp.asarray(obj, jnp.bfloat16),
            jnp.asarray(valid))
    variables = carry(jm, pm, *jins)
    want = jax.jit(jm.apply)(variables, *jins)
    with torch.no_grad():
        got = pm(T(reg).to(BF), T(obj).to(BF), T(valid))
    assert got.dtype == BF
    within_ulps(_f32(got), _f32(want), msg="TaskAligned")


# -- the whole model ----------------------------------------------------


def _jax_model(dtype):
    return JTSCD(num_classes=C, depth=EXP.depth, width=EXP.width,
                 num_proposals=P, minimal_limit=EXP.minimal_limit,
                 heads=EXP.heads, dtype=dtype)


def _port(dtype):
    return TSCD(num_classes=C, depth=EXP.depth, width=EXP.width,
                num_proposals=P, minimal_limit=EXP.minimal_limit,
                heads=EXP.heads, device="cpu", dtype=dtype)


def _window(seed=11):
    rng = np.random.default_rng(seed)
    H, W = EXP.test_size
    return (rng.integers(0, 256, (L + G, H, W, 3), dtype=np.uint8),
            get_timing_signal_1d(np.arange(L + G)))


@pytest.fixture(scope="module")
def models():
    """JAX variables (random BN statistics and affines), the jitted JAX
    forward at fp32 and bf16 on one window from a fresh state (and the
    dense part of the folded bf16 model), and the port at fp32, bf16 and
    bf16 folded, on the same weights."""
    x, te = _window()
    jx, jte = jnp.asarray(x), jnp.asarray(te)
    j32 = _jax_model(jnp.float32)
    init = jax.jit(lambda key: j32.init(key, jx, jte, L, G, False))
    variables = perturb(init(jax.random.PRNGKey(0)))
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jm = _jax_model(dt)
        st = jmat.init_matcher_state(P, int(256 * EXP.width),
                                     4 * int(256 * EXP.width), dtype=dt)
        out[name] = jax.jit(lambda v, x, te, s, jm=jm: jm.apply(
            v, x, te, L, G, False, s))(variables, jx, jte, st)
    fused = {"params": fuse_conv_bn_params(variables["params"], variables["batch_stats"]),
             "batch_stats": fused_batch_stats(variables["batch_stats"])}
    jm = _jax_model(jnp.bfloat16)
    out["bf16 folded"] = jax.jit(lambda v, x, te, jm=jm: jm.apply(
        v, x, te, L, G, False, stage="dense"))(fused, jx, jte)
    p32 = _port(torch.float32)
    sd32 = state_dict_from_flax(variables, p32.state_dict())
    p32.load_state_dict(sd32)
    pb = _port(BF)
    pb.load_state_dict(state_dict_from_flax(variables, pb.state_dict()))
    pbf = fuse_model(_port(BF), sd32)
    return dict(variables=variables, jax=out, sd32=sd32, p32=p32, pb=pb,
                pbf=pbf, x=x, te=te)


def _run(port, x, te):
    return port(T(x), T(te), L, G)


@pytest.mark.parametrize("port,ref", [("pb", "bf16"), ("pbf", "bf16 folded")])
def test_dense_forward_within_jax_bf16_distance(models, port, ref):
    jb = _f32(models["jax"][ref]["raw_outputs"])
    jf = _f32(models["jax"]["f32"]["raw_outputs"])
    bound = float(np.abs(jb - jf).max())
    assert bound > 0
    raw = _run(models[port], models["x"], models["te"])["raw_outputs"]
    assert raw.dtype == BF
    d = float(np.abs(_f32(raw) - jb).max())
    assert d <= bound, f"{port}: {d} > {bound} (JAX {ref} vs fp32)"


@pytest.mark.parametrize("port,ref", [("pb", "bf16"), ("pbf", "bf16 folded")])
def test_bf16_distance_from_fp32_like_jax(models, port, ref):
    """The bf16 port's distance from the fp32 port, and its distance from
    JAX's bf16 model, within chip_smoke.BF16_SPREAD times JAX's own bf16
    to fp32 distance (max and p99.9 over raw_outputs): the spread of two
    bf16 models that chip_smoke.py allows the card's bf16 model around
    the CPU port's. Prints the readings (pytest -s)."""
    import chip_smoke
    jf = _f32(models["jax"]["f32"]["raw_outputs"])
    jb = _f32(models["jax"][ref]["raw_outputs"])
    pf = _f32(_run(models["p32"], models["x"], models["te"])["raw_outputs"])
    pb = _f32(_run(models[port], models["x"], models["te"])["raw_outputs"])
    d = {"jax_bf16_vs_fp32": chip_smoke.distance(jb, jf),
         "port_bf16_vs_fp32": chip_smoke.distance(pb, pf),
         "port_vs_jax_bf16": chip_smoke.distance(pb, jb)}
    print(port, d)
    for pair in ("port_bf16_vs_fp32", "port_vs_jax_bf16"):
        for k, v in d[pair].items():
            assert v <= chip_smoke.BF16_SPREAD * d["jax_bf16_vs_fp32"][k], (pair, k, d)


def test_topk_ranks_bf16_ties_like_jax(models):
    """Proposal selection on the JAX bf16 model's own decoded outputs,
    whose fp32 scores come from bf16 raw outputs and tie often."""
    decoded = np.array(models["jax"]["bf16"]["decoded"])
    score = decoded[..., 4] * decoded[..., 5:5 + C].max(-1)
    ties = sum(len(s) - len(np.unique(s)) for s in score)
    assert ties > 0
    want = jselect(jnp.asarray(decoded), C, P, EXP.test_conf, 0.75, False,
                   EXP.minimal_limit)
    got = select_frame_proposals(T(decoded), C, P, EXP.test_conf, EXP.minimal_limit)
    assert np.array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("n", [6, 50])
def test_hungarian_on_jax_bf16_costs(n):
    rng = np.random.default_rng(7 + n)
    embs = [jnp.asarray(rng.normal(size=(n, 128)), jnp.bfloat16) for _ in range(4)]
    cost = np.array(jax.jit(jmat.dual_match_cost)(*embs))
    for rv, cv in ((rng.uniform(size=n) > 0.3, rng.uniform(size=n) > 0.3),
                   (np.zeros(n, bool), np.ones(n, bool))):
        want = jax.jit(jlsa)(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv))
        got = masked_linear_sum_assignment(T(cost), T(rv), T(cv))
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_postprocess_on_jax_bf16_head_outputs(models):
    """NMS and the final postprocess fed the JAX bf16 head's outputs."""
    jout = models["jax"]["bf16"]
    jp = jout["proposals"]
    head = {k: T(_f32(jout[k])).to(BF)
            for k in ("refined_cls_logits", "matcher_obj_logits")}
    head["refined_boxes"] = T(np.array(jout["refined_boxes"]))
    head["proposals"] = FrameProposals(*(T(np.array(a)) for a in jp))
    for (pd, jd), name in zip(zip(tscd_eval_postprocess(head, L, C, EXP.nmsthre,
                                                        EXP.test_conf),
                                  jpost(jout, L, C, EXP.nmsthre, EXP.test_conf)),
                              ("refined", "original")):
        assert np.array_equal(pd.mask.numpy(), np.asarray(jd.mask)), name
        assert int(pd.mask.sum()) > 0, name
        for f in pd._fields:
            a, b = getattr(pd, f).numpy(), np.asarray(getattr(jd, f))
            m = pd.mask.numpy()
            assert np.array_equal(a[m], b[m]), (name, f)


# -- BN folding ---------------------------------------------------------


def test_state_dict_fold_equals_jax_fold(models):
    variables = models["variables"]
    folded = traverse_util.flatten_dict(fuse_conv_bn_params(
        variables["params"], variables["batch_stats"]))
    got = fuse_conv_bn_state_dict(models["sd32"])
    n = 0
    for name, t in got.items():
        path = flax_module_path(name)
        if name.endswith(".conv.bias") and path[-1] == "conv":
            want = folded[path[:-1] + ("bn", "bias")]
            assert not any(k.startswith(name[:-len("conv.bias")] + "bn.") for k in got)
        elif name.endswith(".conv.weight") and name[:-len("weight")] + "bias" in got:
            want = np.asarray(folded[path + ("kernel",)]).transpose(3, 2, 0, 1)
        else:
            continue
        np.testing.assert_allclose(t.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
        n += 1
    n_bn = sum(1 for k in models["sd32"] if k.endswith(".bn.running_mean"))
    assert n == 2 * n_bn > 0


def test_folded_fp32_forward_equals_unfolded_jax(models):
    port = _port(torch.float32)
    port.load_state_dict(models["sd32"])
    assert fuse_model(port) is port
    assert all(m.bn is None for m in port.modules() if isinstance(m, pblk.BaseConv))
    out = _run(port, models["x"], models["te"])
    want = models["jax"]["f32"]
    for key in ("raw_outputs", "refined_cls_logits", "matcher_obj_logits",
                "refined_boxes"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)


def test_fuse_model_folds_fp32_then_casts(models):
    pbf = models["pbf"]
    folded = fuse_conv_bn_state_dict(models["sd32"])
    sd = pbf.state_dict()
    assert set(sd) == set(folded)
    for name, t in sd.items():
        assert torch.equal(t, folded[name].to(t.dtype)), name
    assert pbf.backbone.backbone.dark2[0].conv.weight.dtype == BF
    assert pbf.backbone.backbone.stem.conv.conv.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="fp32"):
        fuse_model(_port(BF))


def test_bf16_model_starts_a_bf16_bank():
    """The fresh bank takes the model's compute dtype (JAX reads
    model.dtype): the bf16 model's first parameter, the stem's, is fp32."""
    model = random_init_(_port(BF), 0)
    assert next(model.parameters()).dtype == torch.float32
    seen = []
    forward = model.head.forward

    def spy(*a, matcher_state=None, **kw):
        seen.append(matcher_state)
        return forward(*a, matcher_state=matcher_state, **kw)

    model.head.forward = spy
    predict = make_predict_fn(model, L, G, EXP.nmsthre, EXP.test_conf)
    x, te = _window(12)
    dets, state = predict(x, te, False, None)
    carried, _ = predict(x, te, True, state)
    for st in (seen[0], state):
        assert all(t.dtype == BF for t in st if t.dtype != torch.bool)
    assert not bool(seen[0].has_state) and bool(state.has_state)
    assert dets[0].shape[1] == 7 and np.isfinite(carried[0]).all()
