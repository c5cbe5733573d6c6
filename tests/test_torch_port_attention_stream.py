"""The attention's self-attention form and the online MSA's reg-branch
guidance against the JAX package on the CPU, on inputs from numpy seeds:

  - the plain version (the CPU's side of every wrapper call) against
    JAX's `dual_attention_reference`, with some keys invalid and with all
    but one invalid, and with `fg_score` against JAX's XLA path of the
    guided form (aggregation.py:119-132), 1e-5 (fp32 in another order);
    its gradients through the wrapper's autograd rule against jax.grad of
    the same, 1e-5 of each gradient's largest;
  - JAX's DualBranchAttention(cross=False, reg_score_guidance=True), with
    and without the score-window mask, and MSAYolov(reg_score_guidance=
    True) against the port's on converted weights, 1e-4;
  - the route rule and the bytes each route reckons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.models import aggregation as jagg
from tscd_tpu.ops.pallas.fused_attention import dual_attention_reference
from tscd_torch.models import aggregation as pagg
from tscd_torch.ops.kernels import fused_attention as pfa
from tscd_torch.utils.convert import state_dict_from_flax
from torch_port_util import seeded_variables

T = torch.as_tensor


def _inputs(rng, h, q, k, d, valid="random"):
    mk = lambda *s: rng.normal(size=s).astype(np.float32)      # noqa: E731
    qkv = [mk(h, q, d), mk(h, k, d), mk(h, k, d), mk(h, q, d), mk(h, k, d), mk(h, k, d)]
    score, fg = (rng.uniform(0.05, 1.0, k).astype(np.float32) for _ in range(2))
    if valid == "random":
        mask = rng.uniform(size=k) < 0.8
    else:                           # all but one
        mask = np.zeros(k, bool)
        mask[k // 3] = True
    return qkv, score, fg, mask


@jax.jit
def _jax_guided(qc, kc, vc, qr, kr, vr, score, fg, valid):
    """JAX's XLA path of DualBranchAttention with reg_score_guidance and no
    score-window mask (aggregation.py:119-145), per head."""
    qc, kc, qr, kr = map(jagg._l2norm, (qc, kc, qr, kr))
    lc = jnp.einsum("hqd,hkd->hqk", qc, kc) * 25.0 * score[None, None, :]
    lr = jnp.einsum("hqd,hkd->hqk", qr, kr) * 25.0 * fg[None, None, :]
    kmask = jnp.where(valid[None, None, :], 0.0, jagg.NEG)
    attn = 0.5 * (jax.nn.softmax(lc + kmask, -1) + jax.nn.softmax(lr + kmask, -1))
    return (jnp.einsum("hqk,hkd->hqd", attn, vc), jnp.einsum("hqk,hkd->hqd", attn, vr), attn)


def _plain(qkv, score, fg, mask, with_fg):
    return pfa.fused_dual_attention(*(T(a)[None] for a in qkv), T(score)[None],
                                    T(mask)[None], 25.0, T(fg)[None] if with_fg else None)


@pytest.mark.parametrize("valid", ["random", "all but one"])
@pytest.mark.parametrize("with_fg", [False, True])
def test_plain_matches_jax_with_and_without_fg(valid, with_fg):
    qkv, score, fg, mask = _inputs(np.random.default_rng(1), 2, 40, 40, 16, valid)
    got = _plain(qkv, score, fg, mask, with_fg)
    if with_fg:
        want = _jax_guided(*map(jnp.asarray, (*qkv, score, fg, mask)))
    else:
        want = dual_attention_reference(*map(jnp.asarray, (*qkv, score, mask)))
    for name, g, w in zip(("out_cls", "out_reg", "attn"), got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    if valid == "all but one":
        np.testing.assert_allclose(got[2][0, :, :, 40 // 3].numpy(), 1.0, rtol=1e-6)
    if with_fg and valid == "random":     # the guidance moves the attention
        plain = _plain(qkv, score, fg, mask, False)[2]
        assert float((plain - got[2]).abs().max()) > 1e-3


def test_wrapper_gradient_with_fg_matches_jax():
    """JAX's backward rule differentiates its reference; so does the
    port's (`_Differentiable`): the six q/k/v gradients of a random
    cotangent, with fg guidance, 1e-5 of each gradient's largest."""
    rng = np.random.default_rng(2)
    qkv, score, fg, mask = _inputs(rng, 2, 24, 24, 8)
    cot = [rng.normal(size=s).astype(np.float32) for s in ((2, 24, 8), (2, 24, 8), (2, 24, 24))]
    ins = [T(a)[None].requires_grad_(True) for a in qkv]
    outs = pfa.fused_dual_attention(*ins, T(score)[None], T(mask)[None], 25.0, T(fg)[None])
    got = torch.autograd.grad(outs, ins, [T(c)[None] for c in cot])

    def loss(*qkv_):
        o = _jax_guided(*qkv_, jnp.asarray(score), jnp.asarray(fg), jnp.asarray(mask))
        return sum(jnp.sum(a * jnp.asarray(c)) for a, c in zip(o, cot))
    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, qkv))
    for name, g, w in zip(("qc", "kc", "vc", "qr", "kr", "vr"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g[0].numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def _load(pm, variables):
    sd = state_dict_from_flax(variables, pm.state_dict())
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    return pm


@pytest.mark.parametrize("use_mask", [False, True])
def test_dual_branch_attention_reg_score_guidance_matches_jax(use_mask):
    """The online MSA's attention core on N = 40 tokens (8 invalid): every
    piece, 1e-4 of its largest value; the guidance reaches the reg-branch
    outputs (they differ from the unguided port's)."""
    rng = np.random.default_rng(4)
    N, C, h = 40, 32, 2
    x_cls, x_reg = (rng.normal(size=(N, C)).astype(np.float32) for _ in range(2))
    cs, fs = (rng.uniform(0.05, 1.0, N).astype(np.float32) for _ in range(2))
    valid = np.ones(N, bool)
    valid[rng.choice(N, 8, replace=False)] = False
    args = [jnp.asarray(a) for a in (x_cls, x_reg, cs, fs, valid)]
    kw = dict(sim_thresh=0.05, conf_sim_thresh=0.1, use_mask=use_mask)
    jm = jagg.DualBranchAttention(h, cross=False, reg_score_guidance=True)
    variables = seeded_variables(jm, 5, *args, N)
    jout = jax.jit(lambda v: jm.apply(v, *args, N, **kw))(variables)
    pm = _load(pagg.DualBranchAttention(C, h, cross=False, reg_score_guidance=True), variables)
    plain = _load(pagg.DualBranchAttention(C, h, cross=False), variables)
    with torch.no_grad():
        pins = [T(a)[None] for a in (x_cls, x_reg, cs, fs, valid)]
        out = pm.attend(*pins, N, **kw)
        unguided = plain.attend(*pins, N, **kw)
    for name in ("out_cls", "out_reg", "sim_round2", "obj_round2", "v_cls", "v_reg"):
        w = np.asarray(getattr(jout, name))
        np.testing.assert_allclose(getattr(out, name)[0].numpy(), w,
                                   atol=1e-4 * max(1.0, np.abs(w).max()), rtol=1e-4,
                                   err_msg=name)
    assert float((out.out_reg - unguided.out_reg).abs().max()) > 1e-3


def test_msa_yolov_reg_score_guidance_matches_jax():
    rng = np.random.default_rng(6)
    N, C, h = 48, 32, 2
    x_cls, x_reg = (rng.normal(size=(N, C)).astype(np.float32) for _ in range(2))
    cs, fs = (rng.uniform(0.05, 1.0, N).astype(np.float32) for _ in range(2))
    valid = rng.uniform(size=N) < 0.75
    args = [jnp.asarray(a) for a in (x_cls, x_reg, cs, fs, valid)]
    jm = jagg.MSAYolov(4 * C, h, reg_score_guidance=True)
    variables = seeded_variables(jm, 7, *args)
    jout, _ = jax.jit(lambda v: jm.apply(v, *args, sim_thresh=0.05))(variables)
    pm = _load(pagg.MSAYolov(C, 4 * C, h, reg_score_guidance=True), variables)
    with torch.no_grad():
        out, obj = pm(*(T(a) for a in (x_cls, x_reg, cs, fs, valid)), sim_thresh=0.05)
    assert obj is None
    w = np.asarray(jout)
    np.testing.assert_allclose(out.numpy(), w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=1e-4)


def test_route_rule_and_launch_bytes():
    """q <= 128 splits over keys (MCA's q = 50), every larger q streams
    (960, 8000, 16000); each route reckons its own bytes: the stream has
    no scratch, so a launch at q = k = 16000, h 4, d 64 needs the 4.1 GB
    of attn and its outputs, not the split's 41.5 GB."""
    assert [pfa.route(q) for q in (1, 50, 128, 129, 960, 8000, 16000)] == \
        ["split"] * 3 + ["stream"] * 4
    assert pfa.scratch_floats(1, 4, 960, 960, 64) == 0
    assert pfa.launch_bytes(1, 4, 16000, 16000, 64) == 4 * (4 * 16000 ** 2 + 2 * 4 * 16000 * 64)
    assert 4.09e9 < pfa.launch_bytes(1, 4, 16000, 16000, 64) < 4.14e9
    nch = 1600 // pfa.KEY_CHUNK
    assert pfa.scratch_floats(1, 4, 50, 1600, 64) == 4 * 50 * (4 * nch + 4 * nch * 64 + 2 * 1600)


# -- the streaming kernel's arithmetic, modelled on the CPU ------------------
# csrc/fused_attention.cu's streaming route runs both products on the
# tensor cores in the 3xTF32 split and its softmaxes in exp2. The model
# below repeats that arithmetic in fp32 torch: cvt.rna.tf32.f32 by bit
# operations, each product as lo.hi' + hi.lo' + hi.hi' added to fp32
# accumulators k-step by k-step (8 values a step, as mma.m16n8k8), the
# logits as (q.k / |q|) * (25 log2(e) score / |k|) + mask log2(e), each
# row's max and sum of exp2 over key tiles of 32 (pass 1), then attn =
# exp2(l - M) 0.5 / S of both branches and attn @ v (pass 2).

LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as cvt.rna.tf32.f32: 10 mantissa bits, to nearest,
    ties away from zero (half of the dropped 13 bits' weight added to the
    magnitude, then those bits cleared); kept in fp32."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def tf32_product(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b (..., m, k) x (k, n) as the kernel's mma.sync k-steps of 8:
    terms = 3 the split (hi = tf32(x), lo = tf32(x - hi); lo.hi', hi.lo',
    hi.hi' in that order), terms = 1 hi.hi' alone."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        if terms == 3:
            acc = acc + al[..., s] @ bh[s]
            acc = acc + ah[..., s] @ bl[s]
        acc = acc + ah[..., s] @ bh[s]
    return acc


def stream_model(qkv, score, fg, valid, scale=25.0, terms=3, tile=32):
    """The streaming kernel's arithmetic on one batch element: qkv
    (h, n, d) fp32 arrays, score / fg (k,) (fg None: ones), valid (k,)
    bool. Returns out_cls, out_reg (h, q, d) and attn (h, q, k)."""
    qc, kc, vc, qr, kr, vr = (torch.as_tensor(a, dtype=torch.float32) for a in qkv)
    k = kc.shape[1]
    inv = lambda x: 1.0 / torch.linalg.vector_norm(x, dim=-1).clamp(min=1e-12)   # noqa: E731
    neg = torch.where(torch.as_tensor(valid), 0.0, -1e9 * LOG2E).to(torch.float32)
    kscale = torch.tensor(scale * LOG2E, dtype=torch.float32)
    ones = torch.ones(k, dtype=torch.float32)
    factors = [torch.as_tensor(s, dtype=torch.float32) if s is not None else ones
               for s in (score, fg)]
    logits = []
    for (q_, k_), f in zip(((qc, kc), (qr, kr)), factors):
        raw = torch.stack([tf32_product(q_[i], k_[i].T, terms) for i in range(q_.shape[0])])
        kf = inv(k_) * kscale * f
        logits.append((raw * inv(q_)[..., None]) * kf[:, None, :] + neg)
    probs = []
    for l2 in logits:
        m = torch.full(l2.shape[:-1], -torch.inf)
        s = torch.zeros(l2.shape[:-1])
        for k0 in range(0, k, tile):
            lt = l2[..., k0:k0 + tile]
            mn = torch.maximum(m, lt.amax(-1))
            s = s * torch.exp2(m - mn) + torch.exp2(lt - mn[..., None]).sum(-1)
            m = mn
        probs.append((torch.exp2(l2 - m[..., None]), 0.5 / s))
    (ec, hc), (er, hr) = probs
    attn = ec * hc[..., None] + er * hr[..., None]
    outs = [torch.stack([tf32_product(attn[i], v[i], terms) for i in range(attn.shape[0])])
            for v in (vc, vr)]
    return outs[0], outs[1], attn


def test_tf32_rounding_is_cvt_rna():
    """Rounding to 10 mantissa bits: to nearest, ties away from zero, the
    sign kept; exact for values with 10 bits or fewer (bf16's 7)."""
    x = np.array([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11),
                  1.0 + 2 ** -11 - 2 ** -23, 0.0, 3.5], np.float32)
    got = tf32_rna(torch.as_tensor(x)).numpy()
    want = np.array([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10),
                     1.0, 0.0, 3.5], np.float32)
    np.testing.assert_array_equal(got, want)
    bf = torch.as_tensor(np.random.default_rng(9).normal(size=64).astype(np.float32))
    bf = bf.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(tf32_rna(bf), bf)


def _stream_case(d, with_fg):
    rng = np.random.default_rng(40 + d)
    qkv, score, fg, mask = _inputs(rng, 2, 960, 960, d)
    if with_fg:
        want = _jax_guided(*map(jnp.asarray, (*qkv, score, fg, mask)))
    else:
        want = dual_attention_reference(*map(jnp.asarray, (*qkv, score, mask)))
    return qkv, score, fg if with_fg else None, mask, [np.asarray(w) for w in want]


@pytest.mark.parametrize("d,with_fg", [(64, True), (32, False)])
def test_stream_model_3xtf32_matches_jax(d, with_fg):
    """The kernel's arithmetic (3xTF32, exp2, two passes over tiles of 32)
    at q = k = 960, h 2, against JAX's reference at the card check's own
    tolerance (1e-5 absolute, 1e-4 relative)."""
    qkv, score, fg, mask, want = _stream_case(d, with_fg)
    got = stream_model(qkv, score, fg, mask)
    for name, g, w in zip(("out_cls", "out_reg", "attn"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-4, err_msg=name)


def test_stream_model_one_tf32_product_misses_the_tolerance():
    """The same case with one TF32 product (hi.hi' alone) misses that
    tolerance: the split's lo terms are what keep the kernel at fp32's
    accuracy."""
    qkv, score, fg, mask, want = _stream_case(64, True)
    got = stream_model(qkv, score, fg, mask, terms=1)
    assert not all(np.allclose(g.numpy(), w, atol=1e-5, rtol=1e-4) for g, w in zip(got, want))


def test_stream_plan_rule():
    """The streaming route's block (the CUDA source's rule, which the
    card's launch grid shows): 32 rows x 4 key slices at YOLOV-L's q = 960
    (120 blocks of 8 warps on an H100's 132 SMs), 128 x 1 at OVIS YOLOV++'s
    8000 and 16000, 32 past a head dim of 64; never more than 8 warps."""
    sms = 132
    assert pfa.stream_plan(1, 4, 960, 64, sms) == (32, 4)
    assert pfa.stream_plan(1, 4, 129, 64, sms) == (16, 4)
    assert pfa.stream_plan(1, 4, 8000, 32, sms) == (128, 1)
    assert pfa.stream_plan(1, 4, 16000, 64, sms) == (128, 1)
    assert pfa.stream_plan(1, 4, 16000, 128, sms) == (32, 4)
    assert pfa.stream_plan(2, 4, 960, 64, sms) == (64, 2)       # 15 x 8 blocks
    assert pfa.stream_plan(1, 4, 3000, 64, sms) == (64, 2)      # 47 x 4 blocks
    for q in (129, 300, 1000, 4000):
        for d in (8, 64, 100, 128):
            rows, kw = pfa.stream_plan(1, 2, q, d, sms)
            assert rows in (16, 32, 64, 128) and (rows <= 32 or d <= 64)
            assert rows // 16 * kw in (4, 8) and 4 % kw == 0
