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
