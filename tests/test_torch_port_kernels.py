"""The port's three kernel modules against the JAX package on the CPU.

Each wrapper takes its plain PyTorch version for a CPU tensor; these
tests hold the plain versions against the Pallas kernels (interpret mode)
and the JAX references, hold a numpy mirror of the CUDA attention's
split-over-keys arithmetic against the JAX reference, and check that CPU
calls never count a launch.
tests/test_torch_port_cuda.py holds each CUDA kernel against its plain
version on a card.

Tolerances: fp32 on both sides with another summation order, so about
1e-5 absolute on unit-scale values and 1e-4 relative on the stem's
pixel-scale sums; discrete outputs (col4row) are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.models.blocks import _FocusConv
from tscd_tpu.ops import hungarian as jhu
from tscd_tpu.ops.pallas import focus_stem as jfs
from tscd_tpu.ops.pallas.fused_attention import (dual_attention_reference,
                                                 fused_dual_attention as jfused)
from tscd_tpu.ops.pallas.hungarian import linear_sum_assignment_pallas
from tscd_torch.models.darknet import CSPDarknet
from tscd_torch.ops import hungarian as phu
from tscd_torch.ops.kernels import focus_stem as pfs
from tscd_torch.ops.kernels import fused_attention as pfa
from tscd_torch.ops.kernels import hungarian as pkh


def _attn_inputs(rng, B, h, q, k, d, p_valid=0.8):
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return (mk(B, h, q, d), mk(B, h, k, d), mk(B, h, k, d), mk(B, h, q, d),
            mk(B, h, k, d), mk(B, h, k, d),
            rng.uniform(0, 1, (B, k)).astype(np.float32),
            rng.uniform(size=(B, k)) < p_valid)


@pytest.mark.parametrize("B,h,q,k,d,p_valid", [
    (2, 2, 8, 48, 16, 0.8), (1, 4, 50, 200, 64, 0.8), (2, 2, 8, 32, 16, 0.0)])
def test_attention_plain_matches_pallas_and_reference(B, h, q, k, d, p_valid):
    ins = _attn_inputs(np.random.default_rng(0), B, h, q, k, d, p_valid)
    got = pfa.fused_dual_attention(*map(torch.from_numpy, ins))
    for g in got:
        assert torch.isfinite(g).all()
    for b in range(B):
        per = [jnp.asarray(a[b]) for a in ins]
        ref = dual_attention_reference(*per)
        pal = jfused(*per, interpret=True)
        for name, g, r, p in zip(("out_cls", "out_reg", "attn"), got, ref, pal):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r),
                                       atol=1e-5, rtol=1e-5, err_msg=name)
            if p_valid == 0.0:
                # with every key invalid the Pallas kernel's lane padding
                # (k -> 128) carries the same -1e9 as the real keys and
                # takes softmax mass, so it departs from the reference;
                # the port follows the reference and both stay finite
                assert np.isfinite(np.asarray(p)).all()
                continue
            np.testing.assert_allclose(g[b].numpy(), np.asarray(p),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


def _split_combine_mirror(qc, kc, vc, qr, kr, vr, score, valid, scale=25.0):
    """numpy mirror of the CUDA kernel's arithmetic for one batch element:
    per chunk of KEY_CHUNK keys the max m and sum s of p = exp(l - m) of
    both softmaxes and the four chunk-local products p@v, then the
    combine's global rescale by f = exp(m - M) / S, chunk by chunk."""
    f32 = np.float32
    l2n = lambda x: x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), f32(1e-12))
    neg = np.where(valid, f32(0), f32(-1e9))
    lc = np.einsum("hqd,hkd->hqk", l2n(qc), l2n(kc)) * f32(scale) * score + neg
    lr = np.einsum("hqd,hkd->hqk", l2n(qr), l2n(kr)) * f32(scale) + neg
    chunks = []
    for k0 in range(0, kc.shape[1], pfa.KEY_CHUNK):
        ks = slice(k0, k0 + pfa.KEY_CHUNK)
        ms, ss, ps = [], [], []
        for logits in (lc[..., ks], lr[..., ks]):
            m = logits.max(-1, keepdims=True)
            p = np.exp(logits - m)
            ms.append(m), ss.append(p.sum(-1, keepdims=True)), ps.append(p)
        prods = [p @ v[:, ks] for v in (vc, vr) for p in ps]
        chunks.append((ms, ss, ps, prods))
    f = []
    for br in range(2):
        M = np.maximum.reduce([c[0][br] for c in chunks])
        S = sum(c[1][br] * np.exp(c[0][br] - M) for c in chunks)
        f.append([np.exp(c[0][br] - M) / S for c in chunks])
    attn = np.concatenate([0.5 * (f[0][j] * c[2][0] + f[1][j] * c[2][1])
                           for j, c in enumerate(chunks)], -1)
    outs = [0.5 * sum(f[0][j] * c[3][2 * br] + f[1][j] * c[3][2 * br + 1]
                      for j, c in enumerate(chunks)) for br in range(2)]
    return outs[0], outs[1], attn


@pytest.mark.parametrize("k,invalid", [
    (70, "random"),          # a ragged last chunk (32 + 32 + 6 keys)
    (96, "second chunk"),    # a chunk of invalid keys between valid ones
    (70, "all")])            # every key invalid: a uniform attn
def test_split_combine_mirror_matches_reference(k, invalid):
    rng = np.random.default_rng(11)
    ins = [a[0] for a in _attn_inputs(rng, 1, 2, 5, k, 8)]
    if invalid == "second chunk":
        ins[7] = np.arange(k) // pfa.KEY_CHUNK != 1
    elif invalid == "all":
        ins[7] = np.zeros(k, bool)
    got = _split_combine_mirror(*ins)
    ref = dual_attention_reference(*map(jnp.asarray, ins))
    for name, g, r in zip(("out_cls", "out_reg", "attn"), got, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    if invalid == "all":
        np.testing.assert_allclose(got[2], 1.0 / k, rtol=1e-6)


def _tie_cost(n=8):
    # blocks of equal minima: scipy and the JV solver may break these
    # ties differently; the port must break them as the JAX solver does
    return (np.ones((n, n), np.float32)
            - np.kron(np.eye(n // 2), np.ones((2, 2))).astype(np.float32))


@pytest.mark.parametrize("case", ["random3", "random8", "random50", "ties",
                                  "all_equal"])
def test_hungarian_plain_equals_jax(case):
    rng = np.random.default_rng(3)
    if case.startswith("random"):
        n = int(case[6:])
        c = (rng.normal(size=(n, n)) * rng.uniform(0.5, 20)).astype(np.float32)
    elif case == "ties":
        c = _tie_cost()
    else:
        c = np.ones((5, 5), np.float32)
    got = pkh.linear_sum_assignment(torch.from_numpy(c[None]))[0].numpy()
    assert got.dtype == np.int32
    want = np.asarray(jhu.linear_sum_assignment(jnp.asarray(c), use_pallas=False))
    assert np.array_equal(got, want)
    pal = np.asarray(linear_sum_assignment_pallas(jnp.asarray(c), interpret=True))
    assert np.array_equal(got, pal)


def test_hungarian_batch_and_masked():
    rng = np.random.default_rng(4)
    costs = rng.uniform(0, 2, (3, 6, 6)).astype(np.float32)
    got = pkh.linear_sum_assignment(torch.from_numpy(costs)).numpy()
    for b in range(3):
        want = np.asarray(jhu.linear_sum_assignment(jnp.asarray(costs[b]),
                                                    use_pallas=False))
        assert np.array_equal(got[b], want)
    rv = np.array([1, 1, 1, 1, 0, 0], bool)
    cv = np.array([1, 1, 1, 0, 1, 0], bool)
    got = phu.masked_linear_sum_assignment(
        torch.from_numpy(costs[0]), torch.from_numpy(rv),
        torch.from_numpy(cv)).numpy()
    want = np.asarray(jhu.masked_linear_sum_assignment(
        jnp.asarray(costs[0]), jnp.asarray(rv), jnp.asarray(cv)))
    assert np.array_equal(got, want)


def _stem_inputs(rng, F, H, W, O):
    x = rng.uniform(0, 255, (F, H, W, 3)).astype(np.float32)
    w3 = rng.normal(0, 0.1, (O, 12, 3, 3)).astype(np.float32)     # OIHW
    scale = rng.uniform(0.5, 1.5, O).astype(np.float32)
    shift = rng.normal(0, 0.5, O).astype(np.float32)
    return x, w3, scale, shift


def test_focus_stem_plain_matches_xla_reference():
    x, w3, scale, shift = _stem_inputs(np.random.default_rng(0), 2, 64, 96, 16)
    got = pfs.focus_stem(*map(torch.from_numpy, (x, w3, scale, shift)))
    assert got.shape == (2, 16, 32, 48)
    # OIHW -> HWIO is the torch_to_flax layout change
    ref = jfs._xla_reference(jnp.asarray(x), jnp.asarray(w3.transpose(2, 3, 1, 0)),
                             jnp.asarray(scale), jnp.asarray(shift), jnp.float32,
                             compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=1e-3, rtol=1e-4)


def test_focus_stem_weight_rearrangement_matches_pallas():
    """The 6x6 kernel the CUDA kernel gets is the Pallas kernel's
    `_rearrange_w` (s2d channel order (dx*2+dy)*C + c) times the scale."""
    _, w3, scale, _ = _stem_inputs(np.random.default_rng(1), 1, 32, 32, 8)
    got = pfs.rearrange_weight(torch.from_numpy(w3), torch.from_numpy(scale))
    want = np.asarray(jfs._rearrange_w(jnp.asarray(w3.transpose(2, 3, 1, 0)), 3, 8)
                      ).reshape(6, 6, 3, 8) * scale
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), want,
                               atol=1e-6, rtol=1e-6)


def test_focus_stem_plain_matches_focus_conv_eval():
    rng = np.random.default_rng(2)
    x, w3, gamma, beta = _stem_inputs(rng, 2, 64, 64, 8)
    mean = rng.normal(0, 0.2, 8).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    mod = _FocusConv(8, 3, 1, "silu", jnp.float32)
    variables = {"params": {"conv": {"kernel": jnp.asarray(w3.transpose(2, 3, 1, 0))},
                            "bn": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}},
                 "batch_stats": {"bn": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}}
    want = np.asarray(mod.apply(variables, jnp.asarray(x), False))
    s = gamma / np.sqrt(var + 1e-5)
    got = pfs.focus_stem(*map(torch.from_numpy, (x, w3, s, beta - mean * s)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-3, rtol=1e-4)


def test_focus_cpu_output_is_nchw_like_the_card():
    """The kernel writes NCHW (tests/test_torch_port_cuda.py checks it);
    the CPU path hands the backbone the same memory format, so that the
    convs after the stem run in one layout on both devices."""
    x, *_ = _stem_inputs(np.random.default_rng(6), 2, 64, 64, 8)
    net = CSPDarknet(0.33, 0.125).eval()
    with torch.no_grad():
        stem = net.stem(torch.from_numpy(x))
        dark2 = net.dark2(stem)
    assert stem.shape == (2, 8, 32, 32) and stem.is_contiguous()
    assert dark2.is_contiguous()


def test_cpu_tensors_never_count_a_launch():
    rng = np.random.default_rng(5)
    counters = (pfa.fused_dual_attention, pkh.linear_sum_assignment,
                pfs.focus_stem)
    before = [c.launches for c in counters]
    pfa.fused_dual_attention(*map(torch.from_numpy,
                                  _attn_inputs(rng, 1, 2, 4, 8, 8)))
    pkh.linear_sum_assignment(torch.rand(1, 4, 4))
    pfs.focus_stem(*map(torch.from_numpy, _stem_inputs(rng, 1, 32, 32, 8)))
    assert [c.launches for c in counters] == before == [0, 0, 0]
