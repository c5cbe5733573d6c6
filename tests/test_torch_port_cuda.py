"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels have no CPU mode, so every test here is marked `cuda` and
skips without a card. The file imports no JAX, so that it runs on a
machine with the card and no JAX installed:

    python -m pytest tests/test_torch_port_cuda.py -q

Tolerances: fp32 with another summation order, 1e-5 absolute on the
attention's unit-scale values and 1e-4 relative on the stem's pixel-scale
sums (TF32 off); col4row is exact.
"""

import numpy as np
import pytest
import torch

from tscd_torch.ops.kernels import focus_stem as pfs
from tscd_torch.ops.kernels import fused_attention as pfa
from tscd_torch.ops.kernels import hungarian as pkh


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _attn_inputs(rng, B, h, q, k, d, p_valid=0.8):
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return (mk(B, h, q, d), mk(B, h, k, d), mk(B, h, k, d), mk(B, h, q, d),
            mk(B, h, k, d), mk(B, h, k, d),
            rng.uniform(0, 1, (B, k)).astype(np.float32),
            rng.uniform(size=(B, k)) < p_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,q,k,d,p_valid", [
    (1, 4, 50, 1600, 64, 0.8), (2, 2, 13, 70, 40, 0.5),
    (1, 4, 50, 1600, 64, 0.0)])
def test_cuda_attention_matches_plain(card, B, h, q, k, d, p_valid):
    ins = [torch.from_numpy(a).to(card)
           for a in _attn_inputs(np.random.default_rng(6), B, h, q, k, d, p_valid)]
    n0 = pfa.fused_dual_attention.launches
    got = pfa.fused_dual_attention(*ins)
    want = pfa.fused_dual_attention_plain(*ins)
    torch.cuda.synchronize()
    assert pfa.fused_dual_attention.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


def _tie_cost(n=8):
    return (np.ones((n, n), np.float32)
            - np.kron(np.eye(n // 2), np.ones((2, 2))).astype(np.float32))


@pytest.mark.cuda
def test_cuda_hungarian_equals_plain(card):
    rng = np.random.default_rng(7)
    for c in (rng.uniform(0, 2, (2, 50, 50)).astype(np.float32),
              rng.normal(size=(1, 128, 128)).astype(np.float32),
              _tie_cost()[None], np.ones((1, 5, 5), np.float32)):
        ct = torch.from_numpy(c).to(card)
        assert torch.equal(pkh.linear_sum_assignment(ct).cpu(),
                           pkh.linear_sum_assignment_plain(ct.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("F,H,W,O", [(2, 128, 96, 64), (1, 70, 34, 16)])
def test_cuda_focus_stem_matches_plain(card, F, H, W, O):
    rng = np.random.default_rng(8)
    ins = [torch.from_numpy(a).to(card) for a in (
        rng.uniform(0, 255, (F, H, W, 3)).astype(np.float32),
        rng.normal(0, 0.1, (O, 12, 3, 3)).astype(np.float32),
        rng.uniform(0.5, 1.5, O).astype(np.float32),
        rng.normal(0, 0.5, O).astype(np.float32))]
    torch.backends.cudnn.allow_tf32 = False
    got = pfs.focus_stem(*ins)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, pfs.focus_stem_plain(*ins),
                               atol=1e-3, rtol=1e-4)
