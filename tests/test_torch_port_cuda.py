"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels have no CPU mode, so every test here is marked `cuda` and
skips without a card. The file imports no JAX, so that it runs on a
machine with the card and no JAX installed:

    python -m pytest tests/test_torch_port_cuda.py -q

Tolerances: fp32 with another summation order, 1e-5 absolute on the
attention's unit-scale values and 1e-4 relative on the stem's pixel-scale
sums (TF32 off); the bf16 stem one bf16 ulp (2^-7 relative) over the
same 1e-3 floor, the attention on bf16 q/k/v as at fp32 (it computes in
fp32); col4row, the NMS keep mask and the NMS pack's bits are exact;
the selftest evaluator on the card against the CPU, detections 1e-4
(matched as sets per frame) and stats 1e-4, also through the eval CLI on
the fixture's files from a JAX msgpack checkpoint; a window's CUDA graph
replay equals its eager dispatch; the stem's backward on the card against
the CPU's, 1e-4 of each gradient's largest value; the bf16 and the
train-mode-BN selftest steps on the card against the CPU, at chip_smoke.py's
bounds; the proposal-patch towers against the dense ones at the selftest
size (features at JAX's tolerances of the dense path with fp64 convs,
detections 1e-4 as sets); the NMS at
the pre-NMS call's shape (32, 750), exactly; postprocess_dense at (8,
2048) exactly, and the OVIS fixture's warps equal to cv2's recorded
pixels; the attention in the YOLOV family's self-attention form (q = k =
960 and 480, some keys invalid) 1e-5 as above, and its streaming route
(q > 128: 960 at d 64 and 32, 129, 200, 1000 at d 64 and 128, 8000; with
and without the online MSA's fg score; fp32 and bf16 q/k/v; all keys but
one invalid) 1e-5 from the plain version and bit-identical across calls,
its block the one `stream_plan` reckons, the wrapper raising
with the shape and bytes where the card cannot hold a launch, the NMS at
YOLOV-L's refined postprocess (32, 900) exactly, the online YOLOV
stream (graph replays) against the CPU's eager stream at the selftest
size, detections and bank 1e-4, and the demo tools (tscd_demo, vid_demo,
yolov_demo_online) at the selftest size against the CPU port, detections
1e-4 as sets, their .mp4 parsed; a small Swin (whole and shrunk
windows) and FocalNet against the CPU port, 1e-4 of each map's largest,
and a Swin TSCD window's graph replay equal to its eager dispatch and to
the CPU's detections (1e-4 as sets); the stem at the P6 ELAN widths (80
and 96 channels, 2 x 1280 x 1280, fp32 and bf16) at the stem's
tolerances, the solver on a DETR criterion's 100 x 100 cost exactly, and
YOLOv7-tiny and YOLOv8 against the CPU port, 1e-4 of the largest decoded
value; the int8 kernels (the abs max, the quantize pass, the weight
packing, the conv's int32 sums) equal to their plain versions, the
dequantized output within one ulp of fp32 and of bf16, and the selftest
int8 window on the card against the CPU port by
tests/test_torch_port_int8.py's rule; each `tscd::` op launching its
kernel once a call, the QAT conv's forward equal to the serving route's
and its STE gradients within 1e-4 of the largest of its reference's,
torch.export of a small int8 YOLOX (bit-equal) and of the selftest TSCD's
streaming step (equal over 2 windows), and a small YOLOX's AOTInductor
package through the C++ runner against the eager port (raw outputs 1e-4
of the largest, detections' count and classes equal, boxes 1e-4 of their
box's largest coordinate plus 0.01 px, scores 2e-4), each op of
csrc/torch_ops.cpp bit-equal to its Python op, and select_proposals at
pre_topk 750 on the card equal to the CPU port.
"""

import numpy as np
import pytest
import torch

from tscd_torch.models.aggregation import _split_heads
from tscd_torch.ops import hungarian as phu
from tscd_torch.ops.kernels import focus_stem as pfs
from tscd_torch.ops.kernels import fused_attention as pfa
from tscd_torch.ops.kernels import hungarian as pkh
from tscd_torch.ops.kernels import int8_conv as pq8
from tscd_torch.ops.kernels import nms as pkn


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _attn_inputs(rng, B, h, q, k, d, p_valid=0.8):
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    ins = (mk(B, h, q, d), mk(B, h, k, d), mk(B, h, k, d), mk(B, h, q, d),
           mk(B, h, k, d), mk(B, h, k, d),
           rng.uniform(0, 1, (B, k)).astype(np.float32))
    if p_valid == "last 3":
        return ins + (np.arange(k)[None].repeat(B, 0) >= k - 3,)
    if p_valid == "tile 1":     # the streaming route's second key tile invalid, the rest valid
        return ins + (np.arange(k)[None].repeat(B, 0) // pfa.STREAM_TILE != 1,)
    return ins + (rng.uniform(size=(B, k)) < p_valid,)


def _as_aggregation_views(ins):
    """The same values as the views DualBranchAttention.attend passes:
    heads split out of a Linear output, k and v chunks of one buffer."""
    qc, kc, vc, qr, kr, vr = ins[:6]
    h = qc.shape[1]
    merge = lambda t: t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)
    views = []
    for q, k, v in ((qc, kc, vc), (qr, kr, vr)):
        kb, vb = torch.cat([merge(k), merge(v)], -1).chunk(2, -1)
        views += [_split_heads(merge(q).clone(), h), _split_heads(kb, h),
                  _split_heads(vb, h)]
    qc, kc, vc, qr, kr, vr = views
    assert not any(t.is_contiguous() for t in (qc, kc, vc))
    return [qc, kc, vc, qr, kr, vr, *ins[6:]]


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,q,k,d,p_valid,strided", [
    (1, 4, 50, 1600, 64, 0.8, False), (2, 2, 13, 70, 40, 0.5, False),
    (1, 4, 50, 1600, 64, 0.0, False),
    (1, 2, 130, 100, 16, 0.8, False),     # more than one query tile
    (1, 2, 20, 200, 128, 0.8, False),     # the widest head
    (2, 2, 13, 33, 24, 0.8, False),       # a ragged last key chunk
    (1, 4, 50, 1600, 64, "last 3", False),
    (1, 4, 50, 1600, 64, 0.8, True)])     # the aggregation's strided views
def test_cuda_attention_matches_plain(card, B, h, q, k, d, p_valid, strided):
    ins = [torch.from_numpy(a).to(card)
           for a in _attn_inputs(np.random.default_rng(6), B, h, q, k, d, p_valid)]
    want = pfa.fused_dual_attention_plain(*ins)
    if strided:
        ins = _as_aggregation_views(ins)
    n0 = pfa.fused_dual_attention.launches
    got = pfa.fused_dual_attention(*ins)
    torch.cuda.synchronize()
    assert pfa.fused_dual_attention.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_attention_is_bit_identical_across_calls(card):
    ins = [torch.from_numpy(a).to(card)
           for a in _attn_inputs(np.random.default_rng(9), 1, 4, 50, 1600, 64)]
    n0 = pfa.fused_dual_attention.launches
    first = pfa.fused_dual_attention(*ins)
    assert pfa.fused_dual_attention.launches == n0 + 1
    second = pfa.fused_dual_attention(*ins)
    torch.cuda.synchronize()
    assert pfa.fused_dual_attention.launches == n0 + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _tie_cost(n=8):
    return (np.ones((n, n), np.float32)
            - np.kron(np.eye(n // 2), np.ones((2, 2))).astype(np.float32))


def _signed_zero_tie(n=40):
    c = np.ones((n, n), np.float32)
    c[:, 7] = 0.0
    c[:, 33:37] = -0.0
    return c


@pytest.mark.cuda
def test_cuda_hungarian_equals_plain(card):
    rng = np.random.default_rng(7)
    const = lambda n: np.full((1, n, n), 1e4, np.float32)
    for c in (rng.uniform(0, 2, (2, 50, 50)).astype(np.float32),
              rng.normal(size=(1, 128, 128)).astype(np.float32),
              _tie_cost()[None], np.ones((1, 5, 5), np.float32),
              const(33), const(64), const(128), _signed_zero_tie()[None],
              # reduced costs a few ulps apart
              (1 + rng.integers(0, 4, (1, 50, 50)) * 2.0 ** -23).astype(np.float32),
              rng.normal(size=(1, 1, 1)).astype(np.float32),
              # more matrices than a block has warps
              rng.uniform(0, 2, (5, 50, 50)).astype(np.float32),
              # matrices whose starts are not 16-byte aligned
              rng.uniform(0, 2, (3, 33, 33)).astype(np.float32)):
        ct = torch.from_numpy(c).to(card)
        n0 = pkh.linear_sum_assignment.launches
        got = pkh.linear_sum_assignment(ct)
        assert pkh.linear_sum_assignment.launches == n0 + 1
        assert torch.equal(got.cpu(), pkh.linear_sum_assignment_plain(ct.cpu()))
    # the sequence start as the matcher builds it: an empty bank
    n = 50
    got = phu.masked_linear_sum_assignment(
        torch.from_numpy(rng.uniform(0, 2, (n, n)).astype(np.float32)).to(card),
        torch.zeros(n, dtype=torch.bool, device=card),
        torch.ones(n, dtype=torch.bool, device=card))
    assert torch.equal(got.cpu(), pkh.linear_sum_assignment_plain(
        torch.from_numpy(const(n)))[0])


@pytest.mark.cuda
def test_cuda_hungarian_is_deterministic(card):
    c = torch.from_numpy(np.random.default_rng(10).uniform(
        0, 2, (5, 50, 50)).astype(np.float32)).to(card)
    first = pkh.linear_sum_assignment(c)
    second = pkh.linear_sum_assignment(c)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("F,H,W,O,border", [
    (2, 128, 96, 64, False),
    (1, 70, 34, 16, False),       # single frame, ragged last tiles
    (4, 128, 128, 8, False),      # the selftest's width
    (300, 16, 24, 64, False),     # more tiles than the persistent grid has blocks
    (2, 70, 66, 64, True)])       # large border pixels: padding must be zeros
def test_cuda_focus_stem_matches_plain(card, F, H, W, O, border):
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 255, (F, H, W, 3)).astype(np.float32)
    if border:
        for edge in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
            x[edge] = 4e3
    ins = [torch.from_numpy(a).to(card) for a in (
        x, rng.normal(0, 0.1, (O, 12, 3, 3)).astype(np.float32),
        rng.uniform(0.5, 1.5, O).astype(np.float32),
        rng.normal(0, 0.5, O).astype(np.float32))]
    torch.backends.cudnn.allow_tf32 = False
    n0 = pfs.focus_stem.launches
    got = pfs.focus_stem(*ins)
    torch.cuda.synchronize()
    assert pfs.focus_stem.launches == n0 + 1
    assert got.shape == (F, O, H // 2, W // 2) and got.is_contiguous()
    torch.testing.assert_close(got, pfs.focus_stem_plain(*ins),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("F,H,W,O,kind", [
    (2, 128, 96, 64, "uint8"),
    (1, 70, 34, 16, "uint8"),     # single frame, ragged last tiles
    (4, 128, 128, 8, "uint8"),    # the selftest's width
    (2, 70, 66, 64, "border"),    # 255 at the border: padding must be zeros
    (2, 64, 64, 64, "fp32"),      # fp32 frames, rounded to bf16 as read
    (3, 2, 64, 64, "border"),     # H/2 = 1: one output row, every input row padded
    (2, 40, 70, 64, "uint8"),     # W/2 = 35: neither a multiple of 16 nor of 32
    (2, 48, 96, 24, "uint8"),     # O = 24: the second m16 tile partly written
    (1, 576, 576, 64, "border"),  # F = 1 at the window's size
    (2, 8, 1200, 16, "uint8"),    # W/2 = 600: three column tiles, halo from global
    (32, 576, 576, 64, "uint8")])  # the window: 32 frames of uint8 -> 64 channels
def test_cuda_focus_stem_bf16_matches_plain(card, F, H, W, O, kind):
    import chip_smoke
    rng = np.random.default_rng(18)
    x = rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8)
    if kind == "border":
        for edge in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
            x[edge] = 255
    xin = rng.uniform(0, 255, (F, H, W, 3)).astype(np.float32) if kind == "fp32" else x
    ins = [torch.from_numpy(a).to(card) for a in (
        xin, rng.normal(0, 0.1, (O, 12, 3, 3)).astype(np.float32),
        rng.uniform(0.5, 1.5, O).astype(np.float32),
        rng.normal(0, 0.5, O).astype(np.float32))]
    n0 = pfs.focus_stem.launches
    got = pfs.focus_stem(*ins, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert pfs.focus_stem.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (F, O, H // 2, W // 2)
    assert got.is_contiguous()
    want = pfs.focus_stem_plain(*ins, torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **chip_smoke.BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
def test_cuda_attention_bf16_matches_plain(card, strided):
    ins = [torch.from_numpy(a).to(card)
           for a in _attn_inputs(np.random.default_rng(19), 1, 4, 50, 1600, 64)]
    ins = [t.to(torch.bfloat16) for t in ins[:6]] + ins[6:]
    want = pfa.fused_dual_attention_plain(*ins)
    if strided:
        ins = _as_aggregation_views(ins)
    got = pfa.fused_dual_attention(*ins)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


def _selftest_predict(card, dtype, seed=20):
    """The selftest model on the card at `dtype` (BN folded at bf16) and
    its predict function, with 3 seeded windows of pinned uint8 frames."""
    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp import selftest_exp
    from tscd_torch.models.tscd import TSCD, random_init_
    from tscd_torch.ops.position import get_timing_signal_1d
    from tscd_torch.utils.model_utils import fuse_model
    exp = selftest_exp()
    model = random_init_(exp.get_model(device=card), exp.seed)
    if dtype == torch.bfloat16:
        model = fuse_model(TSCD(num_classes=exp.num_classes, depth=exp.depth,
                                width=exp.width, num_proposals=exp.num_proposals,
                                minimal_limit=exp.minimal_limit, heads=exp.heads,
                                device=card, dtype=dtype), model.state_dict())
    predict = make_predict_fn(model, exp.lframe_val, exp.gframe_val,
                              exp.nmsthre, exp.test_conf)
    F, (H, W) = exp.lframe_val + exp.gframe_val, exp.test_size
    rng = np.random.default_rng(seed)
    windows = [(torch.from_numpy(rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8)).pin_memory(),
                torch.from_numpy(get_timing_signal_1d(np.arange(w, w + F))).pin_memory())
               for w in range(3)]
    return predict, windows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_graph_replay_equals_eager_dispatch(card, dtype):
    """A carried window as the window's CUDA graph and launch by launch:
    the same detections and bank. The replay's device trace holds the
    window's hand kernels, in the variants of the model's dtype, and the
    wrappers count no launch for it (a replay runs no Python)."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    predict, windows = _selftest_predict(card, dtype)
    _, state = predict.dispatch(*windows[0], False, None)        # captures
    counters = (pkn.nms_sorted, pfs.focus_stem, pfa.fused_dual_attention,
                pkh.linear_sum_assignment)
    n0 = [c.launches for c in counters]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = predict.dispatch(*windows[1], True, state)
        torch.cuda.synchronize()
    assert [c.launches for c in counters] == n0
    assert chip_smoke.trace_launches(prof) == chip_smoke.window_launches(
        1, 1, bf16=dtype == torch.bfloat16)
    want = predict.dispatch_eager(*windows[1], True, state)
    assert got[1].out.dtype == dtype
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    assert got[0].mask.any()


@pytest.mark.cuda
def test_cuda_pipelined_window_survives_next_replay(card):
    """The evaluator reads window i after dispatching i + 1: what a replay
    returns is a copy, which the next replay leaves as it was."""
    predict, windows = _selftest_predict(card, torch.bfloat16)
    _, state = predict.dispatch(*windows[0], False, None)
    first, state = predict.dispatch(*windows[1], True, state)
    kept = [t.clone() for t in first]
    second, _ = predict.dispatch(*windows[2], True, state)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert not all(torch.equal(a, b) for a, b in zip(first, second))
    assert first.boxes.data_ptr() != second.boxes.data_ptr()


@pytest.mark.cuda
def test_cuda_bf16_dispatch_waits_on_nothing(card):
    predict, windows = _selftest_predict(card, torch.bfloat16)
    _, state = predict.dispatch(*windows[0], False, None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        refined, state = predict.dispatch(*windows[1], True, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rows = predict.materialize(refined)
    assert np.isfinite(rows[0]).all() and state.out.dtype == torch.bfloat16


@pytest.mark.cuda
def test_cuda_nms_walk_equals_plain(card):
    """chip_smoke.py's cases: random boxes at K = 1500, 50 and 7, B = 1, 3
    and 2, all invalid, identical boxes, tied scores, the K-step chain,
    IoUs within a few ulps of the threshold (0.5 and 0.45) and
    postprocess_refined's class-shifted pairs. The keep mask equals the
    plain version's, and the pack kernel's bits the torch IoU's."""
    import chip_smoke
    for name, bs, vs, thr in chip_smoke.nms_inputs(torch, np.random.default_rng(14), card):
        n0 = pkn.nms_sorted.launches
        got = pkn.nms_sorted(bs, vs, thr)
        assert pkn.nms_sorted.launches == n0 + 1
        want = pkn.nms_sorted_plain(bs.cpu(), vs.cpu(), thr)
        assert torch.equal(got.cpu(), want), name
        assert torch.equal(pkn.pack(bs, thr).cpu(), pkn.pack_plain(bs.cpu(), thr)), name
        if name == "chain 1x1500":
            assert torch.equal(got.cpu()[0], torch.arange(1500) % 2 == 0)


@pytest.mark.cuda
def test_cuda_nms_stage_writes_no_k_by_k_tensor(card):
    """batched_class_aware_nms at K = 1500 on the card allocates less, in
    all, than one (K, K) bool would take (the pack's bit tiles are 144 KB)."""
    import chip_smoke
    from tscd_torch.ops import nms as pnms
    frames = [chip_smoke.class_pairs(np.random.default_rng(18))]
    args = [torch.from_numpy(np.stack(a)).to(card) for a in zip(*frames)]
    pnms.batched_class_aware_nms(*args, 0.5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    keep = pnms.batched_class_aware_nms(*args, 0.5)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 1500 * 1500
    want = pnms.batched_class_aware_nms(*(a.cpu() for a in args), 0.5)
    assert torch.equal(keep.cpu(), want)


@pytest.mark.cuda
def test_cuda_hungarian_past_128_equals_plain(card):
    rng = np.random.default_rng(15)
    for n in (129, 200):
        for c in (rng.uniform(0, 2, (2, n, n)).astype(np.float32),
                  np.full((1, n, n), 1e4, np.float32)):
            ct = torch.from_numpy(c).to(card)
            n0 = pkh.linear_sum_assignment.launches
            got = pkh.linear_sum_assignment(ct)
            assert pkh.linear_sum_assignment.launches == n0 + 1
            assert torch.equal(got.cpu(), pkh.linear_sum_assignment_plain(ct.cpu()))
    n = 200
    rv = torch.from_numpy(rng.uniform(size=n) > 0.3)
    cv = torch.from_numpy(rng.uniform(size=n) > 0.3)
    c = torch.from_numpy(rng.uniform(0, 2, (n, n)).astype(np.float32))
    got = phu.masked_linear_sum_assignment(c.to(card), rv.to(card), cv.to(card))
    assert torch.equal(got.cpu(), phu.masked_linear_sum_assignment(c, rv, cv))


@pytest.mark.cuda
def test_cuda_dispatch_waits_on_nothing(card):
    """The whole dispatch (upload, forward, postprocess) of a streamed
    window from pinned uint8 frames runs under sync debug mode "error",
    and its device trace holds the window's two NMS walks."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp import selftest_exp
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops.position import get_timing_signal_1d
    exp = selftest_exp()
    model = random_init_(exp.get_model(device=card), exp.seed)
    predict = make_predict_fn(model, exp.lframe_val, exp.gframe_val,
                              exp.nmsthre, exp.test_conf)
    F, (H, W) = exp.lframe_val + exp.gframe_val, exp.test_size
    rng = np.random.default_rng(16)
    windows = [(torch.from_numpy(rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8)).pin_memory(),
                torch.from_numpy(get_timing_signal_1d(np.arange(w, w + F))).pin_memory())
               for w in range(2)]
    _, state = predict.dispatch(*windows[0], False, None)      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            refined, state = predict.dispatch(*windows[1], True, state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert chip_smoke.trace_launches(prof)["nms"] == 2
    rows = predict.materialize(refined)
    assert len(rows) == exp.lframe_val and np.isfinite(rows[0]).all()


@pytest.mark.cuda
def test_cuda_selftest_evaluator_matches_cpu(fp32_card):
    """The selftest evaluator over an in-memory dataset (chip_smoke.py's
    `SyntheticVID`) on the card against the CPU, TF32 off (with TF32 on the
    card's detections leave 1e-4)."""
    card = fp32_card
    import chip_smoke
    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.data.vid import WindowLoader
    from tscd_torch.exp import selftest_exp
    from tscd_torch.models.tscd import random_init_
    exp = selftest_exp()
    ds = chip_smoke.SyntheticVID(exp, videos=2, frames=6, seed=17)
    out = {}
    for dev in ("cpu", card):
        model = random_init_(exp.get_model(device=dev), exp.seed)
        rows = []
        predict = chip_smoke.recording(make_predict_fn(
            model, exp.lframe_val, exp.gframe_val, exp.nmsthre, exp.test_conf), rows)
        loader = WindowLoader(ds, pin_memory=torch.device(dev).type == "cuda")
        res = exp.get_evaluator(loader).evaluate(predict, log=lambda *a: None)
        out[torch.device(dev).type] = (res, rows)
    (rc, wc), (rg, wg) = out["cpu"], out["cuda"]
    assert chip_smoke.match_rows(wc, wg, 1e-4, 1e-4)[1] > 0
    np.testing.assert_allclose(rg["stats"], rc["stats"], atol=1e-4)


@pytest.mark.cuda
def test_cuda_eval_cli_reads_fixture_files_and_a_msgpack_checkpoint(fp32_card):
    """The eval CLI on the committed fixture's JPEGs (the port's decoder)
    from YOLOX_outputs/validate_ref/converted_ckpt.msgpack (the port's
    reader), on the card and on the CPU: each window's detections matched
    as sets per frame within 1e-4 (there are some), and the stats 1e-4."""
    import os

    import chip_smoke
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = os.path.join(repo, "YOLOX_outputs", "validate_ref")
    args = ["--exp", "selftest", "-c", os.path.join(ref, "converted_ckpt.msgpack")]
    opts = ["data_dir", os.path.join(ref, "vid"),
            "val_seq_path", os.path.join(ref, "vid", "val_seq.npy")]
    res, rows = {}, {}
    for d in ("cpu", "cuda"):
        rows[d] = []
        res[d] = chip_smoke.eval_cli([*args, "--device", d, *opts], rows[d])
    assert len(rows["cuda"]) == len(rows["cpu"]) > 0
    _, n = chip_smoke.match_rows(rows["cpu"], rows["cuda"], 1e-4, 1e-4)
    assert n > 0
    assert len(res["cuda"]["stats"]) == 12
    np.testing.assert_allclose(res["cuda"]["stats"], res["cpu"]["stats"], atol=1e-4)


@pytest.fixture
def fp32_card(card):
    """The card with TF32 off for convs and matmuls, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield card
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,q,k,d", [(4, 4, 50, 650, 64), (2, 2, 13, 70, 24)])
def test_cuda_attention_backward_matches_plain_autograd(fp32_card, B, h, q, k, d):
    """The wrapper's autograd path (kernel forward, plain recompute
    backward) against the plain version on the card: the kernel's three
    outputs at the forward's tolerance (k = 650 ends in a partial key
    chunk), then the six q/k/v gradients against autograd of the plain
    version within 1e-5 of each one's largest value, none for cls_score;
    one launch and one backward counted. The backward recomputes the
    plain version from the saved inputs, so the gradients hold how it is
    wired up; its math is held against JAX's VJP on the CPU."""
    rng = np.random.default_rng(B * 100 + k)
    ins = [torch.from_numpy(a).to(fp32_card) for a in _attn_inputs(rng, B, h, q, k, d)]
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(fp32_card)
           for s in ((B, h, q, d), (B, h, q, d), (B, h, q, k))]
    got_in = [t.clone().requires_grad_(True) for t in ins[:7]]
    want_in = [t.clone().requires_grad_(True) for t in ins[:7]]
    n0, b0 = pfa.fused_dual_attention.launches, pfa.fused_dual_attention.backward_calls
    outs = pfa.fused_dual_attention(*got_in, ins[7])
    with torch.no_grad():
        want_fwd = pfa.fused_dual_attention_plain(*ins)
    for g, w in zip(outs, want_fwd):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.detach(), w, atol=1e-5, rtol=1e-4)
    got = torch.autograd.grad(outs, got_in, cot, allow_unused=True)
    assert (pfa.fused_dual_attention.launches - n0,
            pfa.fused_dual_attention.backward_calls - b0) == (1, 1)
    want = torch.autograd.grad(pfa.fused_dual_attention_plain(*want_in, ins[7]), want_in[:6], cot)
    assert got[6] is None
    for g, w in zip(got[:6], want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
def test_cuda_train_small_step_matches_cpu(fp32_card):
    """chip_smoke.py's `train_small` phase: one stage-2 step of the
    selftest config from the same seeded weights and window, past
    warm-up, on the card and on the CPU: losses 1e-4 relative, updates
    and EMA 1e-3 of the largest update beyond the fp32 spacing, every loss
    term driven, the backbone bit-unchanged (it raises otherwise)."""
    import chip_smoke
    chip_smoke.train_small_phase(torch)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_focus_stem_backward_matches_cpu(fp32_card, out_dtype):
    """The stem's autograd rule on the card (the kernel's forward, the VJP
    of the fp32 recompute) against the same on the CPU (the plain
    version's forward): the x, w3, scale and shift gradients within 1e-4
    of each one's largest value (fp32 sums over the frame in other
    orders), one backward counted."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32)
    w3 = rng.normal(0, 0.1, (16, 12, 3, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    shift = rng.normal(0, 0.5, 16).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(2, 16, 32, 48)).astype(np.float32)).to(out_dtype)
    grads = {}
    for dev in ("cpu", fp32_card):
        ins = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in (x, w3, scale, shift)]
        b0 = pfs.focus_stem.backward_calls
        out = pfs.focus_stem(*ins, out_dtype=out_dtype)
        grads[torch.device(dev).type] = [t.cpu() for t in torch.autograd.grad(out, ins, g.to(dev))]
        assert pfs.focus_stem.backward_calls == b0 + 1
    for name, a, b in zip(("x", "w3", "scale", "shift"), grads["cuda"], grads["cpu"]):
        assert a.dtype == torch.float32, name
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()), msg=name)


@pytest.mark.cuda
def test_cuda_bf16_train_step_matches_cpu(fp32_card):
    """chip_smoke.py's selftest bf16 step (bench.py's: constant LR 0.01,
    frozen backbone, fix_bn) on the card against the card machine's CPU,
    window by window: the dense raw outputs, the updates and the EMA
    within BF16_SPREAD x that window's CPU bf16-to-fp32 distance, each
    run's losses the CPU loss of its own outputs, every bf16 parameter on
    an fp32 master (it raises otherwise)."""
    import chip_smoke
    assert chip_smoke.train_bf16_small(torch)["pass"]


@pytest.mark.cuda
def test_cuda_train_mode_bn_step_matches_cpu(fp32_card):
    """chip_smoke.py's selftest fix_bn=False step on the card against the
    CPU: losses and new running statistics 1e-4, updates and EMA 1e-3 of
    the largest update (it raises otherwise)."""
    import chip_smoke
    assert chip_smoke.train_bn_small(torch)["pass"]


@pytest.mark.cuda
def test_cuda_sparse_towers_equal_dense_at_selftest(fp32_card):
    """The selftest model with sparse_vid_towers against the dense one on
    the same weights (the head's BN shifted off 0) on the card: the video
    features at the model's proposals within JAX's tolerances
    (chip_smoke.FEATURE_TOL) of the dense path with fp64 convs, and two
    streamed windows (the second a graph replay) give the same detections
    as sets, 1e-4."""
    import chip_smoke
    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp import selftest_exp
    from tscd_torch.models.tscd import random_init_
    exp = selftest_exp()
    L, G = exp.lframe_val, exp.gframe_val
    dense = chip_smoke.seeded_head_bn_(
        torch, random_init_(exp.get_model(device=fp32_card), exp.seed), 61)
    sparse = chip_smoke.exp_with(selftest_exp(), sparse_vid_towers=True).get_model(
        device=fp32_card)
    sparse.load_state_dict(dense.state_dict())
    x, te = chip_smoke.device_window(torch, exp, 62)
    with torch.no_grad():
        idx = dense(x, te, L, G)["proposals"].idx
    stems = chip_smoke.stem_maps(torch, dense, x)
    fs = chip_smoke.tower_features(torch, dense.head, stems, idx, L, True)
    ref = chip_smoke.fp64_features(torch, dense.head, stems, idx, L)
    for part, got, want in zip(chip_smoke.FEATURE_TOL, fs, ref):
        assert chip_smoke.feature_excess(torch, got, want, part)[0] <= 0, part
    rows = {}
    for name, model in (("dense", dense), ("sparse", sparse)):
        pred = make_predict_fn(model, L, G, exp.nmsthre, exp.test_conf)
        dets, _, _ = chip_smoke.run_windows(torch, pred, exp, 2, 1, False)
        rows[name] = [pred.materialize(d) for d in dets]
    _, n = chip_smoke.match_rows(rows["dense"], rows["sparse"], 1e-4, 1e-4)
    assert n > 0


@pytest.mark.cuda
def test_cuda_pre_nms_shape_equals_plain(card):
    """batched_class_aware_nms at the pre-NMS call's shape, 32 frames of
    750 boxes (in clusters of 3 classes, so that it suppresses), IoU 0.75:
    one launch of the kernels, whose keep mask equals the plain version's
    on a host copy."""
    from tscd_torch.ops import nms as pnms
    rng = np.random.default_rng(15)
    B, K = 32, 750
    centres = rng.uniform(40, 500, (B, 20, 2))
    pick = rng.integers(0, 20, (B, K))
    xy = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 6, (B, K, 2))
    wh = rng.uniform(30, 80, (B, K, 2))
    args = [torch.from_numpy(a) for a in (
        np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32),
        rng.uniform(size=(B, K)).astype(np.float32), rng.integers(0, 3, (B, K)),
        np.ones((B, K), bool))]
    n0 = pkn.nms_sorted.launches
    got = pnms.batched_class_aware_nms(*(a.to(card) for a in args), 0.75)
    assert pkn.nms_sorted.launches == n0 + 1
    want = pnms.batched_class_aware_nms(*args, 0.75)
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.65, 0.5])
def test_cuda_postprocess_dense_at_8x2048_equals_plain(card, thr):
    """postprocess_dense on 8 images of 4200 anchors (so that its top 2048
    candidates enter NMS, 25 classes) at yolox_l's and yoloxl_ovis's IoU:
    one launch of the NMS kernels, whose detections equal the plain
    version's on a host copy, element for element."""
    from tscd_torch.ops.postprocess import postprocess_dense
    rng = np.random.default_rng(16)
    B, A, C = 8, 4200, 25
    centres = rng.uniform(40, 560, (B, 60, 2))
    xy = np.take_along_axis(centres, rng.integers(0, 60, (B, A))[..., None], 1) \
        + rng.normal(0, 8, (B, A, 2))
    dec = np.concatenate([xy, rng.uniform(20, 160, (B, A, 2)),
                          rng.uniform(0, 1, (B, A, 1 + C)) ** 2], -1).astype(np.float32)
    x = torch.from_numpy(dec)
    n0 = pkn.nms_sorted.launches
    got = postprocess_dense(x.to(card), C, 0.01, thr, 100)
    assert pkn.nms_sorted.launches == n0 + 1
    want = postprocess_dense(x, C, 0.01, thr, 100)
    assert int(want.mask.sum()) == B * 100
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_cuda_machine_warps_the_fixture_as_cv2(card):
    """The port's warp (host C++) of each OVIS fixture frame's mosaic
    canvas equals cv2.warpAffine's recorded pixels (sha256), on the card's
    machine, which has no cv2."""
    import chip_smoke
    rec = chip_smoke.warp_checks()
    assert rec["pass"] and rec["sha256_match"] == rec["frames"] == 32, rec["mismatched"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,q,d", [(1, 4, 960, 64), (1, 4, 960, 32), (1, 4, 480, 64)])
def test_cuda_attention_self_attention_form_matches_plain(card, B, h, q, d):
    """The YOLOV family's MSA shapes, q = k = F x P (YOLOV-L's window of
    32 x 30 proposals, v++_base_decoupleReg's at d 32, a 16-frame training
    window), 20% of the keys invalid, on the joint projection's strided
    views: 1e-5 as at the MCA shapes."""
    ins = [torch.from_numpy(a).to(card)
           for a in _attn_inputs(np.random.default_rng(21), B, h, q, q, d)]
    want = pfa.fused_dual_attention_plain(*ins)
    n0 = pfa.fused_dual_attention.launches
    got = pfa.fused_dual_attention(*_as_aggregation_views(ins))
    torch.cuda.synchronize()
    assert pfa.fused_dual_attention.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_attention_raises_where_the_card_cannot_hold_it(card):
    """q = k = 80000 at h 4, d 64 needs 102.6 GB of attn and outputs on the
    streaming route: the wrapper raises with the shape and the bytes, and
    launches nothing."""
    B, h, n, d = 1, 4, 80000, 64
    need = pfa.launch_bytes(B, h, n, n, d)
    assert pfa.route(n) == "stream" and need > torch.cuda.get_device_properties(card).total_memory
    mk = lambda m: torch.zeros(B, h, m, d, device=card)      # noqa: E731
    args = [mk(n) for _ in range(6)] + [torch.ones(B, n, device=card),
                                        torch.ones(B, n, dtype=torch.bool, device=card)]
    n0 = pfa.fused_dual_attention.launches
    with pytest.raises(ValueError, match=f"q {n}, k {n}, d {d}.* {need} bytes"):
        pfa.fused_dual_attention(*args)
    assert pfa.fused_dual_attention.launches == n0


def _stream_inputs(card, rng, h, n, d, fg, dtype, p_valid=0.8):
    """Inputs at q = k = n on the joint projection's views, 1 - p_valid of
    the keys invalid (or the mask `_attn_inputs` names), with the
    reg-branch score or without."""
    ins = [torch.from_numpy(a).to(card) for a in _attn_inputs(rng, 1, h, n, n, d, p_valid)]
    fg_score = (torch.from_numpy(rng.uniform(0.05, 1, (1, n)).astype(np.float32)).to(card)
                if fg else None)
    views = _as_aggregation_views(ins)
    views[:6] = [t.to(dtype) for t in views[:6]]
    return views, fg_score


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,fg,dtype,valid", [
    (960, 64, False, torch.float32, 0.8), (960, 64, True, torch.float32, 0.8),
    (960, 32, True, torch.float32, 0.8), (960, 64, True, torch.bfloat16, 0.8),
    (200, 16, True, torch.float32, 0.8),      # a ragged last key tile and query tile
    (150, 8, True, torch.float32, 0.8),       # 150 = 2 x 64 + 22 keys
    (200, 16, True, torch.float32, "tile 1"),  # a whole key tile invalid between valid ones
    (8000, 32, False, torch.float32, 0.8),
    (129, 64, True, torch.float32, 0.8),      # the smallest streaming q: a block of 16 rows, 1 real
    (1000, 64, True, torch.float32, 0.8),     # ragged for a 32- and 128-row block and a 32-key tile
    (1000, 128, True, torch.float32, 0.8),    # d 128: its own instance (32 rows at most)
    (1000, 128, False, torch.bfloat16, 0.8),
    (960, 32, True, torch.bfloat16, 0.8)])
def test_cuda_attention_stream_matches_plain(card, n, d, fg, dtype, valid):
    """The streaming route (q > 128) at the self-attention form's shapes,
    with and without the online MSA's fg score, fp32 and bf16 q/k/v,
    ragged tiles and an invalid tile: one launch, 1e-5 from the plain
    version on the same inputs."""
    ins, fg_score = _stream_inputs(card, np.random.default_rng(31), 4, n, d, fg, dtype, valid)
    want = pfa.fused_dual_attention_plain(*ins, 25.0, fg_score)
    n0 = pfa.fused_dual_attention.launches
    got = pfa.fused_dual_attention(*ins, 25.0, fg_score)
    torch.cuda.synchronize()
    assert pfa.route(n) == "stream" and pfa.fused_dual_attention.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,n,d,bf16", [(1, 4, 960, 64, 0), (1, 4, 960, 32, 1),
                                          (1, 4, 8000, 32, 0), (1, 4, 16000, 64, 0),
                                          (1, 4, 1000, 128, 0), (2, 2, 129, 8, 0)])
def test_cuda_attention_stream_plan_is_the_launched_block(card, B, h, n, d, bf16):
    """The block `stream_plan` reckons (rows, key slices) is the one the
    CUDA entry point launches on this card, and at least one fits a SM."""
    import ctypes

    from tscd_torch.ops.kernels import library
    out = (ctypes.c_int * 8)()
    lib = library.load()
    library.check(lib, lib.tscd_fused_dual_attention_stream_config(B, h, n, d, bf16, out),
                  "stream config")
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert pfa.stream_plan(B, h, n, d, sms) == (out[0], out[7])
    assert out[1] == 32 * out[0] // 16 * out[7] and out[2] == -(-n // out[0])
    assert out[4] >= 1


@pytest.mark.cuda
def test_cuda_attention_stream_with_all_but_one_key_invalid(card):
    """Every row's mass on the one valid key; a row of all-invalid keys
    (a second batch element) uniform, as the plain version."""
    rng = np.random.default_rng(32)
    n = 300
    ins = [torch.from_numpy(a).to(card) for a in _attn_inputs(rng, 2, 2, n, n, 32)]
    ins[7] = torch.zeros(2, n, dtype=torch.bool, device=card)
    ins[7][0, 17] = True
    got = pfa.fused_dual_attention(*ins)
    want = pfa.fused_dual_attention_plain(*ins)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[2][0, :, :, 17], torch.ones(2, n, device=card))
    torch.testing.assert_close(got[2][1], torch.full((2, n, n), 1.0 / n, device=card))


@pytest.mark.cuda
def test_cuda_attention_stream_is_bit_identical_across_calls(card):
    ins, fg_score = _stream_inputs(card, np.random.default_rng(33), 4, 960, 64, True,
                                   torch.float32)
    first = pfa.fused_dual_attention(*ins, 25.0, fg_score)
    second = pfa.fused_dual_attention(*ins, 25.0, fg_score)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_online_stream_graph_replays_match_cpu(fp32_card):
    """The online path at the selftest size (P 8, a bank of 3 frames, 10
    frames: both rings wrap): the card's stream (CUDA graph replays after
    the first step) against the CPU's eager stream, frame by frame: the
    detections (masks and classes exactly, boxes 1e-4 of the frame's
    largest coordinate, the rest 1e-4) and every bank field (1e-4;
    pointers, counts and masks exactly)."""
    from tscd_torch.core.online import OnlineStream
    from tscd_torch.exp import get_exp_by_name
    from tscd_torch.models.tscd import random_init_
    exp = get_exp_by_name("yolov_selftest")
    sd = random_init_(exp.get_online_model(device="cpu"), exp.seed).state_dict()
    rng = np.random.default_rng(34)
    frames = rng.uniform(0, 255, (10, 64, 64, 3)).astype(np.float32)
    streams = {}
    for dev in ("cpu", fp32_card):
        model = exp.get_online_model(device=dev)
        model.load_state_dict(sd)
        streams[str(dev)] = OnlineStream(model, bank_frames=3)
    cpu, gpu = streams["cpu"], streams[str(fp32_card)]
    n0 = pfa.fused_dual_attention.launches
    for f, x in enumerate(frames):
        (want, use_want), (got, use_got) = cpu.step(x), gpu.step(x)
        assert bool(use_got) == bool(use_want) == (f >= 2), f
        assert torch.equal(got.mask.cpu(), want.mask) and torch.equal(got.cls_id.cpu(), want.cls_id), f
        # boxes 1e-4 of the frame's largest coordinate: x1 = cx - w / 2 cancels
        box_atol = 1e-4 * max(1.0, float(want.boxes.abs().max()))
        torch.testing.assert_close(got.boxes.cpu(), want.boxes, atol=box_atol, rtol=1e-4)
        for g, w in list(zip(got, want))[1:]:
            torch.testing.assert_close(g.cpu().float(), w.float(), atol=1e-4, rtol=1e-4)
        for name, g, w in zip(cpu.bank._fields, gpu.bank, cpu.bank):
            if w.is_floating_point():
                torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4, msg=name)
            else:
                assert torch.equal(g.cpu(), w), (f, name)
    # the first step runs eagerly and is captured (two wrapper calls); the
    # other nine are replays, which run no Python
    assert pfa.fused_dual_attention.launches == n0 + 2
    assert len(gpu._graphs) == 1


@pytest.mark.cuda
def test_cuda_nms_at_the_yolov_refined_postprocess_equals_plain(card):
    """postprocess_refined at YOLOV-L's window: 32 frames x 30 proposals x
    30 classes (K = 900, class-shifted), IoU 0.5: one launch of the NMS
    kernels, detections equal to the plain version's element for element."""
    from tscd_torch.ops.postprocess import postprocess_refined
    rng = np.random.default_rng(22)
    Fr, Pp, C = 32, 30, 30
    cxy = rng.uniform(40, 540, (Fr, Pp, 2))
    wh = rng.uniform(20, 160, (Fr, Pp, 2))
    boxes = torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32))
    obj = torch.from_numpy(rng.uniform(0, 1, (Fr, Pp)).astype(np.float32))
    cls = torch.from_numpy((rng.uniform(0, 1, (Fr, Pp, C)) ** 3).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(Fr, Pp)) > 0.1)
    n0 = pkn.nms_sorted.launches
    got = postprocess_refined(*(t.to(card) for t in (boxes, obj, cls, valid)), 0.001, 0.5)
    assert pkn.nms_sorted.launches == n0 + 1
    want = postprocess_refined(boxes, obj, cls, valid, 0.001, 0.5)
    assert int(want.mask.sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _demo_frames(tmp_path, n=6):
    import os
    import shutil
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tscd_torch", "data", "fixtures", "vid", "Data", "VID", "val", "fix0")
    for f in sorted(os.listdir(src))[:n]:
        shutil.copyfile(os.path.join(src, f), tmp_path / f)
    return str(tmp_path)


def _demo_ckpt(tmp_path, exp_name, online=False):
    from tscd_torch.exp import get_exp
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.checkpoint import save_checkpoint
    exp = get_exp(exp_name=exp_name)
    model = (exp.get_online_model if online else exp.get_model)(device="cpu")
    return save_checkpoint({"model": random_init_(model, 0).state_dict()}, str(tmp_path),
                           name=f"{exp_name}{'_online' if online else ''}.msgpack")


def _same_rows(got, want):
    """Each frame's rows as sets: classes exactly, boxes 1e-4 of the
    frame's largest coordinate, scores atol 1e-4, all rtol 1e-4."""
    n = 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        tol = 1e-4 * max(1.0, float(np.abs(w[:, :4]).max())) if len(w) else 0
        free = list(range(len(w)))
        for r in g:
            hit = next((i for i in free if w[i, 6] == r[6]
                        and np.allclose(w[i, :4], r[:4], atol=tol, rtol=1e-4)
                        and np.allclose(w[i, 4:6], r[4:6], atol=1e-4, rtol=1e-4)), None)
            assert hit is not None, r
            free.remove(hit)
            n += 1
    assert n > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tool", ["tscd_demo", "vid_demo", "yolov_demo_online"])
def test_cuda_demo_tools_equal_cpu(fp32_card, tmp_path, tool):
    """tscd_demo (selftest, traj_linking and --post), vid_demo
    (yolov_selftest, --post) and yolov_demo_online (yolov_selftest,
    --online-batch 4 over 6 frames: a full batch and a tail of 2) with
    --device cuda: each writes an .mp4 the port's reader parses, one JPEG
    sample a frame of the frame's size, and hands vis the detections the
    CPU port does (TF32 off)."""
    import importlib

    from tscd_torch.data.image import imdecode
    from tscd_torch.utils.video import read_mp4
    (tmp_path / "frames").mkdir()
    frames = _demo_frames(tmp_path / "frames")
    mod = importlib.import_module(f"tscd_torch.tools.{tool}")
    if tool == "tscd_demo":
        ckpt = _demo_ckpt(tmp_path, "selftest")
        extra = ["--exp", "selftest", "--post"]
        opts = ["traj_linking", "True"]
    elif tool == "vid_demo":
        ckpt = _demo_ckpt(tmp_path, "yolov_selftest")
        extra, opts = ["--exp", "yolov_selftest", "--post"], []
    else:
        ckpt = _demo_ckpt(tmp_path, "yolov_selftest", online=True)
        extra = ["--exp", "yolov_selftest", "--online-batch", "4", "--max-wait-ms", "1e9"]
        opts = []
    res = {dev: mod.main(["-c", ckpt, "--path", frames, "--device", dev, "--conf", "0.001",
                          "--output_dir", str(tmp_path / dev), *extra, *opts])
           for dev in ("cpu", "cuda")}
    if tool == "yolov_demo_online":
        assert res["cuda"]["batches"] == res["cpu"]["batches"] == [4, 2]
    _same_rows(res["cuda"]["dets"], res["cpu"]["dets"])
    m = read_mp4(res["cuda"]["path"])
    assert len(m["samples"]) == 6 and m["object_type"] == 0x6C
    for s, f in zip(m["samples"], res["cuda"]["frames"]):
        assert imdecode(s).shape == f.shape


def _maps_close(got, want, tol=1e-4):
    for k in want:
        w = want[k].float()
        err = float((got[k].float().cpu() - w).abs().max())
        assert err <= tol * float(w.abs().max()), f"{k}: {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("net,size", [("swin_w4", 128), ("swin_w7", 96), ("focalnet", 64)])
def test_cuda_swin_and_focalnet_match_cpu(fp32_card, net, size):
    """A small Swin (embed 32, depths 2 2 2 2: window 4 on 128 px, every
    window whole and shifted; window 7 on 96 px, padded maps and shrunk
    windows) and focalnet_tscd's flags at embed 16, seeded, on the card
    against the CPU port: each map within 1e-4 of its largest (TF32 off);
    a second call on the card reads its mask and index from the cache."""
    from tscd_torch.models import focalnet, swin
    from tscd_torch.models.tscd import random_init_
    if net == "focalnet":
        make = lambda: focalnet.build_focalnet("focalnet_tscd", embed_dim=16,  # noqa: E731
                                               depths=(2, 1, 2, 1))
    else:
        ws = int(net[-1])
        make = lambda: swin.SwinTransformer(32, (2, 2, 2, 2), (2, 2, 4, 4),  # noqa: E731
                                            window_size=ws)
    cpu = random_init_(make(), 7).eval()
    dev = make().to(fp32_card).eval()
    dev.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(8).uniform(0, 255, (2, size, size, 3))
                         .astype(np.float32))
    with torch.no_grad():
        want = cpu(x)
        got = dev(x.to(fp32_card))
        n = len(swin._STATIC)
        again = dev(x.to(fp32_card))
    _maps_close(got, want)
    assert all(torch.equal(again[k], got[k]) for k in got)
    assert len(swin._STATIC) == n


@pytest.mark.cuda
def test_cuda_swin_tscd_graph_replay_equals_eager(fp32_card):
    """The selftest TSCD on Swin_Tiny (128 px: the last stage's window
    shrunk to 4): a carried window as the window's CUDA graph equals the
    same window launched op by op, detections and bank; the wrappers
    count no launch in the replay, and the CPU port gives the same
    detections (1e-4, as sets)."""
    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp import selftest_exp
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops.position import get_timing_signal_1d
    exp = selftest_exp()
    exp.backbone_name = "Swin_Tiny"
    F, (H, W) = exp.lframe_val + exp.gframe_val, exp.test_size
    rng = np.random.default_rng(21)
    windows = [(torch.from_numpy(rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8)),
                torch.from_numpy(get_timing_signal_1d(np.arange(w, w + F)))) for w in range(2)]
    preds = {}
    for dev in ("cpu", "cuda"):
        model = random_init_(exp.get_model(device=dev), exp.seed)
        preds[dev] = make_predict_fn(model, exp.lframe_val, exp.gframe_val, exp.nmsthre,
                                     exp.test_conf)
    predict = preds["cuda"]
    _, state = predict.dispatch(*windows[0], False, None)        # captures
    counters = (pkn.nms_sorted, pfs.focus_stem, pfa.fused_dual_attention,
                pkh.linear_sum_assignment)
    n0 = [c.launches for c in counters]
    got = predict.dispatch(*windows[1], True, state)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == n0
    want = predict.dispatch_eager(*windows[1], True, state)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    _, cstate = preds["cpu"].dispatch(*windows[0], False, None)
    cpu_rows = preds["cpu"].materialize(preds["cpu"].dispatch(*windows[1], True, cstate)[0])
    _same_rows(predict.materialize(got[0]), cpu_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("O", [80, 96])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_focus_stem_at_the_p6_widths_matches_plain(card, O, out_dtype):
    """The stem at the P6 ELAN stems' widths (E6 and E6E 80 channels, D6
    96; at bf16 80 is not a multiple of the 32-channel chunk, so the last
    chunk is padded) on 2 x 1280 x 1280 frames (fp32 ones at fp32, uint8
    at bf16), at the tolerances above."""
    import chip_smoke
    rng = np.random.default_rng(19)
    x8 = rng.integers(0, 256, (2, 1280, 1280, 3), dtype=np.uint8)
    x = x8 if out_dtype == torch.bfloat16 else x8.astype(np.float32)
    ins = [torch.from_numpy(a).to(card) for a in (
        x, rng.normal(0, 0.1, (O, 12, 3, 3)).astype(np.float32),
        rng.uniform(0.5, 1.5, O).astype(np.float32),
        rng.normal(0, 0.5, O).astype(np.float32))]
    torch.backends.cudnn.allow_tf32 = False
    n0 = pfs.focus_stem.launches
    got = pfs.focus_stem(*ins, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert pfs.focus_stem.launches == n0 + 1
    assert got.dtype == out_dtype and got.shape == (2, O, 640, 640) and got.is_contiguous()
    want = pfs.focus_stem_plain(*ins, out_dtype)
    tol = chip_smoke.BF16_TOL if out_dtype == torch.bfloat16 else dict(atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [10, 100])
def test_cuda_hungarian_on_a_detr_cost_equals_plain(card, n_valid):
    """hungarian_match's cost at DETR's 100 queries (softmax prob, 5 L1,
    -2 IoU; the invalid gt columns at big = 1e4): col4row on the card
    equal to the CPU's plain solver, element for element."""
    from tscd_torch.models.decoder import hungarian_match
    rng = np.random.default_rng(20)
    args = [torch.from_numpy(a) for a in (
        rng.normal(size=(100, 81)).astype(np.float32),
        rng.uniform(0.1, 0.9, (100, 4)).astype(np.float32),
        rng.integers(0, 80, 100).astype(np.int32),
        rng.uniform(0.1, 0.9, (100, 4)).astype(np.float32), np.arange(100) < n_valid)]
    n0 = pkh.linear_sum_assignment.launches
    got = hungarian_match(*(a.to(card) for a in args))
    assert pkh.linear_sum_assignment.launches == n0 + 1
    assert torch.equal(got.cpu(), hungarian_match(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolov7", "yolov8"])
def test_cuda_yolov7_tiny_and_yolov8_match_cpu(fp32_card, name):
    """YOLOv7-tiny and YOLOv8 (depth 0.33, width 0.25), seeded: the card's
    decoded outputs within 1e-4 of the CPU port's largest (TF32 off), in
    eval mode on 2 x 64 x 64 frames and with train-mode BN on 2 x 256 x 256
    (at 64 px the stride-32 maps are 2 x 2, and BN over 8 values a channel
    turns the convs' fp32 summation noise into 1.7e-4 of the largest box
    coordinate)."""
    from tscd_torch.models.build import create_model
    from tscd_torch.models.tscd import random_init_
    kw = dict(arch="tiny") if name == "yolov7" else dict(depth=0.33, width=0.25)
    cpu = random_init_(create_model(name, num_classes=80, device="cpu", **kw), 22)
    dev = create_model(name, num_classes=80, device=fp32_card, **kw)
    dev.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(23)
    for train, size in ((False, 64), (True, 256)):
        x = torch.from_numpy(rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8))
        with torch.no_grad():
            want = cpu(x, train=train)["decoded"]
            got = dev(x.to(fp32_card), train=train)["decoded"].cpu()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# -- the int8 serving mode's kernels (csrc/int8_conv.cu) ---------------------

INT8_SHAPES = [   # F, C_in, H, W, C_out, k, stride, pad
    (2, 128, 36, 36, 128, 3, 1, 1), (2, 256, 36, 36, 128, 1, 1, 0),
    (2, 512, 36, 36, 512, 3, 2, 1),              # 36 -> 18, stride 2
    (3, 48, 17, 13, 72, 3, 1, 1),                # C_in 48, ragged M and N
    (2, 64, 20, 20, 40, 3, 1, 0),                # k 3 with pad 0, C_out 40
    (1, 1024, 18, 18, 1024, 1, 1, 0)]


def _int8_inputs(card, rng, F, C, H, W, N, k, dtype=torch.float32):
    x = torch.from_numpy(rng.normal(0, 2, (F, C, H, W)).astype(np.float32)).to(card, dtype)
    w = torch.from_numpy(rng.normal(0, 1, (N, C, k, k)).astype(np.float32)).to(card)
    s_w = torch.clamp_min(w.abs().amax((1, 2, 3)), 1e-8) / 127.0
    b = torch.from_numpy(rng.normal(0, 0.5, N).astype(np.float32)).to(card)
    return x, w, s_w, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_quantize_and_pack_match_plain(card, dtype):
    """The abs max, the quantize pass (dynamic and per-channel scales) and
    the weight packing equal their plain versions element for element."""
    rng = np.random.default_rng(31)
    x, w, s_w, _ = _int8_inputs(card, rng, 3, 48, 17, 13, 72, 3, dtype)
    amax = pq8.abs_max(x)
    assert torch.equal(amax.cpu(), x.cpu().abs().amax().float().reshape(1))
    n0 = pq8.quantize_int8_activation.launches
    for scale, mode in ((amax, "dynamic"), (x.float().abs().amax((0, 2, 3)) / 100.0, "channel")):
        got = pq8.quantize_int8_activation(x, scale, mode)
        assert torch.equal(got.cpu(), pq8.quantize_reference(x.cpu(), scale.cpu(), mode))
    assert pq8.quantize_int8_activation.launches == n0 + 2
    assert torch.equal(pq8.pack_int8_weight(w, s_w).cpu(), pq8.pack_reference(w.cpu(), s_w.cpu()))
    with pytest.raises(ValueError, match="contiguous"):
        pq8.quantize_int8_activation(x.transpose(2, 3), amax)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", INT8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_conv_matches_plain(card, shape, dtype):
    """The conv's int32 sums equal the plain version's exactly; the
    dequantized, activated output is within one ulp of the output dtype of
    the plain epilogue on the same sums (expf's last bit)."""
    F, C, H, W, N, k, stride, pad = shape
    rng = np.random.default_rng(F + C + k)
    x, w, s_w, b = _int8_inputs(card, rng, F, C, H, W, N, k, dtype)
    amax = pq8.abs_max(x)
    xq = pq8.quantize_int8_activation(x, amax)
    wq = pq8.pack_int8_weight(w, s_w)
    kw = dict(stride=stride, pad=pad, act="silu", out_dtype=dtype, amax=amax)
    n0 = pq8.int8_conv.launches
    acc = pq8.int8_conv(xq, wq, s_w, b, out_int32=True, **kw)
    want = pq8.int8_conv_reference(xq.cpu(), wq.cpu(), stride, pad)
    assert acc.dtype == torch.int32 and torch.equal(acc.cpu(), want)
    for act in ("silu", "lrelu", "id"):
        kw["act"] = act
        got = pq8.int8_conv(xq, wq, s_w, b, **kw).cpu().float()
        ref = pq8.epilogue_reference(acc, pq8.dynamic_scale(amax), s_w, b, act, dtype).cpu()
        ulp = torch.from_numpy(np.spacing(ref.float().abs().numpy()).astype(np.float32))
        if dtype == torch.bfloat16:
            ulp = ulp * 2.0 ** 16
        assert bool(((got - ref.float()).abs() <= ulp).all()), act
    assert pq8.int8_conv.launches == n0 + 4


@pytest.mark.cuda
def test_cuda_int8_selftest_window_matches_cpu(fp32_card):
    """The selftest TSCD in int8, dynamic and static (scales calibrated on
    the CPU), on the card against the CPU port's int8 (plain versions), by
    tests/test_torch_port_int8.py's rule: mean |card - CPU| within 0.1 of
    the CPU's mean |int8 - fp32|, max within its max, or within the CPU's
    own spread on frames an ulp off (a rounding flip, once set off by
    fp32 sums in another order, sets off others downstream), that spread
    counting up to 0.7 of the CPU's mean |int8 - fp32|
    (`chip_smoke.int8_spread_rule`)."""
    import chip_smoke
    chip_smoke.int8_small_part(torch)


# -- the kernels as torch ops, the QAT conv, export ------------------------------

@pytest.mark.cuda
def test_cuda_each_op_launches_its_kernel(card):
    """Each `tscd::` op on CUDA tensors is its kernel's launcher: its
    wrapper's count moves by one a call, and the result equals the
    wrapper's own (which goes through the same op)."""
    rng = np.random.default_rng(40)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(card)  # noqa: E731
    x = f(2, 16, 12, 3) * 50
    w3, scale, shift = f(8, 12, 3, 3), f(8).abs() + 0.5, f(8)
    boxes = torch.tensor([[[0., 0., 2., 2.], [0., 0., 2., 2.1], [5., 5., 6., 6.]]], device=card)
    valid = torch.ones(1, 3, dtype=torch.bool, device=card)
    cases = [(pfs.focus_stem, lambda: torch.ops.tscd.focus_stem(x, w3, scale, shift)),
             (pfs.focus_stem, lambda: torch.ops.tscd.focus_stem_bf16(x, w3, scale, shift)),
             (pkh.linear_sum_assignment, lambda: torch.ops.tscd.linear_sum_assignment(f(1, 5, 5))),
             (pkn.nms_sorted, lambda: torch.ops.tscd.nms_sorted(boxes, valid, 0.5)),
             (pkn.pack, lambda: torch.ops.tscd.nms_pack(boxes, 0.5)),
             (pq8.abs_max, lambda: torch.ops.tscd.int8_absmax(f(2, 40, 6, 5))),
             (pq8.quantize_int8_activation,
              lambda: torch.ops.tscd.int8_quantize(f(2, 40, 6, 5), f(40).abs() + 0.1, 1)),
             (pq8.pack_int8_weight,
              lambda: torch.ops.tscd.int8_quantize(f(8, 40, 3, 3), f(8).abs() + 0.1, 2))]
    for wrapper, call in cases:
        n0 = wrapper.launches
        call()
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1, wrapper.__name__
    assert torch.equal(torch.ops.tscd.focus_stem(x, w3, scale, shift),
                       pfs.focus_stem(x, w3, scale, shift))
    assert torch.ops.tscd.nms_sorted(boxes, valid, 0.5).tolist() == [[True, False, True]]


@pytest.mark.cuda
@pytest.mark.parametrize("act,dtype", [("silu", torch.float32), ("lrelu", torch.float32),
                                       ("silu", torch.bfloat16)])
def test_cuda_int8_conv_ste_matches_reference(fp32_card, act, dtype):
    """The QAT conv on the card (`int8_conv_ste`, `_Int8ConvSTE`): its
    forward equals the dynamic serving route's launches bit for bit; its
    STE gradients (dx, dw, db) are within 1e-4 of the largest of
    `int8_conv_ste_reference`'s on the card at fp32 (the same cuDNN
    products; the recomputed pre-activation from exact int32 sums), and
    within 2^-7 of the largest at bf16, where the reference's
    pre-activation comes from cuDNN's fp32 conv, whose algorithms round,
    and a bf16 rounding flip of it moves a gradient by a bf16 ulp (3.1e-3
    of the largest, measured on an H100)."""
    rng = np.random.default_rng(41)
    card = fp32_card
    x = torch.from_numpy(rng.normal(0, 2, (2, 96, 20, 20)).astype(np.float32)).to(card, dtype)
    w = torch.from_numpy((rng.normal(0, 1, (64, 96, 3, 3)) / 30).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(0, 0.1, 64).astype(np.float32)).to(card)
    ins = [[t.clone().requires_grad_(True) for t in (x, w, b)] for _ in range(2)]
    n0 = pq8.int8_conv.launches
    y = pq8.int8_conv_ste(*ins[0], stride=1, pad=1, act=act, out_dtype=dtype)
    yr = pq8.int8_conv_ste_reference(*ins[1], 1, 1, act, dtype)
    with torch.no_grad():
        amax = pq8.abs_max(x)
        s_w = pq8.weight_scale(w)
        serve = pq8.int8_conv(pq8.quantize_int8_activation(x, amax), pq8.pack_int8_weight(w, s_w),
                              s_w, b, stride=1, pad=1, act=act, out_dtype=dtype, amax=amax)
    assert torch.equal(y.detach(), serve)
    g = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32)).to(card, dtype)
    y.backward(g)
    yr.backward(g)
    assert pq8.int8_conv.launches == n0 + 3        # forward, serving, the backward's recompute
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for a, r in zip(ins[0], ins[1]):
        assert float((a.grad.float() - r.grad.float()).abs().max()) <= \
            tol * float(r.grad.float().abs().max())


def _yolox_tiny():
    from tscd_torch.exp import get_exp
    exp = get_exp(None, "yolox_s")
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, 5
    exp.test_size = (128, 128)
    return exp


@pytest.mark.cuda
def test_cuda_int8_and_video_exports_equal_eager(fp32_card, tmp_path):
    """torch.export on the card: a small YOLOX's int8 forward (the C_in
    gate at 16) bit-equal to the eager port, and the selftest TSCD's
    streaming step equal to it over 2 windows, the state carried."""
    from tscd_torch.exp.tscd_large import selftest_exp
    from tscd_torch.models import blocks as pblk
    from tscd_torch.tools import export as ex
    old = pblk.INT8_MIN_CIN
    pblk.INT8_MIN_CIN = 16
    try:
        rec = ex.export(_yolox_tiny(), output=str(tmp_path / "i.pt2"), int8=True, raw=True,
                        device="cuda")
    finally:
        pblk.INT8_MIN_CIN = old
    assert rec["equal"] and "tscd.int8_conv.default" in rec["ops"]
    rec = ex.export(selftest_exp(), output=str(tmp_path / "v.pt2"), video=True, device="cuda")
    assert rec["equal"] and "tscd.linear_sum_assignment.default" in rec["ops"]


@pytest.mark.cuda
def test_cuda_aoti_runner_matches_port(fp32_card, tmp_path):
    """A small YOLOX exported --raw and compiled by AOTInductor, run by the
    C++ runner with the C++ ops: its detections on the synthetic image
    against the port's eager forward (TF32 off, as the runner runs)
    through the same decode and NMS, by chip_smoke.py's rule for YOLOX-L
    (`runner_against_port`: raw outputs within 1e-4 of the largest, count
    and classes equal, boxes within 1e-4 of their box's largest coordinate
    plus 0.01 px, scores 2e-4)."""
    import chip_smoke
    from tscd_torch.ops.kernels import library
    from tscd_torch.tools import export as ex
    from tscd_torch.utils import native
    exp = _yolox_tiny()
    out = str(tmp_path / "y.pt2")
    ex.export(exp, output=out, raw=True, device="cuda")
    package = ex.aoti_package(torch.export.load(out), ex.package_path(out))["package"]
    got = chip_smoke.runner_against_port(torch, exp, package, library.torch_ops_library(),
                                         native.aoti_runner(), fp32_card)
    assert got["pass"] and got["detections"] > 0, got


@pytest.mark.cuda
def test_cuda_torch_ops_library_equals_python_ops(card):
    """Each op of csrc/torch_ops.cpp (the stem at fp32 and bf16 from uint8
    and fp32 frames, the abs max, the quantize pass in its three modes,
    the conv with each scale kind, activation and output type), run in a
    process that loads only the op library as the runner does, equal bit
    for bit to the Python op on the same card inputs at YOLOX-L's export
    shapes (chip_smoke.py's `cxx_ops_against_python`)."""
    import chip_smoke
    from tscd_torch.ops.kernels import library
    got = chip_smoke.cxx_ops_against_python(torch, library.torch_ops_library(), card)
    assert len(got) == 16 and all(r["pass"] for r in got.values()), got


@pytest.mark.cuda
def test_cuda_select_proposals_equals_cpu(card):
    """select_proposals_batch on the card (the hand NMS) at its default
    pre_topk 750 over YOLOX's 8400 anchors at 640, ties in objectness and
    in the best class, equal field for field to the CPU port; the single-
    image form equal to its batch row."""
    from tscd_torch.ops import postprocess as ppost
    from tscd_torch.ops.kernels import nms as kn
    rng = np.random.default_rng(0)
    B, A, n_cls = 2, 8400, 30
    d = np.empty((B, A, 5 + n_cls), np.float32)
    d[..., :2] = rng.uniform(0, 640, (B, A, 2))
    d[..., 2:4] = rng.uniform(4, 120, (B, A, 2))
    d[..., 4] = rng.choice(np.linspace(0.05, 0.95, 19), (B, A))     # ties in objectness
    d[..., 5:] = rng.uniform(0, 1, (B, A, n_cls))
    d[:, :200, 5:] = 0.5                                             # ties in the best class
    want = ppost.select_proposals_batch(torch.as_tensor(d), n_cls)
    n0 = kn.nms_sorted.launches
    got = ppost.select_proposals_batch(torch.as_tensor(d, device=card), n_cls)
    assert kn.nms_sorted.launches == n0 + 1
    for field, g, w in zip(ppost.Proposals._fields, got, want):
        assert torch.equal(g.cpu(), w), field
    one = ppost.select_proposals(torch.as_tensor(d[1], device=card), n_cls)
    for g, w in zip(one, got):
        assert torch.equal(g, w[1])
