"""The port's kernel modules against the JAX package on the CPU.

Each wrapper takes its plain PyTorch version for a CPU tensor; these
tests hold the plain versions against the Pallas kernels (interpret mode)
and the JAX references, hold a numpy mirror of the CUDA attention's
split-over-keys arithmetic against the JAX reference and one of the CUDA
Hungarian solver's warp design (lane-owned columns, order-preserving
keys, two-stage warp minimum) against both JAX solvers, hold the NMS
kernels' plain version (through `nms_fixed` and
`batched_class_aware_nms`) against the JAX package's, also where IoUs sit
within an ulp of the threshold and at the class shift's coordinates, and
the pack's bit layout and arithmetic against the torch IoU's decisions,
and check that CPU calls never count a launch.
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
from tscd_tpu.ops import nms as jnms
from tscd_tpu.ops.boxes import pairwise_iou_xyxy as jiou
from tscd_tpu.ops.pallas import focus_stem as jfs
from tscd_tpu.ops.pallas.fused_attention import (dual_attention_reference,
                                                 fused_dual_attention as jfused)
from tscd_tpu.ops.pallas.hungarian import linear_sum_assignment_pallas
from tscd_torch.models.darknet import CSPDarknet
from tscd_torch.ops import hungarian as phu
from tscd_torch.ops.kernels import focus_stem as pfs
from tscd_torch.ops.kernels import fused_attention as pfa
from tscd_torch.ops import nms as pnms
from tscd_torch.ops.boxes import pairwise_iou_xyxy
from tscd_torch.ops.kernels import hungarian as pkh
from tscd_torch.ops.kernels import nms as pkn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


_KEY_PAST_N = np.uint32(0xFFFFFFFF)    # a slot past n: never the minimum
_COL_MASK = np.uint32(127)              # a column index in a packed key


def _order_key(x):
    """The CUDA solver's order-preserving uint32 key of fp32 values, -0.0
    canonicalised to +0.0 first (x + 0.0)."""
    b = (np.asarray(x, np.float32) + np.float32(0)).view(np.uint32)
    return b ^ np.where(b >> 31 == 1, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))


def _key_value(k):
    """The float whose key is k (the inverse of _order_key)."""
    k = np.uint32(k)
    return (k ^ (np.uint32(0x80000000) if k >> 31 else np.uint32(0xFFFFFFFF))
            ).view(np.float32)


def _warp_argmin(key, col):
    """The solver's argmin over a warp: key and col (S, 32), slot s of
    lane l holding column l + 32 s. One warp min of the keys, one of
    (key >> 7, column) packed in 32 bits: the first column of the minimal
    key's class of 128 keys, which is the first minimal column unless
    that column's key is larger; then a third warp min, of the columns
    that hold the minimal key."""
    kmin = key.min()
    jmin = int(((key & ~_COL_MASK) | col.astype(np.uint32)).min() & _COL_MASK)
    if key[jmin >> 5, jmin & 31] != kmin:
        jmin = int(col[key == kmin].min())
    return kmin, jmin


def _warp_solver_mirror(cost):
    """numpy mirror of tscd_torch/csrc/hungarian.cu on one (n, n) cost:
    per-slot state (S, 32) as the lanes' registers hold it; row4col,
    col4row, the cost rows by assigned column (cbc) and the duals u by
    assigned column (ubc) as shared memory holds them; the same fp32
    operations."""
    f32 = np.float32
    n = cost.shape[0]
    S = -(-n // 32)
    col = np.arange(32)[None, :] + 32 * np.arange(S)[:, None]
    live = col < n
    jc = np.where(live, col, n - 1)
    key_inf = _order_key(np.inf)
    v = np.zeros((S, 32), f32)
    s_ubc = np.zeros(n, f32)
    s_cbc = np.zeros((n, n), f32)
    s_r4c, s_c4r = np.full(n, -1), np.full(n, -1)
    for cur in range(n):
        # lim: spc while a column remains, -inf once taken or past n
        spc, path = np.full((S, 32), np.inf, f32), np.full((S, 32), -1)
        lim = np.where(live, f32(np.inf), f32(-np.inf))
        key = np.where(live, key_inf, _KEY_PAST_N)
        i, crow, ui, mv = cur, cost[cur], f32(0), f32(0)
        while True:
            r = ((mv + crow[jc]) - ui) - v
            better = r < lim
            spc, lim = np.where(better, r, spc), np.where(better, r, lim)
            path = np.where(better, i, path)
            key = np.where(better, _order_key(r), key)
            kmin, jmin = _warp_argmin(key, col)
            mv = _key_value(kmin)
            lim[jmin >> 5, jmin & 31] = -np.inf
            key[jmin >> 5, jmin & 31] = key_inf
            nxt = s_r4c[jmin]
            if nxt < 0:
                sink = jmin
                break
            i, crow, ui = nxt, s_cbc[jmin], s_ubc[jmin]
        # u of each visited row but cur, held by its taken column as ubc
        done = live & (lim == -np.inf)
        v = v - np.where(done, mv - spc, f32(0))
        other = done & (s_r4c[jc] >= 0)
        s_ubc[col[other]] = s_ubc[col[other]] + (mv - spc[other])
        s_path = path.ravel()[:n]
        j = sink
        while True:
            ii = s_path[j]
            next_j = s_c4r[ii]
            uu = f32(0) + mv if ii == cur else s_ubc[next_j]
            s_r4c[j], s_c4r[ii], s_ubc[j] = ii, j, uu
            s_cbc[j] = cost[ii]
            if ii == cur:
                break
            j = next_j
    return s_c4r.astype(np.int32)


def _near_tie_cost(rng, n=50):
    return (np.float32(1) + rng.integers(0, 4, (n, n)).astype(np.float32)
            * np.float32(2.0 ** -23))


def _sequence_start_cost(monkeypatch, n=50):
    """The cost the matcher hands the solver at a sequence start: every
    bank row invalid, every proposal valid, through
    masked_linear_sum_assignment."""
    kept = []

    def keep(cost):
        kept.append(cost.clone())
        return torch.zeros(cost.shape[:2], dtype=torch.int32)

    monkeypatch.setattr(phu, "linear_sum_assignment", keep)
    rand = torch.from_numpy(np.random.default_rng(12).uniform(0, 2, (n, n)).astype(np.float32))
    phu.masked_linear_sum_assignment(rand, torch.zeros(n, dtype=torch.bool),
                                     torch.ones(n, dtype=torch.bool))
    return kept[0][0].numpy()


@pytest.mark.parametrize("case", ["random50", "sequence_start", "ties",
                                  "signed_zero_tie", "near_ties", "n1", "n33",
                                  "n128"])
def test_warp_solver_mirror_matches_jax(case, monkeypatch):
    rng = np.random.default_rng(13)
    if case == "random50":
        c = rng.uniform(0, 2, (50, 50)).astype(np.float32)
    elif case == "sequence_start":
        c = _sequence_start_cost(monkeypatch)
        assert (c == np.float32(1e4)).all()
    elif case == "ties":
        c = _tie_cost()
    elif case == "signed_zero_tie":
        # zeros of both signs tie for each row's minimum; from duals that
        # start at +0.0 the first add (mv + c, mv = +0.0) already turns
        # -0.0 into +0.0, so the key's canonicalisation is held apart in
        # test_warp_argmin_ties_signed_zeros_like_jax
        c = np.ones((40, 40), np.float32)
        c[:, 7] = 0.0
        c[:, 33:37] = -0.0
    elif case == "near_ties":
        # reduced costs a few ulps apart: the packed minimum's class holds
        # several keys, so the third warp minimum decides
        c = _near_tie_cost(rng)
    else:
        n = int(case[1:])
        c = rng.normal(size=(n, n)).astype(np.float32)
    got = _warp_solver_mirror(c)
    want = np.asarray(jhu.linear_sum_assignment(jnp.asarray(c), use_pallas=False))
    assert np.array_equal(got, want)
    pal = np.asarray(linear_sum_assignment_pallas(jnp.asarray(c), interpret=True))
    assert np.array_equal(got, pal)


def test_warp_argmin_ties_signed_zeros_like_jax():
    """-0.0 at column 40 and +0.0 at column 7 tie: the first index wins,
    as in the JAX argmin, though -0.0's raw bits order below +0.0's."""
    vals = np.full(64, 3.0, np.float32)
    vals[40], vals[7] = -0.0, 0.0
    col = np.arange(64).reshape(2, 32)
    kmin, jmin = _warp_argmin(_order_key(vals).reshape(2, 32), col)
    assert jmin == int(jnp.argmin(jnp.asarray(vals))) == 7
    assert _key_value(kmin) == 0.0 and not np.signbit(_key_value(kmin))
    vals[[3, 35]] = [0.5, -1.0]
    kmin, jmin = _warp_argmin(_order_key(vals).reshape(2, 32), col)
    assert jmin == int(jnp.argmin(jnp.asarray(vals))) == 35
    assert _key_value(kmin) == np.float32(-1.0)
    ranks = np.argsort(_order_key(vals), kind="stable")
    assert np.array_equal(vals[ranks], np.sort(vals, kind="stable"))


@pytest.mark.parametrize("kind", ["random", "constant"])
def test_hungarian_plain_equals_jax_xla_past_128(kind):
    """Past n = 128 the JAX package runs its XLA lowering; the plain
    version (and so the card's block kernel, held against it on the card)
    equals it element for element."""
    n = 129
    rng = np.random.default_rng(12)
    c = (rng.uniform(0, 2, (n, n)) if kind == "random"
         else np.full((n, n), 1e4)).astype(np.float32)
    got = pkh.linear_sum_assignment(torch.from_numpy(c[None]))[0].numpy()
    want = np.asarray(jhu.linear_sum_assignment(jnp.asarray(c), use_pallas=False))
    assert np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))


def nms_chain(K):
    """Boxes in score order where box i overlaps box i + 1 only (IoU 0.54
    against 0.25 for box i + 2): the walk keeps every other box, and the
    fixed point needs K steps to settle."""
    x = np.arange(K, dtype=np.float32) * 0.3
    boxes = np.stack([x, np.zeros(K), x + 1, np.ones(K)], -1).astype(np.float32)
    return boxes, np.linspace(1, 0, K).astype(np.float32), np.ones(K, bool)


def nms_ties(K, seed=13):
    """Boxes on a coarse grid, some identical, and scores of 8 levels, so
    the score order's ties (to the lower slot) and exact overlaps decide."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 40, (K, 2)) * 8.0
    wh = rng.integers(2, 8, (K, 2)) * 8.0
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[1::7] = boxes[0::7][:len(boxes[1::7])]
    scores = (rng.integers(0, 8, K) / 8).astype(np.float32)
    return boxes, scores, rng.uniform(size=K) > 0.2


def nms_near_threshold(K, thr, seed=14):
    """K / 2 pairs of boxes whose IoU sits within a few fp32 ulps of the
    threshold (chip_smoke.near_threshold_boxes), random scores."""
    import chip_smoke
    rng = np.random.default_rng(seed)
    boxes = chip_smoke.near_threshold_boxes(rng, K // 2, thr)
    return boxes, rng.uniform(size=K).astype(np.float32), np.ones(K, bool)


def near_threshold_pairs(boxes, thr):
    """How many (i, j) pairs have an fp32 IoU (torch's) one ulp above,
    at, or one ulp below the threshold."""
    iou = pairwise_iou_xyxy(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    t = np.float32(thr)
    return [int((iou == v).sum()) for v in (np.nextafter(t, np.float32(1)), t,
                                            np.nextafter(t, np.float32(0)))]


@pytest.mark.parametrize("case", ["chain", "ties", "near_threshold_0.5",
                                  "near_threshold_0.45"])
def test_nms_plain_walk_matches_jax_scan(case):
    """nms_fixed (the plain version on the CPU) against JAX's nms_fixed,
    elementwise equal: a chain that needs K steps, ties, and IoUs within
    an ulp of the threshold (0.5, and 0.45, which fp32 rounds)."""
    K = 1500
    thr = float(case.split("_")[-1]) if case.startswith("near") else 0.5
    boxes, scores, valid = {"chain": nms_chain, "ties": nms_ties}.get(
        case, lambda K: nms_near_threshold(K, thr))(K)
    if case.startswith("near"):
        assert min(near_threshold_pairs(boxes, thr)) >= 10
    got = pnms.nms_fixed(*(torch.from_numpy(a[None]) for a in (boxes, scores, valid)),
                         thr)[0].numpy()
    want = np.asarray(jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                                     jnp.asarray(valid), thr))
    assert np.array_equal(got, want)
    if case == "chain":
        assert np.array_equal(got, np.arange(K) % 2 == 0)
    assert 0 < got.sum() < valid.sum()


def test_nms_class_shifted_matches_jax():
    """batched_class_aware_nms on postprocess_refined's (proposal, class)
    pairs at P = 50, C = 30 (near-threshold proposal pairs, so that the
    rounding at the shifted coordinates decides) against JAX's, per
    frame, elementwise equal."""
    import chip_smoke
    rng = np.random.default_rng(15)
    frames = [chip_smoke.class_pairs(rng) for _ in range(2)]
    boxes, scores, cls, valid = (np.stack(a) for a in zip(*frames))
    shifted = pnms.class_shift(*map(torch.from_numpy, (boxes, cls, valid)))
    assert float(shifted.max()) > 10000          # coordinates of the shift's size
    assert sum(near_threshold_pairs(shifted[0].numpy(), 0.5)) > 0
    got = pnms.batched_class_aware_nms(*map(torch.from_numpy, (boxes, scores, cls, valid)),
                                       0.5).numpy()
    for b in range(2):
        want = np.asarray(jnms.batched_class_aware_nms(
            *(jnp.asarray(a[b]) for a in (boxes, scores, cls, valid)), 0.5))
        assert np.array_equal(got[b], want)
        assert 0 < got[b].sum() < valid[b].sum()


def _iou_decisions_as_nms_cu(boxes, thr):
    """numpy mirror of nms.cu's arithmetic (fp32, one rounding an
    operation, in its order: each box's area once, then for row i and
    column j the clamped overlap, (area_i + area_j) - inter, + eps, the
    division, `>` the fp32 threshold), for every (i, j)."""
    f = np.float32
    a, b = boxes[:, None, :], boxes[None, :, :]
    area = (np.maximum(boxes[:, 2] - boxes[:, 0], f(0))
            * np.maximum(boxes[:, 3] - boxes[:, 1], f(0)))
    w = np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), f(0))
    h = np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), f(0))
    inter = w * h
    union = (area[:, None] + area[None, :]) - inter
    return inter / (union + f(1e-16)) > f(thr)


@pytest.mark.parametrize("case", ["near_threshold", "class_shifted", "ragged"])
def test_nms_pack_bits_equal_torch_iou(case):
    """The plain pack's tiles, unpacked, are `pairwise_iou_xyxy(...) > thr`
    below the diagonal bit for bit, and nms.cu's arithmetic, mirrored in
    numpy, makes the same decisions as the torch IoU (and JAX's eager
    IoU): near the threshold, at the class shift's coordinates, and at a
    K that leaves a ragged row block."""
    import chip_smoke
    rng = np.random.default_rng(16)
    if case == "near_threshold":
        boxes = np.stack([chip_smoke.near_threshold_boxes(rng, 400, 0.5) for _ in range(2)])
    elif case == "class_shifted":
        frames = [chip_smoke.class_pairs(rng) for _ in range(2)]
        b, _, cls, valid = (torch.from_numpy(np.stack(a)) for a in zip(*frames))
        boxes = pnms.class_shift(b, cls, valid).numpy()
    else:
        boxes = chip_smoke.near_threshold_boxes(rng, 35, 0.5)[None, :69]
    B, K = boxes.shape[:2]
    tb = torch.from_numpy(np.ascontiguousarray(boxes))
    tiles = pkn.pack(tb, 0.5)
    nb = (K + 31) // 32
    assert tiles.shape == (B, nb * (nb + 1) // 2, 32) and tiles.dtype == torch.int32
    iou = pairwise_iou_xyxy(tb, tb)
    want = (iou > 0.5) & torch.ones(K, K, dtype=torch.bool).tril(-1)
    assert torch.equal(pkn.unpack(tiles, K), want)
    for b in range(B):
        assert np.array_equal(_iou_decisions_as_nms_cu(boxes[b], 0.5), (iou[b] > 0.5).numpy())
        jax_iou = np.asarray(jiou(jnp.asarray(boxes[b]), jnp.asarray(boxes[b])))
        assert np.array_equal(jax_iou > np.float32(0.5), (iou[b] > 0.5).numpy())


def test_nms_sorted_rejects_what_the_kernels_do_not_take():
    boxes = torch.rand(1, 8, 4)
    valid = torch.ones(1, 8, dtype=torch.bool)
    for bad in ((boxes.double(), valid), (boxes[..., :3], valid),
                (boxes, valid[:, :7]), (boxes, valid.int())):
        with pytest.raises(ValueError):
            pkn.nms_sorted(*bad, 0.5)
    with pytest.raises(ValueError):
        pkn.pack(boxes.half(), 0.5)


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
                pfs.focus_stem, pkn.nms_sorted, pkn.pack)
    before = [c.launches for c in counters]
    pfa.fused_dual_attention(*map(torch.from_numpy,
                                  _attn_inputs(rng, 1, 2, 4, 8, 8)))
    pkh.linear_sum_assignment(torch.rand(1, 4, 4))
    pfs.focus_stem(*map(torch.from_numpy, _stem_inputs(rng, 1, 32, 32, 8)))
    boxes = torch.tensor([[[0., 0., 2., 2.], [0., 0., 2., 2.1], [5., 5., 6., 6.]]])
    keep = pkn.nms_sorted(boxes, torch.ones(1, 3, dtype=torch.bool), 0.5)
    assert keep.tolist() == [[True, False, True]]
    pkn.pack(boxes, 0.5)
    assert [c.launches for c in counters] == before == [0, 0, 0, 0, 0]
