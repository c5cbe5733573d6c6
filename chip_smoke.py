#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (`tscd_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the run exits non-zero):
  1. setup   build the CUDA kernels from tscd_torch/csrc with nvcc;
             TF32 off for convs and matmuls (fp32 comparisons).
  2. kernels each kernel against its plain PyTorch version on the card,
             at main-path shapes (the stem also at the selftest's width
             and a ragged shape; the attention also on the aggregation's
             strided views, and twice for bit-identical outputs; the
             Hungarian solver on a random cost, near ties, the sequence
             start's constant cost, n = 1, 33, 64, 128 and batches that
             span blocks, exactly), max abs diff beside its tolerance; then each
             kernel's device time (`ms`: its own CUDA kernels in
             torch.profiler over a loop of calls), the time of a call with
             its host work (`call_ms`, CUDA events), its plain version's
             time, the nearest single PyTorch call's time and its bound.
             The solver's bound is a latency bound: Dijkstra steps on the
             cost times the cycles of one step's dependent chain (each
             instruction's latency measured here by latency_probe.cu) over
             the card's maximum SM clock.
  3. small   the selftest configuration (depth 0.33, width 0.125, P=6,
             1+3 frames, 128 px) with the same seeded weights through the
             port on the CPU (plain versions) and on the card (kernels),
             3 windows with carried matcher state: detections must match.
  4. full    TSCD-Large (depth 1.0, width 1.0, P=50, 1+31 frames, 576 px,
             seeded random weights) for 3 streamed windows after a warm-up
             window; one forward under CUDA's sync debug mode (it must
             wait on the device nowhere); per-window latency from CUDA
             events; launch counts of every kernel in those 3 windows;
             then one more streamed window whose Hungarian costs are kept
             (the carried-state cost, checked and timed like the others),
             and one more under torch.profiler for the device time by
             kernel, and the copies made inside the attention's calls.
Prints one JSON line per phase, the card's name and power limit, the
`kernels` line, and last `{"ok": true, "device": {...}}`.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores

KERNELS = {
    "focus_stem": ("tscd_torch/csrc/focus_stem.cu",
                   "tscd_tpu/ops/pallas/focus_stem.py:138"),
    "fused_dual_attention": ("tscd_torch/csrc/fused_attention.cu",
                             "tscd_tpu/ops/pallas/fused_attention.py:109"),
    "hungarian": ("tscd_torch/csrc/hungarian.cu",
                  "tscd_tpu/ops/pallas/hungarian.py:111"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps, warmup=2):
    """Mean time of one call in ms, CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed(torch, fn, reps, kernel, warmup=2):
    """One call's times in ms: `ms`, the self device time of the CUDA
    kernels whose names hold `kernel`, from torch.profiler over `reps`
    calls; `call_ms`, CUDA events around `reps` back-to-back calls in a
    loop of their own (host work included, no profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call_ms = cuda_ms(torch, fn, reps, warmup)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and kernel in e.key]
    if not evs:
        raise AssertionError(f"no {kernel} kernel in the profile")
    return dict(ms=sum(e.self_device_time_total for e in evs) / 1e3 / reps,
                call_ms=call_ms)


def bound(nbytes, flops):
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_f = flops / H100_FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def jv_steps(cost):
    """Dijkstra steps the shortest-augmenting-path solver takes on `cost`
    (numpy mirror of the algorithm, for the data-dependent bound)."""
    import numpy as np
    n = cost.shape[0]
    u, v = np.zeros(n, np.float32), np.zeros(n, np.float32)
    row4col, col4row = np.full(n, -1), np.full(n, -1)
    steps = 0
    for cur in range(n):
        i, mv = cur, np.float32(0)
        rem, spc, path = np.ones(n, bool), np.full(n, np.inf, np.float32), np.full(n, -1)
        sr = np.zeros(n, bool)
        while True:
            steps += 1
            sr[i] = True
            r = mv + cost[i] - u[i] - v
            better = (r < spc) & rem
            spc[better], path[better] = r[better], i
            j = int(np.argmin(np.where(rem, spc, np.inf)))
            mv = spc[j]
            rem[j] = False
            if row4col[j] < 0:
                sink = j
                break
            i = row4col[j]
        other = sr & (np.arange(n) != cur)
        u[cur] += mv
        u[other] += mv - spc[col4row[other]]
        v[~rem] -= mv - spc[~rem]
        j = sink
        while True:
            i = path[j]
            row4col[j] = i
            col4row[i], j = j, col4row[i]
            if i == cur:
                break
    return steps


PROBE_REPS = 1024                 # REPS of tscd_torch/csrc/latency_probe.cu
PROBE_KINDS = ("lds", "fadd", "imad", "redux", "vote", "ffs")


def latencies(torch, lib):
    """Cycles of one dependent instruction of each kind, on this card
    (latency_probe.cu: chains of PROBE_REPS in one warp, clock64())."""
    import ctypes
    fn = lib.tscd_latency_probe
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    inp = torch.tensor([4 * k for k in range(32)] + [1, 0], dtype=torch.int32,
                       device="cuda")
    out = torch.zeros(len(PROBE_KINDS), dtype=torch.int64, device="cuda")
    sink = torch.empty(32, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):                    # the second run, warm
        rc = fn(inp.data_ptr(), out.data_ptr(), sink.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"latency probe launch failed: {rc}")
    torch.cuda.synchronize()
    return {k: c / PROBE_REPS for k, c in zip(PROBE_KINDS, out.tolist())}


def chain_cycles(lat, n):
    """Cycles of one Dijkstra step's dependent chain in hungarian.cu, with
    S = ceil(n / 32) columns a lane: the shared load of the step's cost
    row; 3 fp32 adds of r and the key's +0.0; the key's shift and xor,
    its select into the slot, the (key, column) packing and S - 1 integer
    minima over the lane's slots; redux.sync of the packed keys; the mask
    of the column and the multiply-add of the next row's address. The
    compare r < lim, the full key's warp minimum and the test of the
    packed minimum run beside it."""
    S = -(-n // 32)
    return lat["lds"] + 4 * lat["fadd"] + (S + 5) * lat["imad"] + lat["redux"]


def sm_clock_mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()
    return float(out[0])


def check_close(name, got, want, atol, rtol):
    import torch
    err = (got.double() - want.double()).abs().max().item()
    ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol))
    emit({"phase": "kernels", "check": name, "max_abs_err": err,
          "tolerance": {"atol": atol, "rtol": rtol}, "pass": ok})
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} beyond atol {atol} rtol {rtol}")
    return err


HUNGARIAN_BOUND = ("latency: Dijkstra steps on the cost x cycles of one step's "
                   "dependent chain (measured latencies) / max SM clock")


def check_hungarian(name, cost):
    """The kernel's col4row against the plain version's (on a host copy
    of the same costs): equal element for element."""
    from tscd_torch.ops.kernels import hungarian as hu
    got = hu.linear_sum_assignment(cost).cpu()
    want = hu.linear_sum_assignment_plain(cost.cpu())
    diff = int((got.long() - want.long()).abs().max().item())
    emit({"phase": "kernels", "check": name, "max_abs_err": diff,
          "tolerance": "elementwise equal", "pass": diff == 0})
    if diff:
        raise AssertionError(f"{name}: {got.tolist()} != {want.tolist()}")
    return diff


def hungarian_cost_row(torch, cost, lat, clock_mhz):
    """Device time and call time of the solver on one (1, n, n) cost,
    its Dijkstra steps and its latency bound."""
    from tscd_torch.ops.kernels import hungarian as hu
    n = cost.shape[-1]
    steps = jv_steps(cost[0].cpu().numpy())
    return dict(**timed(torch, lambda: hu.linear_sum_assignment(cost), 50,
                        "linear_sum_assignment"),
                dijkstra_steps=steps,
                bound_ms=steps * chain_cycles(lat, n) / (clock_mhz * 1e3))


def kernel_phase(torch, dev):
    """Each kernel against its plain version at main-path shapes, then
    the timings. Returns {name: row of the kernels line}."""
    import numpy as np
    import torch.nn.functional as F

    from tscd_torch.models.aggregation import DualBranchAttention, _split_heads
    from tscd_torch.ops import hungarian as hungarian_ops
    from tscd_torch.ops.kernels import focus_stem as fs
    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.ops.kernels import hungarian as hu
    from tscd_torch.ops.kernels import library

    rng = np.random.default_rng(0)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    rows = {}

    # -- fused dual attention: agg on TSCD-Large, one local frame ---------
    # fp32 with another summation order than the plain einsums: 1e-5
    B, h, q, k, d = 1, 4, 50, 1600, 64
    qc, qr = (t(rng.normal(size=(B, h, q, d))) for _ in range(2))
    kc, vc, kr, vr = (t(rng.normal(size=(B, h, k, d))) for _ in range(4))
    score = t(rng.uniform(0, 1, (B, k)))
    valid = t(rng.uniform(size=(B, k)) > 0.2, torch.bool)
    args = (qc, kc, vc, qr, kr, vr, score, valid)
    # the main path's layout: heads split out of Linear outputs, k and v
    # chunks of one buffer, as DualBranchAttention.attend makes them (a
    # generator of their own keeps the other kernels' inputs as they were)
    torch.manual_seed(0)
    att = DualBranchAttention(h * d, h).to(dev)
    rng_main = np.random.default_rng(1)
    x_cls, x_reg = (t(rng_main.normal(size=(B, k, h * d))) for _ in range(2))
    with torch.no_grad():
        k_cls, v_cls = att.kv_cls(x_cls).chunk(2, -1)
        k_reg, v_reg = att.kv_reg(x_reg).chunk(2, -1)
        main = (_split_heads(att.q_cls_local(x_cls[:, :q]), h),
                _split_heads(k_cls, h), _split_heads(v_cls, h),
                _split_heads(att.q_reg_local(x_reg[:, :q]), h),
                _split_heads(k_reg, h), _split_heads(v_reg, h), score, valid)
    # the kernel's last key chunk (32 keys) holds every valid key
    last = (torch.arange(k, device=dev) >= k - 32)[None].expand(B, k).contiguous()
    errs = []
    for case, a in (("20% invalid keys", args),
                    ("all keys invalid", args[:7] + (torch.zeros_like(valid),)),
                    ("valid keys in the last chunk only", args[:7] + (last,)),
                    ("main-path layout", main)):
        got, want = fa.fused_dual_attention(*a), fa.fused_dual_attention_plain(*a)
        torch.cuda.synchronize()
        for g in got:
            if not torch.isfinite(g).all():
                raise AssertionError(f"attention ({case}): non-finite output")
        for part, g, w in zip(("out_cls", "out_reg", "attn"), got, want):
            errs.append(check_close(f"fused_dual_attention {case} {part}",
                                    g, w, atol=1e-5, rtol=1e-4))
    again = fa.fused_dual_attention(*main)
    same = all(torch.equal(g, w) for g, w in zip(got, again))
    emit({"phase": "kernels", "check": "fused_dual_attention two calls",
          "tolerance": "bit-identical", "pass": same})
    if not same:
        raise AssertionError("fused_dual_attention: two calls differ")
    nbytes = 4 * (2 * B * h * q * d + 4 * B * h * k * d + B * k) + B * k \
        + 4 * (2 * B * h * q * d + B * h * q * k)
    flops = B * h * (2 * 2 * q * k * d + 2 * 2 * q * k * d)
    b_ms, b_by = bound(nbytes, flops)
    rows["fused_dual_attention"] = dict(
        max_abs_err=max(errs),
        **timed(torch, lambda: fa.fused_dual_attention(*main), 200,
                "fused_dual_attention"),
        plain_ms=cuda_ms(torch, lambda: fa.fused_dual_attention_plain(*main), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # -- Hungarian: the matcher's 50x50 costs and the edges; exact --------
    n = 50
    c50 = rng.uniform(0, 2, (n, n)).astype(np.float32)
    masked = rng.uniform(0, 2, (6, 6)).astype(np.float32)
    rv, cv = np.array([1, 1, 1, 1, 0, 0], bool), np.array([1, 1, 1, 0, 1, 0], bool)
    masked = np.where(rv[:, None] & cv[None], masked,
                      np.where(~rv[:, None] & ~cv[None], 0.0, 1e4)).astype(np.float32)
    tie = np.ones((8, 8), np.float32) - np.kron(np.eye(4), np.ones((2, 2))).astype(np.float32)
    const = lambda m: np.full((m, m), 1e4, np.float32)
    # reduced costs a few ulps apart: the packed warp minimum's class of
    # 128 keys holds more than the minimal key
    near = 1 + rng.integers(0, 4, (1, n, n)).astype(np.float32) * np.float32(2.0 ** -23)
    cases = [("50x50 random", c50[None]), ("6x6 masked", masked[None]),
             ("8x8 ties", tie[None]), ("50x50 sequence start", const(n)[None]),
             ("50x50 near ties", near)]
    for m in (1, 33, 64, 128):
        cases += [(f"{m}x{m} random", rng.normal(size=(1, m, m)).astype(np.float32)),
                  (f"{m}x{m} constant", const(m)[None])]
    # 5 matrices: more than a block's warps; 3 of 33x33: unaligned starts
    cases += [("5 x 50x50 batch", rng.uniform(0, 2, (5, n, n)).astype(np.float32)),
              ("3 x 33x33 batch", rng.uniform(0, 2, (3, 33, 33)).astype(np.float32))]
    herr = 0
    for case, c in cases:
        herr = max(herr, check_hungarian(f"hungarian {case}", t(c)))
    # the matcher's own route to the sequence start: an empty bank
    got = hungarian_ops.masked_linear_sum_assignment(
        t(c50), torch.zeros(n, dtype=torch.bool, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev))
    want = hu.linear_sum_assignment_plain(torch.as_tensor(const(n)[None]))[0]
    same = torch.equal(got.cpu(), want)
    emit({"phase": "kernels", "check": "hungarian sequence start via the masked cost",
          "tolerance": "elementwise equal", "pass": same})
    if not same:
        raise AssertionError("hungarian: the masked empty-bank cost differs")
    c50t = t(c50[None])
    again = [hu.linear_sum_assignment(c50t) for _ in range(2)]
    same = torch.equal(*again)
    emit({"phase": "kernels", "check": "hungarian two calls",
          "tolerance": "elementwise equal", "pass": same})
    if not same:
        raise AssertionError("hungarian: two calls differ")
    lat = latencies(torch, library.load())
    clock = sm_clock_mhz()
    costs = {"random": hungarian_cost_row(torch, c50t, lat, clock),
             "sequence_start": hungarian_cost_row(torch, t(const(n)[None]), lat, clock)}
    rows["hungarian"] = dict(
        max_abs_err=herr, **costs["random"],
        plain_ms=cuda_ms(torch, lambda: hu.linear_sum_assignment_plain(c50t), 2, 1),
        bound_by="operations", bound_model=HUNGARIAN_BOUND, library_ms=None,
        latency_cycles=lat, sm_clock_max_mhz=clock, costs=costs)

    # -- Focus stem: 4 frames for the check, 32 (the window) for time ----
    # fp32 sums of 108 taps over pixel values up to 255: 1e-4 relative.
    # Checked at TSCD-Large's width, the selftest's (O = 8) and a ragged
    # single frame whose last tiles are partly outside the image.
    serr = 0.0
    for (Fr, H, W), O in (((4, 576, 576), 64), ((4, 128, 128), 8), ((1, 70, 34), 16)):
        w3 = t(rng.normal(0, 1 / np.sqrt(108), (O, 12, 3, 3)))
        scale = t(rng.uniform(0.5, 1.5, O))
        shift = t(rng.normal(0, 0.5, O))
        xc = t(rng.uniform(0, 255, (Fr, H, W, 3)))
        got, want = fs.focus_stem(xc, w3, scale, shift), fs.focus_stem_plain(xc, w3, scale, shift)
        torch.cuda.synchronize()
        serr = max(serr, check_close(f"focus_stem ({Fr}, {H}, {W}, 3) -> {O}",
                                     got, want, atol=1e-3, rtol=1e-4))
        del xc, got, want
    O = 64
    w3 = t(rng.normal(0, 1 / np.sqrt(108), (O, 12, 3, 3)))
    scale = t(rng.uniform(0.5, 1.5, O))
    shift = t(rng.normal(0, 0.5, O))
    x32 = t(rng.uniform(0, 255, (32, 576, 576, 3)))
    w6 = fs.rearrange_weight(w3, scale)
    x32_nchw = x32.permute(0, 3, 1, 2)       # channels_last view, no copy
    Fr, H, W = 32, 576, 576
    nbytes = 4 * (Fr * H * W * 3 + Fr * (H // 2) * (W // 2) * O + w3.numel() + 2 * O)
    flops = 2 * Fr * (H // 2) * (W // 2) * O * 108
    b_ms, b_by = bound(nbytes, flops)
    rows["focus_stem"] = dict(
        max_abs_err=serr,
        **timed(torch, lambda: fs.focus_stem(x32, w3, scale, shift), 20,
                "focus_stem"),
        plain_ms=cuda_ms(torch, lambda: fs.focus_stem_plain(x32, w3, scale, shift), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, lambda: F.conv2d(x32_nchw, w6, shift, stride=2,
                                                   padding=2), 20))
    return rows


def run_windows(torch, predict, exp, n_windows, seed, dev_sync, state=None,
                first=0):
    """Streams n_windows seeded windows, numbered from `first` (window 0
    starts a sequence; later ones resume from `state`); returns
    per-window Detections on the host, each window's latency in ms (CUDA
    events on the card) and the carried state."""
    import numpy as np

    from tscd_torch.ops.position import get_timing_signal_1d
    rng = np.random.default_rng(seed)
    F = exp.lframe_val + exp.gframe_val
    H, W = exp.test_size
    dets, lat = [], []
    for w in range(first, first + n_windows):
        x = rng.uniform(0, 255, (F, H, W, 3)).astype(np.float32)
        te = get_timing_signal_1d(np.arange(w, w + F))
        if dev_sync:
            xd = torch.as_tensor(x, device="cuda")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            refined, state = predict.dispatch(xd, te, w > 0, state)
            end.record()
            end.synchronize()
            lat.append(start.elapsed_time(end))
        else:
            refined, state = predict.dispatch(x, te, w > 0, state)
        dets.append(refined)
    return dets, lat, state


def small_phase(torch):
    """CPU plain versions vs the card's kernels on the selftest config."""
    import numpy as np

    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp.tscd_large import selftest_exp
    from tscd_torch.models.tscd import random_init_
    exp = selftest_exp()
    out = {}
    for dev in ("cpu", "cuda"):
        model = random_init_(exp.get_model(device=dev), exp.seed)
        pred = make_predict_fn(model, exp.lframe_val, exp.gframe_val,
                               exp.nmsthre, exp.test_conf)
        dets, _, _ = run_windows(torch, pred, exp, 3, 1, False)
        out[dev] = [pred.materialize(d) for d in dets]
    # fp32 on both sides, other conv algorithms: 1e-4 relative. Rows are
    # matched as a set per frame: two scores equal to ~1e-7 may swap rank.
    atol = rtol = 1e-4
    worst, n = 0.0, 0
    for w, (frames_c, frames_g) in enumerate(zip(out["cpu"], out["cuda"])):
        for rows_c, rows_g in zip(frames_c, frames_g):
            if len(rows_c) != len(rows_g):
                raise AssertionError(f"small path window {w}: {len(rows_c)} "
                                     f"detections on the CPU, {len(rows_g)} on the card")
            free = list(range(len(rows_g)))
            for r in rows_c:
                hit = next((i for i in free if rows_g[i, 6] == r[6] and np.allclose(
                    rows_g[i, :6], r[:6], atol=atol, rtol=rtol)), None)
                if hit is None:
                    raise AssertionError(f"small path window {w}: no card detection matches {r}")
                free.remove(hit)
                worst = max(worst, float(np.abs(rows_g[hit, :6] - r[:6]).max()))
            n += len(rows_g)
    if n == 0:
        raise AssertionError("small path: no detections to compare")
    emit({"phase": "small", "windows": 3, "detections": n,
          "max_abs_err": worst, "tolerance": {"atol": atol, "rtol": rtol},
          "pass": True})


def full_phase(torch, counters):
    """TSCD-Large streaming eval: warm-up window, then 3 timed windows
    with carried state; returns launch counts over those 3 windows and the
    Hungarian costs of one more streamed window."""
    import numpy as np

    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp.tscd_large import Exp
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops.position import get_timing_signal_1d
    exp = Exp()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = random_init_(exp.get_model(), exp.seed)
    pred = make_predict_fn(model, exp.lframe_val, exp.gframe_val,
                           exp.nmsthre, exp.test_conf)
    run_windows(torch, pred, exp, 1, 100, True)            # warm-up
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    # the forward itself waits on the device nowhere (the NMS of the
    # postprocess does): any synchronising call in it raises here
    F = exp.lframe_val + exp.gframe_val
    x = torch.full((F, *exp.test_size, 3), 128.0, device="cuda")
    te = torch.as_tensor(get_timing_signal_1d(np.arange(F)), device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        model(x, te, exp.lframe_val, exp.gframe_val)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    dets, lat, state = run_windows(torch, pred, exp, 3, exp.seed, True)
    launches = {name: c.launches for name, c in counters.items()}
    rows = [pred.materialize(d) for d in dets]
    n_det = 0
    for per_frame in rows:
        if len(per_frame) != exp.lframe_val:
            raise AssertionError("one detection array per local frame expected")
        for r in per_frame:
            if r.ndim != 2 or r.shape[1] != 7 or not np.isfinite(r).all():
                raise AssertionError(f"bad detections {r.shape}")
            n_det += len(r)
    if not bool(state.has_state) or n_det == 0:
        raise AssertionError("full path produced no carried state or no detections")
    emit({"phase": "full", "config": "TSCD-Large 1+31 frames 576px P=50",
          "setup_s": setup_s, "window_ms": lat, "detections": n_det,
          "launches": launches, "forward_host_syncs": 0,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    state, carried = capture_costs(torch, pred, exp, state)
    profile_window(torch, pred, exp, state)
    return launches, carried


def carried_phase(torch, row, carried):
    """The solver on the costs of a streamed window with carried state:
    checked against the plain version and timed like the kernel phase's
    costs, into row["costs"]["carried_state"]."""
    for k, cost in enumerate(carried):
        check_hungarian(f"hungarian carried-state cost, local frame {k}", cost)
    row["costs"]["carried_state"] = hungarian_cost_row(
        torch, carried[0], row["latency_cycles"], row["sm_clock_max_mhz"])
    emit({"phase": "carried", "hungarian": row["costs"]["carried_state"]})


def capture_costs(torch, pred, exp, state):
    """Streams window 3, resumed from `state`, keeping a copy of every
    cost the matcher hands the solver (one a local frame); returns the
    new state and the costs. Its launches are not counted."""
    from tscd_torch.ops import hungarian
    solve, kept = hungarian.linear_sum_assignment, []

    def keep(cost):
        kept.append(cost.detach().clone())
        return solve(cost)

    hungarian.linear_sum_assignment = keep
    try:
        _, _, state = run_windows(torch, pred, exp, 1, 3, True, state, 3)
    finally:
        hungarian.linear_sum_assignment = solve
    if len(kept) != exp.lframe_val:
        raise AssertionError(f"{len(kept)} solver calls in a window, "
                             f"{exp.lframe_val} expected")
    return state, kept


KERNEL_CLASSES = (   # first match wins
    ("cuDNN implicit-GEMM convs", ("fprop", "implicit_convolve", "convolve_common")),
    ("cuDNN FFT convs", ("fft", "pointwise_mult_and_sum_complex")),
    ("cuDNN layout transposes", ("nhwcToNchw", "nchwToNhwc")),
    ("BatchNorm inference", ("bn_fw_inf",)),
    ("SiLU", ("silu_kernel",)),
    ("hand kernels", ("focus_stem_kernel", "fused_dual_attention",
                      "linear_sum_assignment")),
    ("frame upload", ("Memcpy HtoD",)),
)


def breakdown(table):
    """Device ms by kernel class over rows {"name", "ms"}."""
    out = {name: 0.0 for name, _ in KERNEL_CLASSES}
    out["the rest"] = 0.0
    for row in table:
        cls = next((name for name, keys in KERNEL_CLASSES
                    if any(k in row["name"] for k in keys)), "the rest")
        out[cls] += row["ms"]
    return out


def copies_under(event):
    """The copy ops (`aten::copy_`) below a profiled host event: their
    count and the device ms of the kernels they launched."""
    n, ms = 0, 0.0
    for child in event.cpu_children:
        if child.name == "aten::copy_":
            n, ms = n + 1, ms + child.device_time_total / 1e3
        else:
            cn, cms = copies_under(child)
            n, ms = n + cn, ms + cms
    return n, ms


def profile_window(torch, pred, exp, state):
    """Device time by kernel over one more window (torch.profiler),
    window 4 resumed from `state` (a video's first window comes once a
    video), and the window's device-busy time; its launches are not
    counted. Each attention call runs in a profiler range, so that the
    copies made inside it (of its inputs) are counted apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from tscd_torch.models import aggregation
    attend = aggregation.fused_dual_attention

    def ranged(*a, **kw):
        with record_function("aggregation attention call"):
            return attend(*a, **kw)

    aggregation.fused_dual_attention = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, lat, _ = run_windows(torch, pred, exp, 1, 7, True, state, 4)
    finally:
        aggregation.fused_dual_attention = attend
    # device-side events only (kernels, copies): a host op's entry sums the
    # kernels it launched; "Activity Buffer Request" is the profiler's own,
    # and the device side of a profiler range is no work of its own
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                   and e.key != "Activity Buffer Request"),
                  key=lambda r: -r[1])
    # every kernel and its class, for PERF.md's breakdown
    table = [{"name": k, "ms": ms, "calls": n} for k, ms, n in rows]
    by_class = breakdown(table)
    calls = [e for e in prof.events()
             if e.name == "aggregation attention call" and e.device_type == DeviceType.CPU]
    feed = [copies_under(e) for e in calls]
    attention = {"calls": len(calls),
                 "kernel_ms": sum(r["ms"] for r in table if "fused_dual_attention" in r["name"]),
                 "kernel_launches": sum(r["calls"] for r in table
                                        if "fused_dual_attention" in r["name"]),
                 "input_copies": sum(n for n, _ in feed),
                 "input_copy_ms": sum(ms for _, ms in feed)}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "profile_window.json"), "w") as f:
        json.dump({"by_class": by_class, "attention": attention, "kernels": table}, f)
    # cuDNN's layout transposes, paid where a conv's input and its chosen
    # algorithm disagree on the memory format
    emit({"phase": "profile", "sequence_start": False, "window_ms": lat[0],
          "device_busy_ms": sum(r[1] for r in rows),
          "transpose_ms": by_class["cuDNN layout transposes"],
          "attention": attention,
          "hungarian_ms": sum(r["ms"] for r in table if "linear_sum_assignment" in r["name"]),
          "top": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:15]]})


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tscd_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2

    from tscd_torch.ops.kernels import focus_stem as fs
    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.ops.kernels import hungarian as hu
    from tscd_torch.ops.kernels import library
    counters = {"focus_stem": fs.focus_stem,
                "fused_dual_attention": fa.fused_dual_attention,
                "hungarian": hu.linear_sum_assignment}

    t0 = time.time()
    library.load()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    emit({"phase": "setup", "build_s": time.time() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    rows = kernel_phase(torch, dev)
    small_phase(torch)
    launches, carried = full_phase(torch, counters)
    carried_phase(torch, rows["hungarian"], carried)

    expected = {"focus_stem": 3, "fused_dual_attention": 6, "hungarian": 3}
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name], **rows[name]}
        for name in ("focus_stem", "fused_dual_attention", "hungarian")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
