#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (`tscd_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the run exits non-zero):
  1. setup   build the three CUDA kernels from tscd_torch/csrc with nvcc;
             TF32 off for convs and matmuls (fp32 comparisons).
  2. kernels each kernel against its plain PyTorch version on the card,
             at main-path shapes, max abs diff beside its tolerance; then
             each kernel's time, its plain version's time, the nearest
             single PyTorch call's time and its bound.
  3. small   the selftest configuration (depth 0.33, width 0.125, P=6,
             1+3 frames, 128 px) with the same seeded weights through the
             port on the CPU (plain versions) and on the card (kernels),
             3 windows with carried matcher state: detections must match.
  4. full    TSCD-Large (depth 1.0, width 1.0, P=50, 1+31 frames, 576 px,
             seeded random weights) for 3 streamed windows after a warm-up
             window; one forward under CUDA's sync debug mode (it must
             wait on the device nowhere); per-window latency from CUDA
             events; launch counts of every kernel in those 3 windows;
             then one more window under torch.profiler for the device
             time by kernel.
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


def check_close(name, got, want, atol, rtol):
    import torch
    err = (got.double() - want.double()).abs().max().item()
    ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol))
    emit({"phase": "kernels", "check": name, "max_abs_err": err,
          "tolerance": {"atol": atol, "rtol": rtol}, "pass": ok})
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} beyond atol {atol} rtol {rtol}")
    return err


def kernel_phase(torch, dev):
    """Each kernel against its plain version at main-path shapes, then
    the timings. Returns {name: row of the kernels line}."""
    import numpy as np
    import torch.nn.functional as F

    from tscd_torch.ops.kernels import focus_stem as fs
    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.ops.kernels import hungarian as hu

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
    errs = []
    for case, vmask in (("20% invalid keys", valid),
                        ("all keys invalid", torch.zeros_like(valid))):
        a = args[:7] + (vmask,)
        got, want = fa.fused_dual_attention(*a), fa.fused_dual_attention_plain(*a)
        torch.cuda.synchronize()
        for g in got:
            if not torch.isfinite(g).all():
                raise AssertionError(f"attention ({case}): non-finite output")
        for part, g, w in zip(("out_cls", "out_reg", "attn"), got, want):
            errs.append(check_close(f"fused_dual_attention {case} {part}",
                                    g, w, atol=1e-5, rtol=1e-4))
    nbytes = 4 * (2 * B * h * q * d + 4 * B * h * k * d + B * k) + B * k \
        + 4 * (2 * B * h * q * d + B * h * q * k)
    flops = B * h * (2 * 2 * q * k * d + 2 * 2 * q * k * d)
    b_ms, b_by = bound(nbytes, flops)
    rows["fused_dual_attention"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(torch, lambda: fa.fused_dual_attention(*args), 200),
        plain_ms=cuda_ms(torch, lambda: fa.fused_dual_attention_plain(*args), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # -- Hungarian: one 50x50 matcher cost; exact -------------------------
    n = 50
    c50 = rng.uniform(0, 2, (n, n)).astype(np.float32)
    masked = rng.uniform(0, 2, (6, 6)).astype(np.float32)
    rv, cv = np.array([1, 1, 1, 1, 0, 0], bool), np.array([1, 1, 1, 0, 1, 0], bool)
    masked = np.where(rv[:, None] & cv[None], masked,
                      np.where(~rv[:, None] & ~cv[None], 0.0, 1e4)).astype(np.float32)
    tie = np.ones((8, 8), np.float32) - np.kron(np.eye(4), np.ones((2, 2))).astype(np.float32)
    herr = 0
    for case, c in (("50x50 random", c50), ("6x6 masked", masked),
                    ("8x8 ties", tie)):
        ct = t(c[None])
        got = hu.linear_sum_assignment(ct)
        want = hu.linear_sum_assignment_plain(ct)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max().item())
        herr = max(herr, diff)
        emit({"phase": "kernels", "check": f"hungarian {case}",
              "max_abs_err": diff, "tolerance": "elementwise equal",
              "pass": diff == 0})
        if diff:
            raise AssertionError(f"hungarian {case}: {got.tolist()} != {want.tolist()}")
    c50t = t(c50[None])
    steps = jv_steps(c50)
    # each Dijkstra step: 5 fp32 operations on each of the n columns
    b_ms, b_by = bound(4 * (n * n + n), 5 * n * steps)
    rows["hungarian"] = dict(
        max_abs_err=herr,
        ms=cuda_ms(torch, lambda: hu.linear_sum_assignment(c50t), 50),
        plain_ms=cuda_ms(torch, lambda: hu.linear_sum_assignment_plain(c50t), 2, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, dijkstra_steps=steps)

    # -- Focus stem: 4 frames for the check, 32 (the window) for time ----
    # fp32 sums of 108 taps over pixel values up to 255: 1e-4 relative
    O = 64
    w3 = t(rng.normal(0, 1 / np.sqrt(108), (O, 12, 3, 3)))
    scale = t(rng.uniform(0.5, 1.5, O))
    shift = t(rng.normal(0, 0.5, O))
    x4 = t(rng.uniform(0, 255, (4, 576, 576, 3)))
    got, want = fs.focus_stem(x4, w3, scale, shift), fs.focus_stem_plain(x4, w3, scale, shift)
    torch.cuda.synchronize()
    serr = check_close("focus_stem (4, 576, 576, 3)", got, want, atol=1e-3, rtol=1e-4)
    del x4, got, want
    x32 = t(rng.uniform(0, 255, (32, 576, 576, 3)))
    w6 = fs.rearrange_weight(w3, scale)
    x32_nchw = x32.permute(0, 3, 1, 2)       # channels_last view, no copy
    Fr, H, W = 32, 576, 576
    nbytes = 4 * (Fr * H * W * 3 + Fr * (H // 2) * (W // 2) * O + w3.numel() + 2 * O)
    flops = 2 * Fr * (H // 2) * (W // 2) * O * 108
    b_ms, b_by = bound(nbytes, flops)
    rows["focus_stem"] = dict(
        max_abs_err=serr,
        ms=cuda_ms(torch, lambda: fs.focus_stem(x32, w3, scale, shift), 20),
        plain_ms=cuda_ms(torch, lambda: fs.focus_stem_plain(x32, w3, scale, shift), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, lambda: F.conv2d(x32_nchw, w6, shift, stride=2,
                                                   padding=2), 20))
    return rows


def run_windows(torch, predict, exp, n_windows, seed, dev_sync):
    """Streams n_windows seeded windows; returns per-window Detections on
    the host and each window's latency in ms (CUDA events on the card)."""
    import numpy as np

    from tscd_torch.ops.position import get_timing_signal_1d
    rng = np.random.default_rng(seed)
    F = exp.lframe_val + exp.gframe_val
    H, W = exp.test_size
    state, dets, lat = None, [], []
    for w in range(n_windows):
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
    with carried state; returns launch counts over those 3 windows."""
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
    profile_window(torch, pred, exp)
    return launches


def profile_window(torch, pred, exp):
    """Device time by kernel over one more window (torch.profiler), and
    the window's device-busy time; its launches are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, lat, _ = run_windows(torch, pred, exp, 1, 7, True)
    # device-side events only (kernels, copies): a host op's entry sums the
    # kernels it launched; "Activity Buffer Request" is the profiler's own
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key != "Activity Buffer Request"),
                  key=lambda r: -r[1])
    emit({"phase": "profile", "window_ms": lat[0],
          "device_busy_ms": sum(r[1] for r in rows),
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
    launches = full_phase(torch, counters)

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
