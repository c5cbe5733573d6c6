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
             the card's maximum SM clock. The NMS kernels (the fused IoU
             pack and the 32-box walk) on random boxes at K = 1500 and 50,
             a chain that needs K steps, all-invalid, identical boxes, tied
             scores, B = 1 and 3, IoUs within a few ulps of the threshold
             and postprocess_refined's class-shifted pairs: the keep mask
             exactly and the pack's bits bit for bit against the torch
             IoU's; the
             Hungarian solver past n = 128 (the block kernel) on random and
             constant costs at n = 129, 200 and 500 and through
             masked_linear_sum_assignment, exactly; both timed. The bf16
             variants: the stem reading uint8 frames and writing bf16 on
             the tensor cores (focus_stem_mma; within BF16_TOL, at the
             window's 32 frames too, with the ulps from the plain
             version counted, and the kernel's registers, spills, shared
             memory, blocks per SM and HMMA instructions printed) and the
             attention
             reading bf16 q/k/v (1e-5), checked and timed alike. The
             attention's backward at the training shape (B 4, h 4, q 50,
             k 650, d 64): the six q/k/v gradients through the wrapper's
             autograd path (kernel forward, plain recompute) against
             autograd of the plain version, 1e-5 of each gradient's max;
             forward + backward, backward alone (device time) and the
             plain forward + backward, timed; the same at bf16 q/k/v (the
             gradients bf16, 1e-5 beyond one bf16 ulp). The stem's backward
             at the training shape (16 x 576 x 576, 64 channels): the w3,
             scale and shift gradients through the wrapper's autograd rule
             (kernel forward, the VJP of the fp32 recompute) against
             autograd of the plain version, 1e-4; timed alike.
  3. small   the selftest configuration (depth 0.33, width 0.125, P=6,
             1+3 frames, 128 px) with the same seeded weights through the
             port on the CPU (plain versions) and on the card (kernels),
             3 windows with carried matcher state: detections must match.
  4. full    TSCD-Large (depth 1.0, width 1.0, P=50, 1+31 frames, 576 px,
             seeded random weights) for 3 streamed windows after a warm-up
             window; one whole dispatch (upload of pinned uint8 frames,
             the window's CUDA graph, copies of its outputs) under CUDA's
             sync debug mode (it must wait on the device nowhere);
             per-window latency from CUDA events and the launches of every
             kernel in those 3 windows, traced; then one more streamed window,
             dispatched eagerly, whose Hungarian costs are kept (the
             carried-state cost, checked and timed like the others) and
             whose NMS inputs are kept (the kernels checked on them, and
             the whole NMS stage timed alone on them: every launch of a
             batched_class_aware_nms call, inside a profiler range), and
             one more, eagerly, under torch.profiler for the device time by
             kernel, the copies made inside the attention's calls and the
             NMS stage's launches and device time (`nms_stage_ms`).
  5. bf16    TSCD-Large computing in bf16 with BN folded, on the full
             phase's weights: the max and 99.9th percentile of |raw
             outputs - fp32 raw outputs| on one window (by part, beside
             the fp32 values' size); on its first local and global frame,
             the card's bf16 raw outputs no farther from the bf16 port on
             the CPU than that is from fp32; a warm-up window and 3
             streamed windows, traced (window ms, launches, the replays'
             device time by kernel class); 10 windows back to back as
             graph replays and 5 launched eagerly (frames/s as F x
             windows / s and as evaluated local frames / s, device busy
             share, host ms a dispatch); the graph's window equal to the
             eager one; a sync-free dispatch; one window profiled eagerly
             by kernel class; the small kernels the stem's weight
             preparation adds to each window's graph, and their time.
  6. eval    the streaming evaluator on an in-memory dataset with
             VIDDataset's interface (seeded uint8 frames at the size
             load_frame gives a 720 x 1280 source, seeded ground truth):
             the selftest config on the CPU and on the card (detections
             and COCO stats must agree), then TSCD-Large at full width, in
             fp32 and in bf16 with BN folded, over 2 videos and 20 windows
             through WindowLoader(pin_memory=True) and the pipelined
             VIDEvaluator: evaluated frames/s, the evaluator's ms per
             frame, the mean window device time, the upload of one pinned
             uint8 window, the device's busy share of the evaluate loop
             and the host time a window outside dispatch/materialize;
             then the same evaluation again, traced, for the launches.
  7. files   frame files and JAX checkpoints, with no cv2 or flax: every
             frame of both fixtures (16 at 128 x 128, YOLOX_outputs/
             validate_ref/vid; 32 at 1280 x 720, tscd_torch/data/fixtures/
             vid) decoded by the port and held to the sha256 of cv2.imread's
             pixels recorded where cv2 exists; host ms a frame of decode,
             letterbox and HSV round trip (with the CPU's model) and the
             decode threads the bf16 evaluator needs; the eval CLI in
             process on the 128 px files from converted_ckpt.msgpack on the
             card and on the CPU (detections and stats 1e-4); the eval CLI
             on the 720p files with TSCD-Large (seeded weights, 1 + 31
             frames, 576 px), every window's kernels in the device trace;
             one augmented selftest epoch from files with multiscale, at
             the rule's sizes; the JAX trainer's selftest checkpoint
             (tscd_torch/data/fixtures/jax_selftest_ckpt.msgpack) resumed:
             EMA weights, momentum and update count restored, an epoch
             trained and evaluated.
  8. train_small  the selftest config: one stage-2 step (fix_bn, frozen
             backbone, SimOTA, TSCD losses, grouped SGD, EMA) from the same
             seeded weights and window, past warm-up, on the card machine's
             CPU and on the card: losses 1e-4 relative, parameter updates
             and EMA 1e-3 of the largest update beyond the fp32 spacing,
             the backbone bit-unchanged.
  9. train   TSCD-Large stage 2 through TSCDTrainer (4 + 12 frames at
             576 px, fp32, TF32 off) on the 720p fixture's JPEG files (8
             windows) as the recipe runs epoch 0 (warm-up, HSV jitter and
             flip): each step's losses and CUDA-event time beside each
             window's collate host ms, frames/s, peak memory, the wrappers'
             launches over the run, a checkpoint saved and loaded back; one
             more step under torch.profiler (the stem, attention forward and backward and
             solver launches in the device trace, the backward's
             recompute ms, the device busy share, the step's time by
             kernel class into build/profile_train_step.json) whose EMA is
             checked against the formula; the backbone bit-unchanged; the
             EMA weights evaluated on 8 in-memory val windows. Then the rest
             of JAX's trainer, each part TSCD-Large at 4 + 12 frames, 576 px:
     train_bf16  bench.py:section_train's step (bf16 with fp32 masters,
             LR 0.01, frozen backbone, stop_backbone_grad, fix_bn, bench's
             inputs): median step, frames/s as bench counts, peak memory,
             a traced step's launches and busy share; the selftest bf16 step
             card vs CPU, window by window, within BF16_SPREAD x that
             window's CPU bf16-to-fp32 distance (dense outputs, updates,
             EMA; the losses through their outputs).
     train_bn  fix_bn=False: the selftest step card vs CPU (1e-4), then
             fp32 steps (ms, peak memory, 0 stem launches in the trace).
     train_backbone_grad  stop_backbone_grad=False under fix_bn: the
             updates equal the stopped step's, the stem's backward calls and
             device ms; remat off and on (same gradients, less memory).
     train_window_batch  2 windows a step: the gradient the mean of the
             windows' own, LR x 2 (grad_accum is exact by construction).
 10. heads   the rest of JAX's TSCD head, and TSCD-Base: (a) the
             proposal-patch video towers (sparse_vid_towers) against the
             dense ones on TSCD-Large's seeded weights (the head's BN
             shifted off 0): the fp32 vid features within JAX's tolerance
             (rtol 1e-4, atol 1e-5; edge rtol 1e-3) at the model's
             proposals, the fp32 detections equal as sets within 1e-4,
             the bf16 features (BN folded) within BF16_SPREAD x the dense
             bf16 features' distance from fp32; at each dtype sparse and
             dense windows in turns as graph replays (5 each), then traced;
             (b) use_pre_nms at fp32: its (32, 750) NMS call in an eager
             window, then traced replays (3 NMS calls a window), the call
             checked and timed for the kernels line; (c) agg_type
             mca_aware at fp32, traced; (d) TSCD-Base (depth 0.33, width
             0.5): fp32 and bf16 windows traced and 10 back to back
             (frames/s), one fp32 stage-2 step of 4 + 12 frames; (e) a
             TSCD-Large fp32 step with cat_ota_fg: SimOTA once a step, in
             the head; (f) every branch at the selftest size, card against
             the card machine's CPU (1e-4; the cat_ota_fg step at
             train_small's bounds). The kernels line adds the NMS pair at
             (32, 750), the attention at TSCD-Base's head dim 32 (fp32 and
             bf16) and the stem writing 32 channels (fp32 and bf16), each
             checked against its plain version first.
 11. still   stage 1 of the OVIS recipe, still-image YOLOX: the port's
             warp of each OVIS fixture frame's mosaic canvas against the
             sha256 of cv2's (tscd_torch/data/fixtures/ovis/
             warp_sha256.json); the selftest size (depth 0.33, width
             0.125, 25 classes) card against the card machine's CPU (raw
             outputs 1e-4 of the largest, detections 1e-4 as sets, one
             train-mode-BN step at train_small's bounds); ovis_yolox_l at
             full width (640 px training, batches of 16) through Trainer
             for 8 steps on the fixture's JPEGs (6 with mosaic, mixup and
             the warp, 2 in the no-aug tail with L1): step ms (CUDA
             events), images/s, peak memory, the wrappers' launches (0:
             train-mode BN runs the conv route), one more step traced (busy
             share, build/profile_still_step.json); the EMA weights through
             COCOEvaluator at ovis_yolox_l's (576 px), yolox_l's (640) and
             yoloxl_ovis's (640 x 960) eval settings: ms an image, the stem
             and NMS launches a pass; the checkpoint phase ovis starts
             from (build/still_phase). The kernels line adds the stem at 8
             x 576 and 8 x 640 frames and the NMS pair at
             postprocess_dense's (8, 2048), IoU 0.65 and 0.5.
 12. ovis    stage 2 of the OVIS recipe: ovis_tscd_large (seeded weights)
             through OVISEvaluator on the fixture's val json (4 windows of
             8 + 24 frames at 576 px, decoded from the files): a window
             eagerly with its attention, solver and NMS inputs kept, the
             evaluation (window ms, local frames/s), then again with each
             window dispatched eagerly (the wrappers' counts: 8 solver
             launches a window); one ovis_tscd_large stage-2 step
             from still's checkpoint (its backbone and still-image head
             equal to stage 1's EMA weights), and a second from its state
             (both timed); ovis_selftest through the
             eval CLI, card against the card machine's CPU (1e-4). The
             kernels line adds the attention at B 8, the solver's and the
             NMS pair's OVIS rows, on that window's own inputs.
 13. yolov   the YOLOV family: (a) at the selftest size (64 px, P = 8)
             YOLOV, YOLOV++ msa + decouple_reg, v++_large's mca, v_plus_base's
             localagg and TSCD's localagg, card against the card machine's
             CPU (raw outputs 1e-4 of the largest, proposals exactly, the
             refined outputs 1e-4, localagg's aggregation in float64 on the
             CPU's inputs LOCALAGG_F64_TOL; the card's postprocess on the
             CPU's outputs, detections 1e-4 as sets);
             (b) yolov_l (0 + 32 frames at 576 px, P = 30: the attention at
             q = k = 960), v++_base_decoupleReg and v++_large windows at full
             width from seeded weights: 3 graph replays traced (each one's
             stem, attention and NMS launches and the attention's split
             grid from its own device trace), 5 back to back (window ms,
             frames/s, busy share); (c) vid_eval on the 720p fixture's files
             with yolov_l, then the evaluator again on its captured graph
             (local frames/s, busy share); (d) a YOLOV step at the selftest
             size card against CPU (losses 1e-4, updates 1e-3 of the
             largest), then yolov_l steps of 0 + 16 frames (ms, frames/s,
             peak memory). The kernels line adds the attention at q = k =
             960 (d 64 and 32) with its backward at q = k = 480 and the NMS
             at the refined postprocess's (32, 900), on yolov_l's window's
             own inputs; at 960 the attention takes the streaming route,
             and the split route is timed beside it on the same inputs.
 14. ovis_yolov_plus  OVIS YOLOV++ through the attention's streaming route:
             (a) YOLOV++ msa + decouple_reg at the selftest size with P =
             40 (q = k = 160, streaming on the card, plain on the CPU), card
             against CPU as (a) of phase 13; (b) ovis_v++_base_decoupleReg
             and ovis_v++_large_decoupleReg eval windows (0 + 32 frames at
             576 px, P = 500: q = k = 16000) from seeded weights: warm-up and
             capture, 2 graph replays traced (stem, 2 streaming attention
             launches and 1 NMS walk a window, the attention's grid), 3 back
             to back (window ms, frames/s, busy share), peak memory; (c)
             each exp's training step (0 + 16 frames: q = k = 8000, the
             backward the plain recompute's VJP): ms, peak memory, the
             attention's calls; (d) the NMS at the refined postprocess's
             (32, 12500) on the base window's own inputs, one launch at 32
             frames checked against the plain version in 2-frame chunks,
             timed.
 15. yolov_online  the online YOLOV path: (a) at the selftest size with
             the demo's bank of 31 frames, 96 moving frames through the
             card's OnlineStream (graph replays) and the CPU's (eager),
             frame by frame: detections as sets (boxes 1e-4 of the frame's
             largest coordinate), use_refined, every bank field (1e-4 of the largest; the rest exactly); (b) yolov_l
             online at 576 px (bank 31 x 30: the MSA at q = k = 960 with fg
             guidance) on seeded weights: per-frame latency frame in ->
             detections on the host (p50, p99), pipelined ms a frame, busy
             share, each frame's kernel launches from 4 traced replays, and
             4-frame windows through window_step (ms, frames/s, equal to 4
             single steps).
 16. backbones  the other backbones (`backbone_name`): (a) at the selftest
             sizes, TSCD on Swin_Tiny and on Focal and YOLOV on Swin_Tiny,
             card against the card machine's CPU over 2 carried windows
             (detections 1e-4 as sets), YOLOPAFPNP6 and YOLOPAFPN_ResNet on
             their features (1e-4 of each map's largest); (b) TSCD-Large
             (1 + 31 frames at 576 px) on Swin_Base at fp32 and at bf16 (the
             neck's and head's BN folded) and on Focal at fp32, yolov_l (0 +
             32) on Swin_Tiny: a warm-up window, 3 graph replays traced (the
             attention, solver and NMS launches from the device trace, no
             stem; no wrapper launch), 4 back to back (window ms, spread,
             frames/s, busy share, peak memory); (c) one TSCD-Large stage-2
             step on Swin_Base (4 + 12 frames, frozen backbone): finite
             losses and gradients. The kernels line adds each row's launches
             a window of these runs.
 17. zoo     the rest of the detector zoo: (a) YOLOv7-tiny, ELANNet W6 and
             E6E with their P6 neck, YOLOv8 (0.33, 0.25; decoded and the
             train-mode loss), the DETR decoder (set_criterion and each
             layer's col4row) and the layer zoo at small configs, card
             against the card machine's CPU; (b) at full width, each run
             counted (wrappers set to 0 before, read after: the NMS pair 1
             a YOLOv7 postprocess, the stem 1 a P6 forward, the solver 6
             a DETR criterion, nothing else) and timed with CUDA events:
             YOLOv7-L on 8 x 640 frames with postprocess_dense at fp32 and
             bf16, -tiny and -X; ELANNet + ELANFPNP6 W6, E6, D6, E6E on 2 x
             1280 frames at fp32 and W6, E6, D6 at bf16, the stem's output
             against focus_stem_plain and its device time at 64, 80 and 96
             channels; YOLOv8-L forward + decode (fp32, bf16) and a
             train-mode loss step (finite losses and gradients); the DETR
             criterion at DETR's sizes on YOLOv7-L's stride-32 map (each
             col4row equal to the plain solver's); DeformConv2d, CoordConv
             and DropBlock on 8 x 256 x 80 x 80; (c) the kernels at these
             shapes (rows `ZOO_ROWS`).
The kernels phase also checks the attention's streaming route (q > 128)
against its plain version: masks (all keys but one invalid, all
invalid), bit-identical calls, q = k = 960 at d 64 (fp32 and bf16 q/k/v,
with the online MSA's fg score; the split route timed beside it) and d 32,
8000 at d 32, 16000 at d 64 and 32, each timed with its bound (the
tensor cores' at 3 TF32 products a product, beside the fp32 FMA bound
and the design's floor) and the kernel's registers, spills and shared
memory at that shape.
On a card, `make_predict_fn(...).dispatch` runs each window as one
replayed CUDA graph, which runs no Python: the launches of a path are
counted in the device trace of torch.profiler (`traced_path`), with every
kernel wrapper's `.launches` set to 0 before and required to stay 0 (no
eager fallback).
Prints one JSON line per phase, the card's name and power limit, the
`kernels` line, and last `{"ok": true, "device": {...}}`.

    python3 chip_smoke.py --nms-stage

times the NMS stage alone on one TSCD-Large window's inputs and nothing
else, through entry points older commits have too: a copy of this script
in another commit's checkout times that commit's stage the same way.

    python3 chip_smoke.py --phase NAME        (NAME in PHASES)

builds the kernels and runs that phase alone (`train` with its four
parts; `ovis` after `still`, whose checkpoint it reads), printing its JSON lines with the checkout's path: run in two checkouts in turns (A B B A), in fresh
processes, it A/Bs one phase of two commits on one card. One phase runs
only so: `train_bf16_chain` chains bench.py's step (no reset) at fp32
and at bf16 and names the op behind the first non-finite gradient.
"""

import contextlib
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
H100_TF32_FLOPS = 495e12        # TF32 tensor cores, dense, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # bf16 tensor cores, dense

KERNELS = {
    "focus_stem": ("tscd_torch/csrc/focus_stem.cu",
                   "tscd_tpu/ops/pallas/focus_stem.py:138"),
    "fused_dual_attention": ("tscd_torch/csrc/fused_attention.cu",
                             "tscd_tpu/ops/pallas/fused_attention.py:109"),
    "hungarian": ("tscd_torch/csrc/hungarian.cu",
                  "tscd_tpu/ops/pallas/hungarian.py:111"),
    "nms": ("tscd_torch/csrc/nms.cu",
            "tscd_tpu/ops/nms.py:43-53 (IoU matrix and XLA scan, no Pallas kernel)"),
    "focus_stem_bf16": ("tscd_torch/csrc/focus_stem.cu",
                        "tscd_tpu/ops/pallas/focus_stem.py:138"),
    "fused_dual_attention_bf16": ("tscd_torch/csrc/fused_attention.cu",
                                  "tscd_tpu/ops/pallas/fused_attention.py:109"),
    "fused_dual_attention_stream": ("tscd_torch/csrc/fused_attention.cu",
                                    "tscd_tpu/ops/pallas/fused_attention.py:109"),
}
# each row's kernel as a device trace names its launches: substrings
# that must all be in the name (the bf16 attention is a template instance)
TRACE_NAMES = {
    "focus_stem": ("focus_stem_kernel<",),
    "fused_dual_attention": ("fused_dual_attention_split<float>",),
    "hungarian": ("linear_sum_assignment_",),
    "nms": ("nms_walk_rows",),
    "focus_stem_bf16": ("focus_stem_mma<",),
    "fused_dual_attention_bf16": ("fused_dual_attention_split<__nv_bfloat16>",),
    "fused_dual_attention_stream": ("fused_dual_attention_stream<float",),
}
# the second kernel of a call, launched once with each first one
PAIRED = {"fused_dual_attention_combine": ("fused_dual_attention",
                                           "fused_dual_attention_bf16"),
          "nms_pack_iou": ("nms",)}
# Two bf16 models of one fp32 model are two draws of rounding noise: at
# the selftest width on the CPU the port's distance from fp32 is 0.82x
# and 1.09x JAX's (max, p99.9 of |raw outputs|; BN folded: 0.95x, 0.96x),
# and the two models sit 0.97x and 1.27x JAX's distance apart (folded:
# 0.68x, 0.83x), as tests/test_torch_port_bf16.py's
# test_bf16_distance_from_fp32_like_jax prints them. The card's bf16
# model is held within twice the CPU port's distance.
BF16_SPREAD = 2.0
# fp32 sums in another order (the stem's floor, as its fp32 check), then
# rounded to bf16: one bf16 ulp is at most 2^-7 of the value
BF16_TOL = {"atol": 1e-3, "rtol": 2.0 ** -7}


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


# The lead-in's kernel (torch.cuda._sleep's spin), and its launches: on
# some of the H100's machines a trace loses the kernel records of its
# first moments (PERF.md §7), so every trace that counts or times kernels
# starts with these, waited for, and leaves them out of its tables. One
# machine lost up to 16 records at a trace's start, another 19 (PERF.md
# §6): 48 short spins and a long one.
LEAD_IN = "spin_kernel"
LEAD_IN_LAUNCHES = 49
# each trace's lead-in records lost, where it lost some
LEAD_IN_LOST = []


def lead_in(torch):
    """LEAD_IN_LAUNCHES - 1 short spins and one of about 10 ms, waited for."""
    for _ in range(LEAD_IN_LAUNCHES - 1):
        torch.cuda._sleep(1000)
    torch.cuda._sleep(20_000_000)
    torch.cuda.synchronize()


@contextlib.contextmanager
def traced(torch):
    """torch.profiler over the block, CPU and CUDA, after `lead_in`; the
    lead-in records the trace lost go on LEAD_IN_LOST."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        yield prof
    lost = LEAD_IN_LAUNCHES - sum(e.count for e in prof.key_averages()
                                  if e.device_type == DeviceType.CUDA and LEAD_IN in e.key)
    if lost:
        LEAD_IN_LOST.append(lost)


def trace_events(prof, path):
    """The events of a torch.profiler trace, from its chrome export
    (written to `path`; a trace exports once)."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def trace_kernels(evs):
    """Every device kernel of a trace's events (`trace_events`) in start
    order: name, the correlation id of its host launch (one
    cudaGraphLaunch for all of a replay's kernels) and grid."""
    ks = sorted((e for e in evs if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    return [{"name": e["name"], "corr": e["args"].get("correlation"),
             "grid": e["args"].get("grid")} for e in ks]


def launch_records(evs):
    """Each host launch of a trace's events (`trace_events`) in order, a
    kernel launch or a graph launch, with the names of the device kernels
    recorded for it: an empty list is a launch whose kernel record the
    trace lost."""
    kernels = {}
    for e in evs:
        if e.get("cat") == "kernel":
            kernels.setdefault(e["args"].get("correlation"), []).append(e["name"][:60])
    hosts = sorted((e for e in evs if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and ("LaunchKernel" in e["name"] or "GraphLaunch" in e["name"])),
                   key=lambda e: e["ts"])
    return [(e["name"], kernels.get(e["args"].get("correlation"), [])) for e in hosts]


def odd_replays(ks):
    """The kernels of each host launch of more than one kernel in a trace
    (`trace_kernels`; a graph replay's kernels share its cudaGraphLaunch's
    correlation id), held against the launch with the most: a replay runs
    every node of its graph, so a kernel a replay lacks is a record the
    trace lost. Returns the number of such launches and, for each that
    differs, its index, kernel count, and the names it lacks and adds."""
    from collections import Counter
    by_launch = {}
    for k in ks:
        by_launch.setdefault(k["corr"], []).append(k["name"][:80])
    groups = [Counter(g) for g in by_launch.values() if len(g) > 1]
    if not groups:
        return 0, []
    ref = max(groups, key=lambda g: sum(g.values()))
    return len(groups), [{"replay": i, "kernels": sum(g.values()),
                          "lacks": dict(ref - g), "adds": dict(g - ref)}
                         for i, g in enumerate(groups) if g != ref]


def timed(torch, fn, reps, kernel, warmup=2, attempts=3):
    """One call's times in ms: `ms`, the self device time of the CUDA
    kernels whose names hold `kernel`, from torch.profiler over `reps`
    calls (and `ms_by_kernel` where a call launches several); `call_ms`,
    CUDA events around `reps` back-to-back calls in a loop of their own
    (host work included, no profiler). Each matched kernel is launched
    once a call, so the trace must hold `reps` of each: one that holds
    fewer, or none at all, lost records (PERF.md §7) and is taken again,
    `attempts` times in all, before it raises. One that holds more
    raises at once."""
    from torch.autograd import DeviceType
    call_ms = cuda_ms(torch, fn, reps, warmup)
    for attempt in range(1, attempts + 1):
        with traced(torch) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel in e.key]
        counts = {e.key[:60]: e.count for e in evs}
        if evs and all(n == reps for n in counts.values()):
            break
        seq = launch_records(trace_events(prof, os.path.join(HERE, "build",
                                                             "trace_timed_incomplete.json")))
        emit({"phase": "trace", "timed": kernel, "reps": reps, "counts": counts,
              "attempt": attempt, "host_launches": len(seq),
              "lost_at": [i for i, (_, ks) in enumerate(seq) if not ks]})
        if any(n > reps for n in counts.values()) or attempt == attempts:
            raise AssertionError(f"{kernel}: {counts} launches in the trace of {reps} calls "
                                 f"({attempt} traces)")
    out = dict(ms=sum(e.self_device_time_total for e in evs) / 1e3 / reps,
               call_ms=call_ms)
    if attempt > 1:
        out["traces"] = attempt
    if len(evs) > 1:       # a call of several launches: each one's share
        out["ms_by_kernel"] = {e.key[:60]: e.self_device_time_total / 1e3 / reps
                               for e in evs}
    return out


def trace_launches(prof):
    """Launches of each row's kernel in a torch.profiler trace: the
    device's own record, so a CUDA graph's replayed kernels count too.
    Raises where a call's second kernel (the attention's combine, the NMS
    walk's pack) was not launched once with each first one."""
    from torch.autograd import DeviceType
    n = dict.fromkeys(TRACE_NAMES, 0)
    second = dict.fromkeys(PAIRED, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for row, keys in TRACE_NAMES.items():
            if all(k in e.key for k in keys):
                n[row] += e.count
        for name in PAIRED:
            if name in e.key:
                second[name] += e.count
    for name, rows in PAIRED.items():
        if second[name] != sum(n[r] for r in rows):
            raise AssertionError(f"{second[name]} {name} launches for "
                                 f"{sum(n[r] for r in rows)} calls of {rows}")
    return n


def window_launches(windows, lframe, bf16, nms=2):
    """Launches of each row's kernel in `windows` windows of the model:
    one stem, two attention calls, a solver a local frame, `nms` NMS walks
    (two in the postprocess; a third with the pre-NMS), of the variants of
    the model's compute dtype."""
    stem, attention = (("focus_stem_bf16", "fused_dual_attention_bf16") if bf16
                       else ("focus_stem", "fused_dual_attention"))
    want = dict.fromkeys(TRACE_NAMES, 0)
    want.update({stem: windows, attention: 2 * windows,
                 "hungarian": lframe * windows, "nms": nms * windows})
    return want


def traced_path(torch, counters, run, windows, lframe, bf16, nms=2, attempts=1, want=None):
    """Drives the main path, `run()` (`windows` windows, each dispatched
    as a replay of the window's CUDA graph), under torch.profiler, every
    wrapper's count set to 0 just before. Returns run()'s result, the
    launches of each row's kernel in the device trace, and the profile.
    Raises unless the trace holds each window's kernels (`window_launches`)
    and the wrappers counted none: a replay runs no Python, so a wrapper's
    launch there would be an eager fallback. A trace that holds fewer
    launches of some row and more of none is torch.profiler losing records
    (PERF.md §7): `run()` is traced again, `attempts` times in all, and the
    number of traces it took goes on `traced_path.attempts`. `want`, where
    given, is the launches of each row expected in place of a TSCD
    window's."""
    want = want or window_launches(windows, lframe, bf16, nms)
    for attempt in range(1, attempts + 1):
        for c in counters.values():
            c.launches = 0
        with traced(torch) as prof:
            out = run()
            torch.cuda.synchronize()
        wrapped = {name: c.launches for name, c in counters.items()}
        launches = trace_launches(prof)
        traced_path.attempts = attempt
        if launches == want and not any(wrapped.values()):
            return out, launches, prof
        n, odd = odd_replays(trace_kernels(trace_events(
            prof, os.path.join(HERE, "build", "trace_incomplete.json"))))
        emit({"phase": "trace", "incomplete": launches, "want": want, "attempt": attempt,
              "wrapper_launches": wrapped, "replays": n, "odd_replays": odd})
        lost = all(launches[k] <= n for k, n in want.items())
        if any(wrapped.values()) or not lost or attempt == attempts:
            raise AssertionError(f"launches in the trace {launches} != {want}, "
                                 f"or eager launches {wrapped}")


def bound(nbytes, *work):
    """The least time of a call in ms, and what sets it: the larger of its
    bytes over the memory rate and its operations, each part of the work
    a (flops, peak rate of their type) pair, the parts' times summed."""
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_f = sum(flops / rate for flops, rate in work) * 1e3
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
    if got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} against {want.dtype}")
    err = (got.double() - want.double()).abs().max().item()
    ok = bool(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol))
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


HUNGARIAN_BLOCK_BOUND = ("latency: Dijkstra steps x cycles of a block-wide step's least "
                         "dependent chain (2 shared loads, 3 fp32 adds, 2 warp minima, "
                         "2 integer operations; measured latencies) / max SM clock")
NMS_BOUND = ("latency: K dependent decisions x one integer operation (the measured imad "
             "latency) / max SM clock; beside it the bytes (boxes and valid in, keep out) "
             "and the IoUs' fp32 operations, both far below")
# fp32 operations of one IoU and its threshold in nms.cu: 2 max, 2 min, 2
# subtractions, 2 clamps, the product, 2 adds and a subtraction, the
# division and the compare (each box's area is computed once a tile)
NMS_IOU_OPS = 14
NMS_STAGE = "nms stage"


def block_chain_cycles(lat):
    """The least dependent chain of one Dijkstra step of any block-wide
    argmin: the step's row and min value from shared memory, the three
    adds of r, a warp minimum, its store and load across the warps and a
    second warp minimum (block barriers not counted)."""
    return 2 * lat["lds"] + 3 * lat["fadd"] + 2 * lat["redux"] + 2 * lat["imad"]


def nms_chain_cycles(lat):
    """One step's dependent chain of the earlier NMS walk design (one
    warp vote a box): the AND of the row's words with the keep words,
    __any_sync of it, the select that sets the box's bit. The bound of
    that design, kept beside the design-free one."""
    return lat["vote"] + 2 * lat["imad"]


def nms_bounds(B, K, lat, clock_mhz):
    """The least time of one NMS call on B frames of K boxes, in ms: the
    larger of its latency (K dependent decisions, one integer operation
    each; the frames run side by side), its bytes (boxes and valid flags
    read once, keep flags written once) and its operations (K (K - 1) / 2
    IoUs of NMS_IOU_OPS fp32 operations each); and the earlier vote-a-box
    design's bound."""
    lat_ms = K * lat["imad"] / (clock_mhz * 1e3)
    bytes_ms = B * (16 * K + 2 * K) / H100_BYTES_PER_S * 1e3
    ops = B * K * (K - 1) // 2 * NMS_IOU_OPS
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return dict(bound_ms=max(lat_ms, bytes_ms, ops_ms), bound_latency_ms=lat_ms,
                bound_bytes_ms=bytes_ms, bound_operations_ms=ops_ms, iou_operations=ops,
                bound_old_design_ms=K * nms_chain_cycles(lat) / (clock_mhz * 1e3))


def near_threshold_boxes(rng, n, thr, span=500.0):
    """n pairs of boxes (2 n, 4) fp32 whose IoU sits within a few fp32
    ulps of `thr`: the second box of a pair is the first shifted along x
    by w (1 - thr) / (1 + thr), then its x coordinates moved by up to 2
    ulps either way."""
    import numpy as np
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(10, 120, (n, 2))
    a = np.concatenate([xy, xy + wh], -1)
    b = a.copy()
    b[:, [0, 2]] += (wh[:, 0] * (1 - thr) / (1 + thr))[:, None]
    a, b = a.astype(np.float32), b.astype(np.float32)
    b[:, [0, 2]] += rng.integers(-2, 3, (n, 2)).astype(np.float32) * np.spacing(b[:, [0, 2]])
    return np.stack([a, b], 1).reshape(2 * n, 4)


def class_pairs(rng, P=50, C=30, conf=0.001):
    """(boxes, scores, class ids, valid) (P C,) as postprocess_refined
    hands them to batched_class_aware_nms at TSCD-Large's P and C: P
    proposals at 576 px (near-threshold pairs), each with every class;
    key obj x prob, valid where prob and key reach `conf`."""
    import numpy as np
    boxes = near_threshold_boxes(rng, P // 2, 0.5, span=440.0)
    obj = rng.uniform(size=P).astype(np.float32)
    prob = (rng.uniform(size=(P, C)) ** 4).astype(np.float32)
    key = np.repeat(obj, C) * prob.reshape(-1)
    valid = (prob.reshape(-1) >= conf) & (key >= conf)
    return np.repeat(boxes, C, 0), key, np.tile(np.arange(C), P), valid


def nms_inputs(torch, rng, dev):
    """(name, boxes, valid in score order, threshold) on the card, in the
    score order nms_fixed gives them: random boxes at the main path's
    K = 1500 and 50 and a ragged K, B = 1 and 3, all-invalid, identical
    boxes, tied scores; a chain where box i overlaps box i + 1 only, so
    that the walk needs K steps; pairs of boxes whose IoU sits within a
    few ulps of the threshold (0.5 and 0.45, which fp32 rounds); and
    postprocess_refined's (proposal, class) pairs at P = 50, C = 30,
    shifted by class as batched_class_aware_nms shifts them."""
    import numpy as np

    from tscd_torch.ops.nms import class_shift, score_order
    t = lambda a: torch.as_tensor(a, device=dev)

    def rand(B, K):
        xy = rng.uniform(0, 500, (B, K, 2))
        wh = rng.uniform(10, 120, (B, K, 2))
        return (np.concatenate([xy, xy + wh], -1).astype(np.float32),
                rng.uniform(size=(B, K)).astype(np.float32),
                rng.uniform(size=(B, K)) > 0.3)

    cases = []
    for B, K in ((1, 1500), (1, 50), (3, 1500), (3, 50), (2, 7)):
        b, sc, v = rand(B, K)
        cases += [(f"random {B}x{K}", b, sc, v, 0.5),
                  (f"all invalid {B}x{K}", b, sc, np.zeros_like(v), 0.5),
                  (f"identical boxes {B}x{K}", np.repeat(b[:, :1], K, 1), sc, v, 0.5),
                  (f"tied scores {B}x{K}", b, np.full_like(sc, 0.5), v, 0.5)]
    K = 1500
    x = np.arange(K, dtype=np.float32) * 0.3
    cases.append(("chain 1x1500", np.stack([x, 0 * x, x + 1, 0 * x + 1], -1)[None],
                  np.linspace(1, 0, K, dtype=np.float32)[None], np.ones((1, K), bool), 0.5))
    for thr in (0.5, 0.45):
        b = np.stack([near_threshold_boxes(rng, K // 2, thr) for _ in range(2)])
        cases.append((f"near threshold {thr} 2x1500", b,
                      rng.uniform(size=(2, K)).astype(np.float32), np.ones((2, K), bool), thr))
    out = []
    for name, b, sc, v, thr in cases:
        _, bs, vs = score_order(t(b), t(sc), t(v))
        out.append((name, bs, vs, thr))
    pairs = [class_pairs(rng) for _ in range(2)]
    b, sc, c, v = (t(np.stack(a)) for a in zip(*pairs))
    _, bs, vs = score_order(class_shift(b, c, v), sc, v)
    out.append(("class-shifted pairs 2x1500", bs, vs, 0.5))
    return out


def check_nms(torch, name, boxes_s, valid_s, thr):
    """The kernels' keep mask against the plain version's, and the pack
    kernel's bit tiles against the plain pack's (the torch IoU's
    decisions), each on a host copy of the same inputs: equal element
    for element and bit for bit."""
    from tscd_torch.ops.kernels import nms as kn
    got = kn.nms_sorted(boxes_s, valid_s, thr).cpu()
    tiles = kn.pack(boxes_s, thr).cpu()
    want = kn.nms_sorted_plain(boxes_s.cpu(), valid_s.cpu(), thr)
    diff = int((got != want).sum())
    bits = int((tiles != kn.pack_plain(boxes_s.cpu(), thr)).sum())
    emit({"phase": "kernels", "check": f"nms {name}", "max_abs_err": diff,
          "pack_words_differing": bits, "kept": int(want.sum()),
          "tolerance": "elementwise equal, pack bit-equal", "pass": diff == 0 and bits == 0})
    if diff or bits:
        raise AssertionError(f"nms {name}: {diff} boxes and {bits} pack words differ")
    return diff, want


def stage_kernels(prof, name):
    """The device activities inside each device-side span of the profiler
    range `name`, one list a span, in time order (one stream: all that
    the range launched, and nothing else)."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e for e in dev if e.is_user_annotation and e.name == name),
                   key=lambda e: e.time_range.start)
    work = sorted((e for e in dev if not e.is_user_annotation
                   and e.name != "Activity Buffer Request"), key=lambda e: e.time_range.start)
    return [[k for k in work if k.time_range.start >= s.time_range.start
             and k.time_range.end <= s.time_range.end] for s in spans]


def nms_stage_rows(torch, calls, reps=20):
    """The NMS stage alone on `calls`, the arguments batched_class_aware_nms
    got in one window: for each, everything one call launches (the device
    activities inside a profiler range around it, over `reps` calls): the
    device ms summed, their count, their names; and `call_ms` (CUDA
    events, host work included)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tscd_torch.ops import nms
    rows = {}
    for args in calls:
        fn = lambda: nms.batched_class_aware_nms(*args)
        call_ms = cuda_ms(torch, fn, reps)
        # the profiler can lose a range's device-side span (seen once in 20
        # calls): such a trace is profiled again, at most twice
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    with record_function(NMS_STAGE):
                        fn()
                torch.cuda.synchronize()
            spans = stage_kernels(prof, NMS_STAGE)
            if len(spans) == reps and all(spans):
                break
        if len(spans) != reps or not all(spans):
            raise AssertionError(f"{len(spans)} device spans of the NMS stage for {reps} calls")
        ms = [sum(k.time_range.elapsed_us() for k in s) / 1e3 for s in spans]
        rows[f"K={args[0].shape[1]}"] = {
            "ms": sum(ms) / reps, "ms_min": min(ms), "launches": len(spans[-1]),
            "kernels": [k.name[:80] for k in spans[-1]], "call_ms": call_ms}
    return rows


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


def ulp_histogram(torch, got, want):
    """How many bf16 outputs sit 0, 1, 2 and more ulps from the plain
    version's (bit patterns in their order along the line; -0 as +0)."""
    def key(v):
        b = v.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -(b + 32768), b)
    d = (key(got) - key(want)).abs()
    return {"0": int((d == 0).sum()), "1": int((d == 1).sum()), "2": int((d == 2).sum()),
            "more": int((d > 2).sum()), "max_ulps": int(d.max()),
            "max_abs_err_beyond_2": float((got.double() - want.double()).abs()[d > 2].max())
            if bool((d > 2).any()) else 0.0}


def stem_build_record(torch, lib, H, W, O):
    """The bf16 stem kernel as built and launched at (H, W) -> O: ptxas's
    registers and spills of each instance (build/kernels/build.log), the
    runtime's registers, local memory, dynamic shared memory and blocks per
    SM, and its HMMA (tensor-core) instructions in the SASS (cuobjdump)."""
    import ctypes
    import shutil

    from tscd_torch.ops.kernels import library
    log = os.path.join(HERE, "build", "kernels", "build.log")
    ptxas, keep = [], False
    for line in open(log).read().splitlines():
        if "Compiling entry function" in line:
            keep = "focus_stem_mma" in line
        if keep and ("Compiling entry function" in line or "spill" in line or "Used" in line):
            ptxas.append(line.strip())
    cfg = (ctypes.c_int * 4)()
    library.check(lib, lib.tscd_focus_stem_bf16_config(H, W, O, 1, cfg), "focus_stem config")
    rec = {"ptxas": ptxas, "smem_bytes": cfg[0], "blocks_per_sm": cfg[1],
           "registers": cfg[2], "local_bytes": cfg[3]}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise AssertionError("cuobjdump not found: the stem's SASS cannot be checked")
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True,
                          check=True).stdout
    hmma, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "focus_stem_mma" in line
        elif inside and "HMMA" in line:
            hmma += 1
    rec["sass_hmma_in_focus_stem_mma"] = hmma
    if hmma == 0:
        raise AssertionError("focus_stem_mma has no HMMA instruction in its SASS")
    return rec


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
    from tscd_torch.ops.kernels import nms as kn

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
    b_ms, b_by = bound(nbytes, (flops, H100_FP32_FLOPS))
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

    # -- Hungarian past n = 128: the block kernel; exact -------------------
    # (a generator of its own keeps the other kernels' inputs as they were)
    rng_main, rng = rng, np.random.default_rng(6)
    berr = 0
    for m in (129, 200, 500):
        for kind, c in (("random", rng.uniform(0, 2, (1, m, m))), ("constant", const(m)[None])):
            berr = max(berr, check_hungarian(f"hungarian {m}x{m} {kind}",
                                             t(c.astype(np.float32))))
    berr = max(berr, check_hungarian("hungarian 2 x 200x200 batch",
                                     t(rng.uniform(0, 2, (2, 200, 200)).astype(np.float32))))
    m = 200
    c200 = rng.uniform(0, 2, (m, m)).astype(np.float32)
    for case, rv, cv in (("random validity", rng.uniform(size=m) > 0.3, rng.uniform(size=m) > 0.3),
                         ("empty bank", np.zeros(m, bool), np.ones(m, bool))):
        got = hungarian_ops.masked_linear_sum_assignment(
            t(c200), t(rv, torch.bool), t(cv, torch.bool)).cpu()
        want = hungarian_ops.masked_linear_sum_assignment(
            torch.as_tensor(c200), torch.as_tensor(rv), torch.as_tensor(cv))
        same = torch.equal(got, want)
        emit({"phase": "kernels", "check": f"hungarian 200x200 masked, {case}",
              "tolerance": "elementwise equal", "pass": same})
        if not same:
            raise AssertionError(f"hungarian 200x200 masked ({case}) differs")
    if jv_steps(const(129)) != 129 * 130 // 2:
        raise AssertionError("a constant cost should take n(n+1)/2 Dijkstra steps")
    block = {}
    for m, kind in ((129, "random"), (200, "random"), (500, "random"), (500, "constant")):
        c = (rng.uniform(0, 2, (m, m)).astype(np.float32) if kind == "random" else const(m))
        steps = jv_steps(c) if kind == "random" else m * (m + 1) // 2
        ct = t(c[None])
        block[f"{m}x{m} {kind}"] = dict(
            **timed(torch, lambda: hu.linear_sum_assignment(ct), 20 if kind == "random" else 3,
                    "linear_sum_assignment_block"),
            dijkstra_steps=steps,
            bound_ms=steps * block_chain_cycles(lat) / (clock * 1e3))
    c200t = t(rng.uniform(0, 2, (1, 200, 200)).astype(np.float32))
    rows["hungarian"]["block_kernel"] = dict(
        replaces="tscd_tpu/ops/hungarian.py:88-128 (XLA lowering, n > 128)",
        max_abs_err=berr, costs=block,
        plain_ms_200x200_random=cuda_ms(torch, lambda: hu.linear_sum_assignment_plain(c200t), 1, 0),
        bound_by="operations", bound_model=HUNGARIAN_BLOCK_BOUND)

    # -- NMS: refined (K = P * C = 1500) and best class (K = 50); exact ----
    nerr = 0
    timing = {}
    for name, bs, vs, thr in nms_inputs(torch, rng, dev):
        err, want = check_nms(torch, name, bs, vs, thr)
        nerr = max(nerr, err)
        if name == "chain 1x1500" and not torch.equal(want[0], torch.arange(1500) % 2 == 0):
            raise AssertionError("nms chain: every other box should survive")
        if name in ("random 1x1500", "random 1x50", "chain 1x1500"):
            timing[name] = (bs, vs)
    nms_rows = {}
    for name, (bs, vs) in timing.items():
        nms_rows[name] = dict(
            **timed(torch, lambda: kn.nms_sorted(bs, vs, 0.5), 100, "nms_"),
            plain_ms=cuda_ms(torch, lambda: kn.nms_sorted_plain(bs, vs, 0.5), 5, 1),
            **nms_bounds(*vs.shape, lat, clock))
    rows["nms"] = dict(max_abs_err=nerr, **nms_rows["random 1x1500"], bound_by="operations",
                       bound_model=NMS_BOUND, library_ms=None, sizes=nms_rows)
    rng = rng_main

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
    b_ms, b_by = bound(nbytes, (flops, H100_FP32_FLOPS))
    rows["focus_stem"] = dict(
        max_abs_err=serr,
        **timed(torch, lambda: fs.focus_stem(x32, w3, scale, shift), 20,
                "focus_stem"),
        plain_ms=cuda_ms(torch, lambda: fs.focus_stem_plain(x32, w3, scale, shift), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, lambda: F.conv2d(x32_nchw, w6, shift, stride=2,
                                                   padding=2), 20))
    del x32, x32_nchw
    rows.update(kernel_phase_bf16(torch, dev, np.random.default_rng(30)))
    return rows


def kernel_phase_bf16(torch, dev, rng):
    """The bf16 variants against their plain versions at main-path
    shapes: the stem reading uint8 frames (or fp32 ones, rounded as read)
    and writing bf16, within BF16_TOL (at the window's 32 frames too, where
    the ulps from the plain version are counted: the outputs more than 2
    ulps off are sums near 0 that cancel in another order and SiLU's
    underflows below y = -87, which the kernel flushes to 0); the
    attention reading bf16 q/k/v, 1e-5 as at fp32 (both compute in fp32
    from the same values). Then their times, bounds and the nearest
    library call's time."""
    import numpy as np
    import torch.nn.functional as F

    from tscd_torch.models.aggregation import DualBranchAttention, _split_heads
    from tscd_torch.ops.kernels import focus_stem as fs
    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.ops.kernels import library
    bf = torch.bfloat16
    t = lambda a, dt=torch.float32: torch.as_tensor(a, device=dev).to(dt)
    rows = {}

    # -- stem: uint8 in, bf16 out (focus_stem_mma, the tensor cores) ------
    serr = 0.0
    for (Fr, H, W), O, kind in (((4, 576, 576), 64, "uint8"), ((4, 128, 128), 8, "uint8"),
                                ((1, 70, 34), 16, "fp32"), ((2, 70, 66), 64, "uint8 border"),
                                ((3, 2, 64), 64, "uint8 border"), ((2, 40, 70), 24, "uint8"),
                                ((2, 8, 1200), 16, "uint8")):
        w3 = t(rng.normal(0, 1 / np.sqrt(108), (O, 12, 3, 3)))
        scale = t(rng.uniform(0.5, 1.5, O))
        shift = t(rng.normal(0, 0.5, O))
        if kind == "fp32":
            xc = t(rng.uniform(0, 255, (Fr, H, W, 3)))
        else:
            x = rng.integers(0, 256, (Fr, H, W, 3), dtype=np.uint8)
            if kind == "uint8 border":
                for edge in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
                    x[edge] = 255
            xc = t(x, torch.uint8)
        got = fs.focus_stem(xc, w3, scale, shift, out_dtype=bf)
        want = fs.focus_stem_plain(xc, w3, scale, shift, bf)
        torch.cuda.synchronize()
        serr = max(serr, check_close(f"focus_stem bf16 ({Fr}, {H}, {W}, 3) {kind} -> {O}",
                                     got, want, **BF16_TOL))
        del xc, got, want
    O, Fr, H, W = 64, 32, 576, 576
    w3 = t(rng.normal(0, 1 / np.sqrt(108), (O, 12, 3, 3)))
    scale = t(rng.uniform(0.5, 1.5, O))
    shift = t(rng.normal(0, 0.5, O))
    x8 = t(rng.integers(0, 256, (Fr, H, W, 3), dtype=np.uint8), torch.uint8)
    got = fs.focus_stem(x8, w3, scale, shift, out_dtype=bf)
    want = fs.focus_stem_plain(x8, w3, scale, shift, bf)
    serr = max(serr, check_close(f"focus_stem bf16 ({Fr}, {H}, {W}, 3) uint8 -> {O}",
                                 got, want, **BF16_TOL))
    ulps = ulp_histogram(torch, got, want)
    del got, want
    xb = x8.to(bf).permute(0, 3, 1, 2)             # channels_last view
    w6 = fs.rearrange_weight(w3, scale).to(bf)
    nbytes = Fr * H * W * 3 + 2 * Fr * (H // 2) * (W // 2) * O + 4 * (w3.numel() + 2 * O)
    flops = 2 * Fr * (H // 2) * (W // 2) * O * 108
    b_ms, b_by = bound(nbytes, (flops, H100_BF16_FLOPS))
    rows["focus_stem_bf16"] = dict(
        max_abs_err=serr, tolerance=BF16_TOL, ulps_vs_plain=ulps,
        **timed(torch, lambda: fs.focus_stem(x8, w3, scale, shift, out_dtype=bf), 20,
                "focus_stem"),
        plain_ms=cuda_ms(torch, lambda: fs.focus_stem_plain(x8, w3, scale, shift, bf), 10),
        bound_ms=b_ms, bound_by=b_by, input_mb=x8.numel() / 1e6,
        output_mb=2 * Fr * (H // 2) * (W // 2) * O / 1e6,
        library_ms=cuda_ms(torch, lambda: F.conv2d(xb, w6, shift.to(bf), stride=2,
                                                   padding=2), 20))
    emit({"phase": "kernels", "check": "focus_stem bf16 (32, 576, 576, 3) uint8 -> 64: "
          "ulps from the plain version, and the kernel as built",
          "ulps": ulps, "ms": rows["focus_stem_bf16"]["ms"], "bound_ms": b_ms,
          **stem_build_record(torch, library.load(), H, W, O)})
    del x8, xb

    # -- attention: bf16 q/k/v ---------------------------------------------
    B, h, q, k, d = 1, 4, 50, 1600, 64
    qc, qr = (t(rng.normal(size=(B, h, q, d)), bf) for _ in range(2))
    kc, vc, kr, vr = (t(rng.normal(size=(B, h, k, d)), bf) for _ in range(4))
    score = t(rng.uniform(0, 1, (B, k)))
    valid = t(rng.uniform(size=(B, k)) > 0.2, torch.bool)
    args = (qc, kc, vc, qr, kr, vr, score, valid)
    torch.manual_seed(0)
    att = DualBranchAttention(h * d, h, dtype=bf).to(dev)
    x_cls, x_reg = (t(rng.normal(size=(B, k, h * d)), bf) for _ in range(2))
    with torch.no_grad():
        k_cls, v_cls = att.kv_cls(x_cls).chunk(2, -1)
        k_reg, v_reg = att.kv_reg(x_reg).chunk(2, -1)
        main = (_split_heads(att.q_cls_local(x_cls[:, :q]), h),
                _split_heads(k_cls, h), _split_heads(v_cls, h),
                _split_heads(att.q_reg_local(x_reg[:, :q]), h),
                _split_heads(k_reg, h), _split_heads(v_reg, h), score, valid)
    if any(a.dtype != bf for a in main[:6]) or main[1].is_contiguous():
        raise AssertionError("the bf16 aggregation should hand over strided bf16 views")
    last = (torch.arange(k, device=dev) >= k - 32)[None].expand(B, k).contiguous()
    errs = []
    for case, a in (("20% invalid keys", args),
                    ("all keys invalid", args[:7] + (torch.zeros_like(valid),)),
                    ("valid keys in the last chunk only", args[:7] + (last,)),
                    ("main-path layout", main)):
        got, want = fa.fused_dual_attention(*a), fa.fused_dual_attention_plain(*a)
        torch.cuda.synchronize()
        for part, g, w in zip(("out_cls", "out_reg", "attn"), got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"attention bf16 ({case}): non-finite {part}")
            errs.append(check_close(f"fused_dual_attention bf16 {case} {part}",
                                    g, w, atol=1e-5, rtol=1e-4))
    nbytes = 2 * (2 * B * h * q * d + 4 * B * h * k * d) + 4 * B * k + B * k \
        + 4 * (2 * B * h * q * d + B * h * q * k)
    # the logits' products of bf16 q and k are exact in fp32, so bf16
    # tensor cores with fp32 sums give the same cosines; attn @ V takes
    # fp32 probabilities, at the fp32 rate
    logit_flops = attn_v_flops = B * h * 2 * 2 * q * k * d
    b_ms, b_by = bound(nbytes, (logit_flops, H100_BF16_FLOPS),
                       (attn_v_flops, H100_FP32_FLOPS))
    rows["fused_dual_attention_bf16"] = dict(
        max_abs_err=max(errs),
        **timed(torch, lambda: fa.fused_dual_attention(*main), 200,
                "fused_dual_attention"),
        plain_ms=cuda_ms(torch, lambda: fa.fused_dual_attention_plain(*main), 50),
        bound_ms=b_ms, bound_by=b_by, bytes_mb=nbytes / 1e6, library_ms=None)
    emit({"phase": "kernels", "bf16": {n: {k: v for k, v in r.items() if "ms" in k}
                                       for n, r in rows.items()}})
    return rows


def run_windows(torch, predict, exp, n_windows, seed, dev_sync, state=None,
                first=0, eager=False, uint8=False):
    """Streams n_windows seeded windows, numbered from `first` (window 0
    starts a sequence; later ones resume from `state`); returns
    per-window Detections on the host, each window's latency in ms (CUDA
    events on the card) and the carried state. Frames are fp32 (uint8
    with `uint8`); `eager` dispatches launch by launch, not as the
    window's CUDA graph."""
    import numpy as np

    from tscd_torch.ops.position import get_timing_signal_1d
    rng = np.random.default_rng(seed)
    F = exp.lframe_val + exp.gframe_val
    H, W = exp.test_size
    dispatch = predict.dispatch_eager if eager else predict.dispatch
    dets, lat = [], []
    for w in range(first, first + n_windows):
        if uint8:
            x = rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8)
        else:
            x = rng.uniform(0, 255, (F, H, W, 3)).astype(np.float32)
        te = get_timing_signal_1d(np.arange(w, w + F))
        if dev_sync:
            xd = torch.as_tensor(x, device="cuda")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            refined, state = dispatch(xd, te, w > 0, state)
            end.record()
            end.synchronize()
            lat.append(start.elapsed_time(end))
        else:
            refined, state = dispatch(x, te, w > 0, state)
        dets.append(refined)
    return dets, lat, state


def small_phase(torch):
    """CPU plain versions vs the card's kernels on the selftest config."""
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
    worst, n = match_rows(out["cpu"], out["cuda"], atol, rtol)
    emit({"phase": "small", "windows": 3, "detections": n,
          "max_abs_err": worst, "tolerance": {"atol": atol, "rtol": rtol},
          "pass": True})


def match_rows(windows_a, windows_b, atol, rtol, box_share=None):
    """Per window and local frame, the detection rows [x1, y1, x2, y2,
    obj, score, cls] of the two runs matched as sets: the same count, and
    each row of `a` has its own row of `b` of the same class within the
    tolerance; with `box_share`, the boxes within that share of the
    frame's largest coordinate instead of `atol` (x1 = cx - w / 2 cancels,
    so a box edge near 0 carries the error of the box's size). Returns
    (max abs diff, rows compared); raises on a mismatch or when there is
    nothing to compare."""
    import numpy as np
    if len(windows_a) != len(windows_b):
        raise AssertionError(f"{len(windows_a)} windows against {len(windows_b)}")
    worst, n = 0.0, 0
    for w, (frames_a, frames_b) in enumerate(zip(windows_a, windows_b)):
        for rows_a, rows_b in zip(frames_a, frames_b):
            if len(rows_a) != len(rows_b):
                raise AssertionError(f"window {w}: {len(rows_a)} detections "
                                     f"against {len(rows_b)}")
            free = list(range(len(rows_b)))
            b_atol = atol if box_share is None or not len(rows_b) else \
                box_share * max(1.0, float(np.abs(rows_b[:, :4]).max()))
            for r in rows_a:
                hit = next((i for i in free if rows_b[i, 6] == r[6] and np.allclose(
                    rows_b[i, :4], r[:4], atol=b_atol, rtol=rtol) and np.allclose(
                    rows_b[i, 4:6], r[4:6], atol=atol, rtol=rtol)), None)
                if hit is None:
                    raise AssertionError(f"window {w}: no detection matches {r}")
                free.remove(hit)
                worst = max(worst, float(np.abs(rows_b[hit, :6] - r[:6]).max()))
            n += len(rows_b)
    if n == 0:
        raise AssertionError("no detections to compare")
    return worst, n


def full_phase(torch, counters):
    """TSCD-Large streaming eval: warm-up window, then 3 timed windows
    with carried state, traced; returns the launches of each kernel in
    those 3 windows and the Hungarian costs of one more streamed window."""
    import numpy as np

    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp.tscd_large import Exp
    from tscd_torch.models.tscd import random_init_
    exp = Exp()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = random_init_(exp.get_model(), exp.seed)
    pred = make_predict_fn(model, exp.lframe_val, exp.gframe_val,
                           exp.nmsthre, exp.test_conf)
    _, _, warm_state = run_windows(torch, pred, exp, 1, 100, True)   # warm-up
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    sync_free_dispatch(torch, pred, exp, warm_state)
    (dets, lat, state), launches, _ = traced_path(
        torch, counters, lambda: run_windows(torch, pred, exp, 3, exp.seed, True),
        3, exp.lframe_val, bf16=False)
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
          "setup_s": setup_s, "window_ms": lat, "traced": True, "detections": n_det,
          "launches": launches, "dispatch_host_syncs": 0,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    state, carried, sorted_in, stage = capture_costs(torch, pred, exp, state)
    profile_window(torch, pred, exp, state)
    return launches, carried, sorted_in, stage


def sync_free_dispatch(torch, pred, exp, state):
    """The whole dispatch of a streamed window (upload of pinned uint8
    frames, the window's graph replay, copies of its outputs) waits on the
    device nowhere: any synchronising call in it raises here. The first
    uint8 dispatch captures that frame dtype's graph, outside the check."""
    import numpy as np

    from tscd_torch.ops.position import get_timing_signal_1d
    F = exp.lframe_val + exp.gframe_val
    rng = np.random.default_rng(5)
    wins = [(torch.from_numpy(rng.integers(0, 256, (F, *exp.test_size, 3),
                                           dtype=np.uint8)).pin_memory(),
             torch.from_numpy(get_timing_signal_1d(np.arange(w, w + F))).pin_memory())
            for w in (1, 2)]
    _, state = pred.dispatch(*wins[0], True, state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        refined, _ = pred.dispatch(*wins[1], True, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if len(pred.materialize(refined)) != exp.lframe_val:
        raise AssertionError("the checked dispatch gave no detections per local frame")


def carried_phase(torch, row, carried):
    """The solver on the costs of a streamed window with carried state:
    checked against the plain version and timed like the kernel phase's
    costs, into row["costs"]["carried_state"]."""
    for k, cost in enumerate(carried):
        check_hungarian(f"hungarian carried-state cost, local frame {k}", cost)
    row["costs"]["carried_state"] = hungarian_cost_row(
        torch, carried[0], row["latency_cycles"], row["sm_clock_max_mhz"])
    emit({"phase": "carried", "hungarian": row["costs"]["carried_state"]})


def capture_window(torch, pred, exp, state, targets):
    """Streams window 3, resumed from `state`, eagerly, keeping a copy of
    the arguments of every call of each `targets` entry, (module,
    function name) -> list (`keeping_calls`); returns the new state. Its
    launches are not counted."""
    with keeping_calls(torch, targets):
        _, _, state = run_windows(torch, pred, exp, 1, 3, True, state, 3, eager=True)
    return state


def capture_costs(torch, pred, exp, state):
    """Window 3 (`capture_window`) with a copy of every cost the matcher
    hands the solver (one a local frame), of the NMS kernels' inputs (the
    sorted, shifted boxes and valid flags of the refined and best-class
    calls) and of batched_class_aware_nms's arguments; returns the new
    state, the costs and the two NMS lists."""
    from tscd_torch.ops import hungarian
    from tscd_torch.ops import nms
    from tscd_torch.ops import postprocess
    costs, sorted_in, stage = [], [], []
    state = capture_window(torch, pred, exp, state, {
        (hungarian, "linear_sum_assignment"): costs, (nms, "nms_sorted"): sorted_in,
        (postprocess, "batched_class_aware_nms"): stage})
    if len(costs) != exp.lframe_val or len(sorted_in) != 2 or len(stage) != 2:
        raise AssertionError(f"{len(costs)} solver and {len(sorted_in)}, {len(stage)} NMS "
                             f"calls in a window; {exp.lframe_val} and 2 expected")
    return state, [c[0] for c in costs], sorted_in, stage


def nms_window_phase(torch, row, sorted_in, stage):
    """The NMS kernels on a streamed window's own inputs (its refined and
    best-class calls: sorted, class-shifted boxes): checked against the
    plain version, element for element and bit for bit; then the whole
    stage alone on that window's batched_class_aware_nms arguments, into
    row["stage_alone"]."""
    for boxes_s, valid_s, thr in sorted_in:
        check_nms(torch, f"traced window's call, K = {boxes_s.shape[1]}", boxes_s, valid_s, thr)
    row["stage_alone"] = nms_stage_rows(torch, stage)
    emit({"phase": "carried", "nms_stage_alone": row["stage_alone"]})


class SyntheticVID:
    """An in-memory dataset with the interface VIDDataset gives
    WindowLoader (`res`, `img_size`, `load_frame`, `frame_index`): seeded
    uint8 frames at the size load_frame returns for a 720 x 1280 source
    (324 x 576 at 576 px, so the letterbox pads and the evaluator rescales),
    seeded ground truth (1 to `max_boxes` boxes a frame), and the windows
    VIDDataset builds from `videos` videos of `frames` frames: the val
    windows (formal), or with `train` the training windows (exp.lframe +
    exp.gframe, shuffled, at exp.input_size)."""

    SOURCE = (720, 1280)

    def __init__(self, exp, videos, frames, seed, train=False, max_boxes=3):
        import numpy as np

        from tscd_torch.data.vid import build_sequences
        rng = np.random.default_rng(seed)
        self.img_size = tuple(exp.input_size if train else exp.test_size)
        r = min(self.img_size[0] / self.SOURCE[0], self.img_size[1] / self.SOURCE[1])
        h, w = int(self.SOURCE[0] * r), int(self.SOURCE[1] * r)
        names = [[f"Data/VID/val/vid{v}/{i:06d}.JPEG" for i in range(frames)]
                 for v in range(videos)]
        self.frames, self.annos = {}, {}
        for p in (p for video in names for p in video):
            self.frames[p] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            n = int(rng.integers(1, max_boxes + 1))
            xy = rng.uniform(0, (w - 40, h - 40), (n, 2))
            wh = rng.uniform(16, 160, (n, 2))
            x2y2 = np.minimum(xy + wh, (w, h))
            cls = rng.integers(0, exp.num_classes, (n, 1))
            self.annos[p] = np.concatenate([xy, x2y2, cls], 1).astype(np.float32)
        if train:
            self.res = build_sequences(names, exp.lframe, exp.gframe, mode=exp.mode,
                                       training=True, rng=random.Random(seed),
                                       label_counts={p: len(a) for p, a in self.annos.items()})
        else:
            self.res = build_sequences(names, exp.lframe_val, exp.gframe_val,
                                       mode=exp.mode, formal=True, val=True,
                                       rng=random.Random(seed))

    def load_frame(self, path):
        return self.frames[path], self.annos[path].copy(), self.SOURCE

    def frame_index(self, path):
        from tscd_torch.data.vid import frame_index
        return frame_index(path)


def recording(predict, out, times=None):
    """`predict` with its materialized rows appended to `out`; with
    `times`, each dispatch's and materialize's host seconds, and CUDA
    events around each dispatch, appended there."""
    def dispatch(*args):
        t0 = time.perf_counter()
        ev = None
        if times is not None:
            import torch
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        res = predict.dispatch(*args)
        if ev is not None:
            ev[1].record()
            times["events"].append(ev)
            times["dispatch_s"].append(time.perf_counter() - t0)
            times["marks"].append(t0)
        return res

    def materialize(dev):
        t0 = time.perf_counter()
        rows = predict.materialize(dev)
        if times is not None:
            t1 = time.perf_counter()
            times["materialize_s"].append(t1 - t0)
            times["marks"].append(t1)
        out.append(rows)
        return rows

    def unpipelined(*args):
        raise AssertionError("the evaluator must take the pipelined path")

    unpipelined.dispatch = dispatch
    unpipelined.materialize = materialize
    return unpipelined


def eval_phase(torch, counters):
    """The streaming evaluator end to end: the selftest config on the CPU
    and on the card, then TSCD-Large at full width with its numbers."""
    import numpy as np

    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.data.vid import WindowLoader
    from tscd_torch.exp.tscd_large import Exp, selftest_exp
    from tscd_torch.models.tscd import random_init_
    quiet = lambda *a: None

    # selftest: CPU plain versions against the card's kernels, 1e-4
    exp = selftest_exp()
    ds = SyntheticVID(exp, videos=2, frames=6, seed=21)
    out = {}
    for dev in ("cpu", "cuda"):
        model = random_init_(exp.get_model(device=dev), exp.seed)
        rows = []
        pred = recording(make_predict_fn(model, exp.lframe_val, exp.gframe_val,
                                         exp.nmsthre, exp.test_conf), rows)
        res = exp.get_evaluator(WindowLoader(ds, pin_memory=dev == "cuda")).evaluate(pred, quiet)
        out[dev] = (res, rows)
    worst, n = match_rows(out["cpu"][1], out["cuda"][1], 1e-4, 1e-4)
    stats_err = float(np.abs(np.subtract(out["cpu"][0]["stats"], out["cuda"][0]["stats"])).max())
    emit({"phase": "eval", "config": "selftest", "windows": len(ds.res),
          "videos": 2, "detections": n, "max_abs_err": worst,
          "stats_max_abs_err": stats_err, "stats": out["cuda"][0]["stats"],
          "tolerance": {"detections": 1e-4, "stats": 1e-4}, "pass": stats_err <= 1e-4})
    if stats_err > 1e-4:
        raise AssertionError(f"selftest eval: stats differ by {stats_err}")

    # TSCD-Large at full width, fp32 and then bf16 with BN folded, on
    # the same weights: 2 videos of 10 frames, 20 windows each
    exp = Exp()
    model = random_init_(exp.get_model(), exp.seed)
    sd32 = model.state_dict()
    eval_large(torch, counters, exp, model, "fp32")
    del model
    eval_large(torch, counters, exp, bf16_model(torch, exp, sd32), "bf16")


def eval_large(torch, counters, exp, model, dtype):
    """VIDEvaluator with the pipelined predict of `model` (TSCD-Large)
    over 2 videos and 20 windows through WindowLoader(pin_memory=True):
    frames/s, ms per frame, window device spans, the pinned upload, the
    busy share of the loop and the host time outside predict. Then the
    same evaluation again, traced, for the launches of each kernel."""
    import numpy as np

    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.data.vid import WindowLoader
    quiet = lambda *a: None
    ds = SyntheticVID(exp, videos=2, frames=10, seed=22)
    pred = make_predict_fn(model, exp.lframe_val, exp.gframe_val, exp.nmsthre, exp.test_conf)
    loader = WindowLoader(ds, pin_memory=True)
    first = next(iter(loader))
    pred.materialize(pred.dispatch(first["imgs"], first["time_embedding"], False, None)[0])
    up = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(5)]
    for a, b in up:
        a.record()
        first["imgs"].to("cuda", non_blocking=True)
        b.record()
    torch.cuda.synchronize()
    upload_ms = [a.elapsed_time(b) for a, b in up]
    rows, times = [], {"events": [], "dispatch_s": [], "materialize_s": [], "marks": []}
    t0 = time.perf_counter()
    res = exp.get_evaluator(loader).evaluate(recording(pred, rows, times), quiet)
    t1 = time.perf_counter()
    eval_s = t1 - t0
    nw = len(ds.res)

    def again():
        t = time.perf_counter()
        exp.get_evaluator(WindowLoader(ds, pin_memory=True)).evaluate(
            recording(pred, []), quiet)
        return time.perf_counter() - t

    traced_s, launches, _ = traced_path(torch, counters, again, nw, exp.lframe_val,
                                        bf16=dtype == "bf16")
    if len(rows) != nw or nw < 16:
        raise AssertionError(f"{len(rows)} windows evaluated, {nw} expected (>= 16)")
    for per_frame in rows:
        for r in per_frame:
            if r.ndim != 2 or r.shape[1] != 7 or not np.isfinite(r).all():
                raise AssertionError(f"bad detections {r.shape}")
    if len(res.get("stats", [])) != 12 or not np.isfinite(res["stats"]).all():
        raise AssertionError(f"eval gave no COCO stats: {res}")
    window_ms = [a.elapsed_time(b) for a, b in times["events"]]
    loop_s = times["marks"][-1] - times["marks"][0]
    host_s = loop_s - sum(times["dispatch_s"]) - sum(times["materialize_s"])
    frames = nw * exp.lframe_val
    emit({"phase": "eval", "config": "TSCD-Large 1+31 frames 576px P=50", "dtype": dtype,
          "bn_folded": dtype == "bf16",
          "videos": 2, "windows": nw, "evaluated_frames": frames,
          "evaluate_s": eval_s, "frames_per_s": frames / eval_s,
          "loop_s": loop_s, "loop_frames_per_s": frames / loop_s,
          # the first window's collate before the loop, COCO scoring after it
          "before_loop_s": times["marks"][0] - t0, "after_loop_s": t1 - times["marks"][-1],
          "scored_detections": int(sum((r[:, 4] * r[:, 5] >= exp.test_conf).sum()
                                       for per_frame in rows for r in per_frame)),
          "ms_per_frame": res["ms_per_frame"],
          "window_ms_mean": float(np.mean(window_ms)), "window_ms": window_ms,
          "upload_ms_pinned_uint8": upload_ms,
          "upload_mb": first["imgs"].numel() / 1e6,
          "device_busy_share": sum(window_ms) / 1e3 / loop_s,
          "host_ms_per_window_outside_predict": 1e3 * host_s / nw,
          "dispatch_ms_mean": 1e3 * float(np.mean(times["dispatch_s"])),
          "materialize_ms_mean": 1e3 * float(np.mean(times["materialize_s"])),
          "launches": launches, "launches_from": "the evaluation again, traced",
          "traced_evaluate_s": traced_s, "stats": res["stats"], "mAP": res["mAP"]})


# the exp's model knobs that JAX's TSCD hands to its head
HEAD_KNOBS = ("agg_type", "cat_ota_fg", "reconf", "decouple_reg", "use_pre_nms",
              "sparse_vid_towers")


def bf16_model(torch, exp, sd32, device=None):
    """`exp`'s TSCD (TSCD-Large in the bf16 phase) computing in bf16, built
    as bench.py:261-262 builds it (`TSCD(..., dtype=bfloat16)`) with the
    exp's head knobs, with BN folded from the fp32 weights `sd32` (folded
    in fp32, then cast), on `device` (the card unless given)."""
    from tscd_torch.models.tscd import TSCD
    from tscd_torch.utils.model_utils import fuse_model
    model = TSCD(num_classes=exp.num_classes, depth=exp.depth, width=exp.width,
                 num_proposals=exp.num_proposals, minimal_limit=exp.minimal_limit,
                 heads=exp.heads, backbone_name=exp.backbone_name, device=device,
                 dtype=torch.bfloat16, **{k: getattr(exp, k) for k in HEAD_KNOBS})
    return fuse_model(model, sd32)


def distance(a, b):
    """max and 99.9th percentile of |a - b| (numpy arrays)."""
    import numpy as np
    d = np.abs(a - b)
    return {"max": float(d.max()), "p999": float(np.percentile(d, 99.9))}


def raw_delta_parts(b16, f32):
    """|bf16 - fp32| of the dense raw outputs (numpy) beside the fp32
    values' own size, for the box offsets, the objectness and the class
    logits."""
    import numpy as np
    return {part: {"raw_delta": distance(b16[c], f32[c]), "abs_fp32": distance(f32[c], 0.0)}
            for part, c in (("reg", np.s_[..., :4]), ("obj", np.s_[..., 4:5]),
                            ("cls", np.s_[..., 5:]))}


def cpu_reference(torch, exp, sd32, x, te, b16, f32, phase="bf16"):
    """The card's bf16 raw outputs on the window's first local and first
    global frame against the bf16 port on the CPU (plain versions, held
    to JAX's bf16 model by tests/test_torch_port_bf16.py) on the same
    weights and frames, with the fp32 outputs beside (`b16`, `f32`: the
    card's raw outputs of the window, numpy): the card's distance
    from fp32, and its distance from the CPU's bf16, each within
    BF16_SPREAD times the CPU's own distance from fp32 (max and p99.9).
    The dense outputs of a frame depend on that frame alone. Its record
    goes out under `phase`."""
    L = exp.lframe_val
    pick = [0, L]
    t0 = time.time()
    cpu = bf16_model(torch, exp, {k: v.cpu() for k, v in sd32.items()}, "cpu")
    ref = cpu(x[pick].cpu(), te[pick].cpu(), 1, 1)["raw_outputs"].float().numpy()
    cpu_s = time.time() - t0
    card, f32 = b16[pick], f32[pick]
    d = {"card_vs_fp32": distance(card, f32), "cpu_vs_fp32": distance(ref, f32),
         "card_vs_cpu": distance(card, ref)}
    limit = {k: BF16_SPREAD * v for k, v in d["cpu_vs_fp32"].items()}
    ok = all(0 < v for v in limit.values()) and all(
        d[pair][k] <= limit[k] for pair in ("card_vs_fp32", "card_vs_cpu") for k in limit)
    emit({"phase": phase, "check": "card against the CPU's bf16 port, frames 0 and L",
          "exp": exp.exp_name, "backbone_name": exp.backbone_name,
          "distances": d, "limit": limit,
          "tolerance": f"card_vs_fp32 and card_vs_cpu <= {BF16_SPREAD} x cpu_vs_fp32",
          "cpu_s": cpu_s, "pass": ok})
    if not ok:
        raise AssertionError(f"bf16 on the card: {d} against the limit {limit}")


def bf16_phase(torch, counters):
    """TSCD-Large at bf16 with BN folded: the dense raw outputs against
    the fp32 port on the same weights and frames, and against the bf16
    port on the CPU (`cpu_reference`); a warm-up window (eager, then the
    window's CUDA graph is captured) and 3 streamed windows with the
    carried bank, traced (window ms by CUDA events, launches from the
    trace, the replays' device time by kernel class); 10 streamed windows
    back to back through the graph and 5 launched eagerly (frames/s both
    ways, busy share, host ms a dispatch); graph replay against eager
    dispatch of one window; a sync-free dispatch; an eager window
    profiled. Returns the launches of the 3 streamed windows."""
    import numpy as np

    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp.tscd_large import Exp
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops.position import get_timing_signal_1d
    exp = Exp()
    L, G = exp.lframe_val, exp.gframe_val
    F, (H, W) = L + G, exp.test_size
    rng = np.random.default_rng(40)
    x = torch.as_tensor(rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8), device="cuda")
    te = torch.as_tensor(get_timing_signal_1d(np.arange(F)), device="cuda")
    f32 = random_init_(exp.get_model(), exp.seed)
    sd32 = f32.state_dict()
    raw32 = f32(x, te, L, G)["raw_outputs"].float()
    del f32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = bf16_model(torch, exp, sd32)
    raw16 = model(x, te, L, G)["raw_outputs"]
    if raw16.dtype != torch.bfloat16 or raw16.shape != raw32.shape:
        raise AssertionError(f"bf16 raw outputs {raw16.dtype} {tuple(raw16.shape)}")
    b16, f32r = raw16.float().cpu().numpy(), raw32.cpu().numpy()
    del raw16, raw32
    if not np.isfinite(b16).all():
        raise AssertionError("bf16 raw outputs are not finite")
    delta = distance(b16, f32r)
    pred = make_predict_fn(model, L, G, exp.nmsthre, exp.test_conf)
    _, _, state = run_windows(torch, pred, exp, 1, 100, True, uint8=True)   # warm-up
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    (dets, lat, state), launches, prof = traced_path(
        torch, counters,
        lambda: run_windows(torch, pred, exp, 3, exp.seed, True, state, 1, uint8=True),
        3, L, bf16=True)
    n_det = 0
    for d in dets:
        for r in pred.materialize(d):
            if r.ndim != 2 or r.shape[1] != 7 or not np.isfinite(r).all():
                raise AssertionError(f"bad bf16 detections {r.shape}")
            n_det += len(r)
    if n_det == 0 or not bool(state.has_state) or state.out.dtype != torch.bfloat16:
        raise AssertionError("bf16 path: no detections, or no bf16 carried bank")

    # throughput: streamed windows back to back, frames on the card
    wins = [(torch.as_tensor(rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8), device="cuda"),
             torch.as_tensor(get_timing_signal_1d(np.arange(w, w + F)), device="cuda"))
            for w in range(4, 14)]
    loops = {}
    for mode, fn, n in (("graph", pred.dispatch, 10), ("eager", pred.dispatch_eager, 5)):
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(n)]
        host = []
        st = state
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for (xw, tw), (a, b) in zip(wins, evs):
            h0 = time.perf_counter()
            a.record()
            _, st = fn(xw, tw, True, st)
            b.record()
            host.append(time.perf_counter() - h0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        spans = [a.elapsed_time(b) for a, b in evs]
        loops[mode] = {"windows": n, "wall_s": wall,
                       "frames_per_s": F * n / wall,
                       "evaluated_frames_per_s": L * n / wall,
                       "window_ms": spans, "device_busy_share": sum(spans) / 1e3 / wall,
                       "host_dispatch_ms": [1e3 * h for h in host]}

    # the graph's window against the same window launched eagerly
    xw, tw = wins[0]
    got = pred.dispatch(xw, tw, True, state)
    want = pred.dispatch_eager(xw, tw, True, state)
    equal = all(torch.equal(a, b) for a, b in zip(got[0] + got[1], want[0] + want[1]))
    emit({"phase": "bf16", "check": "graph replay against eager dispatch", "pass": equal,
          "tolerance": "equal (detections and carried bank)"})
    if not equal:
        raise AssertionError("bf16: the graph's window differs from the eager one")
    sync_free_dispatch(torch, pred, exp, state)
    emit({"phase": "bf16", "config": "TSCD-Large 1+31 frames 576px P=50, BN folded",
          "setup_s": setup_s, "window_ms": lat, "traced": True, "detections": n_det,
          "launches": launches, "dispatch_host_syncs": 0,
          "max_raw_delta": delta["max"], "p999_raw_delta": delta["p999"],
          "raw_delta_vs": "fp32 port, same weights and frames (dense raw_outputs)",
          "raw_delta_parts": raw_delta_parts(b16, f32r),
          "loops": loops, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    cpu_reference(torch, exp, sd32, x, te, b16, f32r)
    profile_window(torch, pred, exp, state, dtype="bf16")
    replay_breakdown(prof, 3)
    stem_graph_prep(torch, model, x)
    return launches


def stem_graph_prep(torch, model, x):
    """The small kernels the bf16 stem's call adds to a window's CUDA
    graph (Focus.forward's scale of ones, the wrapper's weight fragments
    and split shift) and their device time a window: the model's stem
    alone, captured as a graph on the window's uint8 frames and replayed
    4 times under torch.profiler. A replay runs its preparation, then
    focus_stem_mma, so the kernels the trace records after one stem
    kernel up to the next are one whole replay: each such replay's count
    and preparation time is printed (the first replay, whose first
    records may come before the trace is taken, is left out)."""
    from torch.autograd import DeviceType

    from tscd_torch.models.blocks import Focus
    stem = next(m for m in model.modules() if isinstance(m, Focus))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        stem(x)                                    # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        stem(x)
    reps = 4
    # a trace with fewer stem kernels lost records (PERF.md §7) and is
    # taken again, 3 times in all
    for attempt in range(1, 4):
        with traced(torch) as prof:
            for _ in range(reps):
                graph.replay()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                          and e.name != "Activity Buffer Request" and LEAD_IN not in e.name),
                         key=lambda e: e.time_range.start)
        stems = [i for i, e in enumerate(kernels) if "focus_stem_mma" in e.name]
        if len(stems) == reps:
            break
        if len(stems) > reps or attempt == 3:
            raise AssertionError(f"{len(stems)} focus_stem_mma launches in {reps} replays "
                                 f"of the stem's graph ({attempt} traces)")
    replays = [kernels[a + 1:b] for a, b in zip(stems, stems[1:])]
    prep = replays[-1]
    emit({"phase": "bf16", "check": "the stem's weight preparation in a window's graph",
          "prep_kernels_a_replay": [len(r) for r in replays],
          "prep_ms_a_replay": [sum(e.time_range.elapsed_us() for e in r) / 1e3
                               for r in replays],
          "stem_kernel_ms": [kernels[i].time_range.elapsed_us() / 1e3 for i in stems],
          "prep_of_the_last": [{"name": e.name[:90],
                                "ms": e.time_range.elapsed_us() / 1e3} for e in prep]})

# -- stage-2 training ---------------------------------------------------------

TRAIN_CONFIG = "TSCD-Large 4+12 frames 576px P=50, fp32, fix_bn, stop_backbone_grad"
# the attention's gradients through the kernel's forward against autograd
# of the plain version: the same recompute in both, so fp32 roundings of
# another order at most
ATTN_BWD_TOL = 1e-5          # of each gradient's largest value
# one step on the card against the same step on the CPU: fp32 with other
# convolution and matmul algorithms (TF32 off) on both sides
TRAIN_LOSS_RTOL = 1e-4
TRAIN_UPDATE_TOL = 1e-3      # of the largest update, plus the parameter's fp32 spacing


def range_kernels(event):
    """The device kernels launched below a profiled host event (a
    profiler range): their count and device ms."""
    n = len(event.kernels)
    ms = sum(k.duration for k in event.kernels) / 1e3
    for child in event.cpu_children:
        cn, cms = range_kernels(child)
        n, ms = n + cn, ms + cms
    return n, ms


def attention_backward_phase(torch, dev):
    """Kernel check `fused_dual_attention backward`: at the training shape
    (B = L = 4 local frames, h 4, q = P = 50, k = P + G P = 650, d 64,
    fp32; 650 keys end in a partial chunk of 10) the kernel's forward
    outputs through the wrapper's autograd path against the plain
    version, at `kernel_phase`'s tolerance, with 20% invalid keys and
    with the valid keys in the partial last chunk only; then the
    gradients of all six q/k/v inputs (kernel forward, plain recompute
    backward) against autograd of the plain version on the card, under a
    random upstream gradient on all three outputs. The backward
    recomputes the plain version from the saved inputs, so its gradients
    do not read the kernel's outputs: the gradient check holds how the
    backward is wired up (inputs saved, upstream gradients routed, one
    backward a call), and its math is held against JAX's VJP on the CPU
    (tests/test_torch_port_train.py). Then the forward + backward call,
    the backward alone (its device time in torch.profiler) and the plain
    version's forward + backward, timed. Returns the row's `backward`."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tscd_torch.ops.kernels import fused_attention as fa
    rng = np.random.default_rng(50)
    B, h, q, k, d = 4, 4, 50, 650, 64
    mk = lambda *sh: torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=dev)
    qkv = [mk(B, h, q, d), mk(B, h, k, d), mk(B, h, k, d), mk(B, h, q, d),
           mk(B, h, k, d), mk(B, h, k, d)]
    score = torch.as_tensor(rng.uniform(0, 1, (B, k)).astype(np.float32), device=dev)
    valid = torch.as_tensor(rng.uniform(size=(B, k)) > 0.2, device=dev)
    cot = [mk(B, h, q, d), mk(B, h, q, d), mk(B, h, q, k)]
    ins = [t.clone().requires_grad_(True) for t in qkv]
    ref = [t.clone().requires_grad_(True) for t in qkv]
    # the last 10 keys, a partial chunk, hold every valid key
    last = (torch.arange(k, device=dev) >= k - k % fa.KEY_CHUNK)[None].expand(B, k).contiguous()
    for case, mask in (("20% invalid keys", valid), ("valid keys in the partial last chunk only", last)):
        got_fwd = fa.fused_dual_attention(*ins, score, mask)
        with torch.no_grad():
            want_fwd = fa.fused_dual_attention_plain(*qkv, score, mask)
        torch.cuda.synchronize()
        for part, g, w in zip(("out_cls", "out_reg", "attn"), got_fwd, want_fwd):
            if not torch.isfinite(g).all():
                raise AssertionError(f"attention at the training shape ({case}): non-finite {part}")
            check_close(f"fused_dual_attention training shape (B 4, k 650) {case} {part}",
                        g.detach(), w, atol=1e-5, rtol=1e-4)
    n0, b0 = fa.fused_dual_attention.launches, fa.fused_dual_attention.backward_calls
    got = torch.autograd.grad(fa.fused_dual_attention(*ins, score, valid), ins, cot)
    if (fa.fused_dual_attention.launches - n0, fa.fused_dual_attention.backward_calls - b0) != (1, 1):
        raise AssertionError("the autograd path did not launch the kernel once and "
                             "run its backward once")
    want = torch.autograd.grad(fa.fused_dual_attention_plain(*ref, score, valid), ref, cot)
    errs = {}
    for name, g, w in zip(("qc", "kc", "vc", "qr", "kr", "vr"), got, want):
        errs[name] = float((g - w).abs().max() / w.abs().max())
    ok = all(np.isfinite(v) and v <= ATTN_BWD_TOL for v in errs.values())
    emit({"phase": "kernels", "check": "fused_dual_attention backward (B 4, h 4, q 50, k 650, d 64)",
          "max_rel_err": errs, "tolerance": f"{ATTN_BWD_TOL} of each gradient's max",
          "pass": ok})
    if not ok:
        raise AssertionError(f"attention backward differs from autograd of the plain version: {errs}")

    outs = fa.fused_dual_attention(*ins, score, valid)
    bwd = lambda: torch.autograd.grad(outs, ins, cot, retain_graph=True)
    reps = 50
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            bwd()
        torch.cuda.synchronize()
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                 and e.key != "Activity Buffer Request") / 1e3 / reps
    # recompute (q.k of both branches, attn @ V of both: 8 q k d) and the
    # VJP (dattn from both outputs, dV, dq and dk of both branches: 16 q k
    # d) per (batch, head); each input, upstream gradient and output
    # gradient moved once
    nbytes = 4 * (2 * 2 * B * h * q * d + 4 * B * h * k * d + B * k + B * h * q * k) + B * k
    flops = B * h * 24 * q * k * d
    b_ms, b_by = bound(nbytes, (flops, H100_FP32_FLOPS))
    row = dict(
        route="plain PyTorch recompute: autograd of fused_dual_attention_plain",
        replaces="tscd_tpu/ops/pallas/fused_attention.py:95-106 (_fused_bwd_rule: "
                 "XLA's VJP of dual_attention_reference, no Pallas kernel)",
        shape={"B": B, "h": h, "q": q, "k": k, "d": d}, max_rel_err=max(errs.values()),
        ms=dev_ms, call_ms=cuda_ms(torch, bwd, reps),
        fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            fa.fused_dual_attention(*ins, score, valid), ins, cot), reps),
        plain_fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            fa.fused_dual_attention_plain(*ref, score, valid), ref, cot), reps),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # the same at bf16 q/k/v (the bf16 step's): the gradients in bf16, the
    # VJP computed in fp32 as JAX's is, against autograd of the plain
    # version on the same bf16 values (1e-5 of the largest, plus one bf16
    # ulp of the element: both round one fp32 VJP to bf16)
    ins16 = [t.detach().to(torch.bfloat16).requires_grad_(True) for t in qkv]
    ref16 = [t.detach().clone().requires_grad_(True) for t in ins16]
    b0 = fa.fused_dual_attention.backward_calls
    got16 = torch.autograd.grad(fa.fused_dual_attention(*ins16, score, valid), ins16, cot)
    want16 = torch.autograd.grad(fa.fused_dual_attention_plain(*ref16, score, valid), ref16, cot)
    errs16 = {}
    for name, g, w in zip(("qc", "kc", "vc", "qr", "kr", "vr"), got16, want16):
        w32 = w.float()
        excess = (g.float() - w32).abs() - w32.abs() * 2.0 ** -8
        errs16[name] = float(excess.max() / w32.abs().max())
    ok16 = (fa.fused_dual_attention.backward_calls - b0 == 1
            and all(g.dtype == torch.bfloat16 for g in got16)
            and all(np.isfinite(v) and v <= ATTN_BWD_TOL for v in errs16.values()))
    emit({"phase": "kernels", "check": "fused_dual_attention backward, bf16 q/k/v (B 4, h 4, q 50, "
                                       "k 650, d 64)", "max_rel_err_beyond_one_bf16_ulp": errs16,
          "tolerance": f"{ATTN_BWD_TOL} of each gradient's max beyond one bf16 ulp", "pass": ok16})
    if not ok16:
        raise AssertionError(f"bf16 attention backward differs from the plain version's: {errs16}")
    outs16 = fa.fused_dual_attention(*ins16, score, valid)
    bwd16 = lambda: torch.autograd.grad(outs16, ins16, cot, retain_graph=True)  # noqa: E731
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            bwd16()
        torch.cuda.synchronize()
    dev16 = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and e.key != "Activity Buffer Request") / 1e3 / reps
    # the six bf16 inputs and their bf16 gradients, the fp32 upstream
    # gradients, score and mask; the work is the fp32 recompute's
    qk = 2 * B * h * q * d + 4 * B * h * k * d
    nbytes16 = 2 * 2 * qk + 4 * (2 * B * h * q * d + B * h * q * k + B * k) + B * k
    b16_ms, b16_by = bound(nbytes16, (flops, H100_FP32_FLOPS))
    row16 = dict(row, max_rel_err=max(errs16.values()), ms=dev16, call_ms=cuda_ms(torch, bwd16, reps),
                 fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                     fa.fused_dual_attention(*ins16, score, valid), ins16, cot), reps),
                 plain_fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                     fa.fused_dual_attention_plain(*ref16, score, valid), ref16, cot), reps),
                 bound_ms=b16_ms, bound_by=b16_by)
    return row, row16


def stem_backward_phase(torch, dev):
    """Kernel check `focus_stem backward` at the training shape (16 frames
    of 576 x 576, fp32, 64 channels): the wrapper's autograd path (the
    kernel's forward, JAX's backward rule: the VJP of the fp32 recompute
    of the 6x6 conv) against autograd of the plain fp32 version, the
    gradients of w3, scale and shift (the frames need none in training)
    within 1e-4 of each one's largest value (sums over 1.3 M products in
    other orders); one backward counted; its device time a call (torch.
    profiler), its call time, forward + backward, the plain version's.
    Bound: the recompute and the weight gradient, 2 x the forward's FLOPs,
    at the fp32 rate (its math is held against JAX's `_bwd` on the CPU,
    tests/test_torch_port_train_knobs.py)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tscd_torch.ops.kernels import focus_stem as fs
    rng = np.random.default_rng(60)
    Fr, H, O = 16, 576, 64
    x = torch.as_tensor(rng.uniform(0, 255, (Fr, H, H, 3)).astype(np.float32), device=dev)
    params = [torch.as_tensor(a.astype(np.float32), device=dev) for a in (
        rng.normal(0, 0.05, (O, 12, 3, 3)), rng.uniform(0.5, 1.5, O), rng.normal(0, 0.5, O))]
    g = torch.as_tensor(rng.normal(size=(Fr, O, H // 2, H // 2)).astype(np.float32), device=dev)
    ins = [p.clone().requires_grad_(True) for p in params]
    ref = [p.clone().requires_grad_(True) for p in params]
    b0, n0 = fs.focus_stem.backward_calls, fs.focus_stem.launches
    got = torch.autograd.grad(fs.focus_stem(x, *ins), ins, g)
    if (fs.focus_stem.backward_calls - b0, fs.focus_stem.launches - n0) != (1, 1):
        raise AssertionError("the stem's autograd path did not launch once and run its backward once")
    want = torch.autograd.grad(fs.focus_stem_plain(x, *ref), ref, g)
    errs = {name: float((a - b).abs().max() / b.abs().max())
            for name, a, b in zip(("w3", "scale", "shift"), got, want)}
    ok = all(np.isfinite(v) and v <= 1e-4 for v in errs.values())
    emit({"phase": "kernels", "check": "focus_stem backward (16 x 576 x 576, 64 channels)",
          "max_rel_err": errs, "tolerance": "1e-4 of each gradient's max", "pass": ok})
    if not ok:
        raise AssertionError(f"stem backward differs from autograd of the plain version: {errs}")
    out = fs.focus_stem(x, *ins)
    bwd = lambda: torch.autograd.grad(out, ins, g, retain_graph=True)  # noqa: E731
    reps = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            bwd()
        torch.cuda.synchronize()
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                 and e.key != "Activity Buffer Request") / 1e3 / reps
    fwd_flops = 2 * Fr * (H // 2) ** 2 * O * 108
    # frames, weights and the upstream gradient read, the weight gradients written
    nbytes = 4 * (x.numel() + g.numel() + 2 * sum(p.numel() for p in params))
    b_ms, b_by = bound(nbytes, (2 * fwd_flops, H100_FP32_FLOPS))
    return dict(
        route="plain PyTorch recompute: autograd of focus_stem_reference (cuDNN convs)",
        replaces="tscd_tpu/ops/pallas/focus_stem.py:213-221 (_bwd: XLA's VJP of "
                 "_xla_reference, no Pallas kernel)",
        shape={"F": Fr, "H": H, "W": H, "O": O}, max_rel_err=max(errs.values()),
        ms=dev_ms, call_ms=cuda_ms(torch, bwd, reps),
        fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(fs.focus_stem(x, *ins), ins, g), reps),
        plain_fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            fs.focus_stem_plain(x, *ref), ref, g), reps),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def train_window(torch, exp, seed):
    """One seeded training window of `exp`: uint8 frames (F, H, W, 3) at
    exp.input_size, 1-5 seeded boxes a frame as (F, 120, 5) [cls, cx, cy,
    w, h] labels, the time embedding of frames 0..F-1."""
    import numpy as np

    from tscd_torch.ops.position import get_timing_signal_1d
    rng = np.random.default_rng(seed)
    F = exp.lframe + exp.gframe
    H, W = exp.input_size
    x = rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8)
    lab = np.zeros((F, 120, 5), np.float32)
    for f in range(F):
        n = int(rng.integers(1, 6))
        wh = rng.uniform(0.05, 0.5, (n, 2)) * (W, H)
        cxy = rng.uniform(wh / 2, (W, H) - wh / 2)
        lab[f, :n] = np.concatenate([rng.integers(0, exp.num_classes, (n, 1)), cxy, wh], 1)
    te = get_timing_signal_1d(np.arange(F, dtype=np.float32), 256)
    return torch.from_numpy(x), torch.from_numpy(lab), torch.from_numpy(te)


def boxes_near_proposals(torch, exp, window, seed):
    """`window` with each local frame's first 3 gts moved near the boxes of
    the seeded model's first 3 proposals there (centres a pixel or two
    off, sizes 10-40% larger), so that the refined losses see fg."""
    import numpy as np

    from tscd_torch.models.tscd import random_init_
    x, lab, te = window
    model = random_init_(exp.get_model(device="cpu"), exp.seed)
    b = model(x, te, exp.lframe, exp.gframe)["proposals"].boxes[:exp.lframe, :3].numpy()
    rng = np.random.default_rng(seed)
    cxcywh = np.concatenate([(b[..., :2] + b[..., 2:]) / 2, b[..., 2:] - b[..., :2]], -1)
    cxcywh[..., :2] += rng.uniform(-2, 2, cxcywh[..., :2].shape)
    cxcywh[..., 2:] *= rng.uniform(1.1, 1.4, cxcywh[..., 2:].shape)
    lab = lab.clone()
    lab[:exp.lframe, :3, 1:] = torch.from_numpy(cxcywh.astype(np.float32))
    lab[:exp.lframe, :3, 0] = torch.from_numpy(
        rng.integers(0, exp.num_classes, (exp.lframe, 3)).astype(np.float32))
    return x, lab, te


def one_train_step(torch, exp, dev, window, iters, step0):
    """A stage-2 step of `exp`'s model, seeded weights, on `dev`, from
    update count `step0` (past warm-up); returns the host copies of the
    losses, the state before and after, the EMA and the step's LR."""
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.step import init_train_state, train_step
    model = random_init_(exp.get_model(device=dev), exp.seed)
    opt = exp.get_optimizer(model, iters)
    opt.count = step0
    st = init_train_state(model, opt, exp.ema_decay)
    host = lambda sd: {k: v.detach().cpu().clone() for k, v in sd.items()}
    before = host(model.state_dict())
    lr = opt.lr()
    losses = train_step(st, *(t.to(dev) for t in window), exp.lframe, exp.gframe,
                        ota_mode=exp.ota_mode, fix_bn=exp.fix_bn)
    return ({k: float(v) for k, v in losses.items()}, before, host(model.state_dict()),
            host(st.ema.state_dict()), lr)


def step_agreement(torch, exp, window, iters, step0):
    """One stage-2 step of `exp`'s model from the same seeded weights and
    window, past warm-up, on the card machine's CPU (plain versions) and
    on the card (kernels): the record of how far they agree and whether
    within the bounds (losses TRAIN_LOSS_RTOL relative, updates and EMA
    TRAIN_UPDATE_TOL of the largest update beyond the fp32 spacing, the
    backbone bit-unchanged, every loss finite and the refined ones
    driven)."""
    import numpy as np
    cpu = one_train_step(torch, exp, "cpu", window, iters, step0)
    gpu = one_train_step(torch, exp, card(torch), window, iters, step0)
    loss_err = max(abs(gpu[0][k] - v) / max(abs(v), 1e-6) for k, v in cpu[0].items())
    before = gpu[1]
    trained = [k for k, v in before.items() if not k.startswith("backbone") and v.is_floating_point()]
    frozen = all(torch.equal(before[k], gpu[2][k]) for k in before if k.startswith("backbone"))
    upd = {k: (cpu[2][k].double() - cpu[1][k].double()) for k in trained}
    dmax = max(float(u.abs().max()) for u in upd.values())
    upd_err = max_err(gpu[2], cpu[2], trained)
    ema_err = max_err(gpu[3], cpu[3], [k for k, v in gpu[3].items() if v.is_floating_point()])
    finite = all(np.isfinite(v) for v in gpu[0].values())
    refined = cpu[0]["loss_refined_cls"] > 0 and cpu[0]["loss_matched_iou"] > 0
    ok = (frozen and finite and refined and gpu[4] > 0 and loss_err <= TRAIN_LOSS_RTOL and dmax > 0
          and upd_err <= TRAIN_UPDATE_TOL * dmax and ema_err <= TRAIN_UPDATE_TOL * dmax)
    return {"step": step0, "lr": gpu[4], "losses_card": gpu[0], "losses_cpu": cpu[0],
            "loss_max_rel_err": loss_err, "max_update": dmax,
            "update_max_err_beyond_spacing": upd_err, "ema_max_err_beyond_spacing": ema_err,
            "backbone_bit_unchanged": frozen,
            "tolerance": {"losses": f"{TRAIN_LOSS_RTOL} relative",
                          "updates and EMA": f"{TRAIN_UPDATE_TOL} of the largest update "
                                             "beyond each parameter's fp32 spacing"},
            "pass": ok}


def train_small_phase(torch):
    """The selftest config (depth 0.33, width 0.125, P = 6, 2 + 2 frames,
    128 px): one stage-2 step from the same seeded weights, window and
    boxes, past warm-up, on the card machine's CPU (plain versions) and on
    the card (kernels): losses, parameter updates and EMA must agree, the
    backbone stay bit-unchanged. The local frames hold gts near the
    model's own proposals, so that every loss term is driven."""
    from tscd_torch.exp.tscd_large import selftest_exp
    exp = selftest_exp()
    iters = 4
    step0 = iters * exp.warmup_epochs + 1
    window = boxes_near_proposals(torch, exp, train_window(torch, exp, 41), 42)
    rec = step_agreement(torch, exp, window, iters, step0)
    emit({"phase": "train_small", "config": "selftest 2+2 frames 128px P=6", **rec})
    if not rec["pass"]:
        raise AssertionError("train_small: the card's step departs from the CPU's")


def train_phase(torch, counters, steps=8):
    """TSCD-Large stage 2 through TSCDTrainer as the recipe runs its first
    epoch: the 720p fixture video's JPEG files (32 frames, 3 boxes a frame:
    8 windows of 4 + 12 frames at 576 px, decoded by the port), epoch 0 of
    the 7 (warm-up LRs), HSV jitter (hsv_prob 1.0) and flip (0.5) from the
    one loader, pinned uploads. Every step timed with CUDA events, every
    window's collate timed on the host; the wrappers' launches over the
    run; a checkpoint saved and loaded back; then one more step under
    torch.profiler (launches in the device trace, the attention's backward
    recompute, device busy ms) whose EMA is checked against the formula;
    the backbone bit-unchanged; the EMA weights evaluated."""
    import shutil

    import numpy as np

    from tscd_torch.data import vid
    from tscd_torch.data.vid import WindowLoader
    from tscd_torch.exp.tscd_large import Exp
    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.train.checkpoint import load_checkpoint
    from tscd_torch.train.ema import ema_decay

    exp = Exp()
    video = os.path.join(HERE, FILE_FIXTURE, "vid")
    exp.data_dir, exp.train_seq_path = video, os.path.join(video, "val_seq.npy")
    exp.output_dir = os.path.join(HERE, "build", "train_phase")
    exp.print_interval = steps
    exp.eval_interval = exp.max_epoch + 1          # evaluated below, after the counts
    args = type("Args", (), {"start_epoch": 0})()
    shutil.rmtree(exp.output_dir, ignore_errors=True)
    trainer = exp.get_trainer(args)
    trainer.max_epoch = 1              # epoch 0 of the recipe's schedule
    step_fn, marks, records, frozen = trainer.step, [], [], {}
    collate_ms, collate = [], vid.collate_window

    def timed_collate(*a, **k):
        t = time.perf_counter()
        out = collate(*a, **k)
        collate_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_step(frames, labels, te):
        if not records:
            frozen.update({k: v.clone() for k, v in trainer.model.state_dict().items()
                           if k.startswith("backbone")})
        marks.append(time.perf_counter())
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses = step_fn(frames, labels, te)
        b.record()
        records.append((a, b, losses))
        return losses

    vid.collate_window = timed_collate
    trainer.step = timed_step
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    fa.fused_dual_attention.backward_calls = 0
    t0 = time.perf_counter()
    try:
        state = trainer.train()
    finally:
        vid.collate_window = collate
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    backward_calls = fa.fused_dual_attention.backward_calls
    n = len(records)
    opt = state.optimizer
    lrs = [opt.lr(opt.count - n), opt.lr(opt.count - 1)]
    want = {"focus_stem": n, "fused_dual_attention": 2 * n,
            "hungarian": exp.lframe * n, "nms": 0}
    if n != steps or launches != want or backward_calls != 2 * n:
        raise AssertionError(f"{n} steps (of {steps}); wrapper launches {launches} != {want} "
                             f"or {backward_calls} attention backwards")
    losses = [{k: float(v) for k, v in r[2].items()} for r in records]
    if not all(np.isfinite(v) for row in losses for v in row.values()):
        raise AssertionError(f"non-finite losses {losses}")
    step_ms = [a.elapsed_time(b) for a, b, _ in records]
    timed_ms = step_ms[2:]

    # the epoch's checkpoint loads back to the same state
    ckpt = load_checkpoint(os.path.join(trainer.file_name, "latest_ckpt.pth"))
    same_ckpt = (ckpt["start_epoch"] == 1 and ckpt["step"] == state.step
                 and all(torch.equal(ckpt["model"][k], v.cpu()) for k, v in state.ema.state.items())
                 and all(torch.equal(ckpt["raw_model"][k], v.cpu())
                         for k, v in state.model.state_dict().items())
                 and all(torch.equal(ckpt["optimizer"]["trace"][k], v.cpu())
                         for k, v in state.optimizer.trace.items()))
    ckpt_mb = os.path.getsize(os.path.join(trainer.file_name, "latest_ckpt.pth")) / 2 ** 20
    shutil.rmtree(exp.output_dir, ignore_errors=True)
    if not same_ckpt:
        raise AssertionError("the saved checkpoint does not load back to the trained state")

    # one more step, traced: launches in the device trace, the backward's
    # recompute, the device's busy time; its EMA against the formula. The
    # trace goes through `traced` (the lead-in), and one that lacks a
    # launch and has none too many lost records (PERF.md §7): the step is
    # traced again, 3 times in all
    from torch.autograd import DeviceType
    batch = next(iter(trainer._loader(0)))
    frames, labels, te = trainer._upload(batch)
    # every TRACE_NAMES row as the device trace counts it: a step runs the
    # fp32 stem once, the fp32 attention twice, the solver a local frame,
    # and no NMS walk and no bf16 kernel
    want_trace = dict.fromkeys(TRACE_NAMES, 0)
    want_trace.update({"focus_stem": 1, "fused_dual_attention": 2, "hungarian": exp.lframe})
    for attempt in range(1, 4):
        torch.cuda.synchronize()
        ema_before = {k: v.clone() for k, v in state.ema.state.items() if v.is_floating_point()}
        with traced(torch) as prof:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            step_fn(frames, labels, te)
            b.record()
            torch.cuda.synchronize()
        traced_ms = a.elapsed_time(b)
        d = float(ema_decay(state.step, exp.ema_decay))
        keep = float(np.float32(1) - np.float32(d))
        new = state.model.state_dict()
        ema_err = max(float((state.ema.state[k] - (e * d + new[k] * keep)).abs().max())
                      for k, e in ema_before.items())
        trace = trace_launches(prof)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation and e.key != "Activity Buffer Request"
                   and LEAD_IN not in e.key]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        bwd = [range_kernels(e) for e in prof.events()
               if e.name == fa.BACKWARD_RANGE and e.device_type == DeviceType.CPU]
        per_step = {**trace, "fused_dual_attention_backward_calls": len(bwd),
                    "fused_dual_attention_backward_kernels": sum(k for k, _ in bwd)}
        if trace == want_trace and len(bwd) == 2 and all(k for k, _ in bwd):
            break
        lost = all(v <= want_trace[k] for k, v in trace.items()) and len(bwd) == 2
        emit({"phase": "trace", "train_step": per_step, "want": want_trace,
              "attempt": attempt, "lost_records_only": lost})
        if not lost or attempt == 3:
            raise AssertionError(f"a traced training step's launches {per_step}, "
                                 f"{want_trace} and 2 backward ranges expected")
    per_step["trace_attempts"] = attempt
    after = state.model.state_dict()
    bit_unchanged = all(torch.equal(after[k], v) for k, v in frozen.items())
    if not bit_unchanged or ema_err > 1e-6:
        raise AssertionError(f"backbone changed ({not bit_unchanged}) or the EMA departs "
                             f"from the formula by {ema_err}")
    table = sorted(({"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in kernels), key=lambda r: -r["ms"])
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "profile_train_step.json"), "w") as f:
        json.dump({"by_class": breakdown(table, TRAIN_KERNEL_CLASSES), "kernels": table}, f)

    val = SyntheticVID(exp, videos=1, frames=8, seed=24)
    trainer.val_loader = WindowLoader(val, pin_memory=True)
    ap50 = trainer.evaluate()
    emit({"phase": "train", "config": TRAIN_CONFIG, "steps": n, "windows": len(trainer.dataset.res),
          "data": "fixture JPEGs 1280x720 decoded by the port", "epoch": 0,
          "hsv_prob": exp.hsv_prob, "flip_prob": exp.flip_prob, "lr_first_last": lrs,
          "losses": losses, "step_ms": step_ms,
          "median_step_ms_after_2": float(np.median(timed_ms)),
          "collate_ms_per_window": collate_ms,
          "median_collate_ms": float(np.median(collate_ms)), "host_cpu": host_cpu(),
          "collate_sets_the_pace": float(np.median(collate_ms)) > float(np.median(timed_ms)),
          "frames_per_s": 16 * len(timed_ms) / (sum(timed_ms) / 1e3),
          "loop_frames_per_s": 16 * (n - 1) / (marks[-1] - marks[0]),
          "train_s": train_s, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "wrapper_launches": launches, "attention_backward_calls": backward_calls,
          "traced_step": {"step_ms": traced_ms, "device_busy_ms": busy_ms,
                          "device_busy_share": busy_ms / traced_ms,
                          "launches": per_step,
                          "attention_backward_ms": sum(ms for _, ms in bwd),
                          "by_class": breakdown(table, TRAIN_KERNEL_CLASSES),
                          "kernels": sum(r["calls"] for r in table), "top": table[:12]},
          "ema_formula_max_err": ema_err, "backbone_bit_unchanged": bit_unchanged,
          "checkpoint_round_trip": same_ckpt, "checkpoint_mb": ckpt_mb,
          "eval_ap50_of_ema": ap50, "eval_windows": len(val.res)})
    if not np.isfinite(ap50):
        raise AssertionError("evaluate() gave no AP50")
    return per_step


# -- the rest of JAX's stage-2 trainer: bf16, train-mode BN, backbone
# gradients and remat, window batches --------------------------------------

TRAIN_BF16_CONFIG = ("TSCD-Large 4+12 frames 576px P=50, bf16 (fp32 masters), fix_bn, "
                     "stop_backbone_grad, backbone frozen, constant LR 0.01 "
                     "(bench.py:section_train)")
# card vs the card machine's CPU with train-mode BN (fp32, TF32 off): the
# losses (relative) and the new running statistics (of the largest)
TRAIN_BN_TOL = 1e-4
# remat recomputes the same backbone forward: each gradient within this
# of its largest value of the gradients without remat
REMAT_GRAD_TOL = 1e-6
# B windows' accumulated gradient against the mean of the windows' own
# gradients, of each gradient's largest value (fp32 sums of two terms in
# another order at most)
WINDOW_GRAD_TOL = 1e-5


def large_exp():
    """TSCD-Large's exp (the training parts' model)."""
    from tscd_torch.exp.tscd_large import Exp
    return Exp()


def base_exp():
    """TSCD-Base's exp (exps/TSCD_VID/vid_tscd_base.py)."""
    from tscd_torch.exp import TSCDBaseExp
    return TSCDBaseExp()


def card(torch):
    return torch.device("cuda")


def bench_train_inputs(torch, dev, H=576, Lt=4, Ft=16, seed=0):
    """bench.py:section_train's inputs (:447-457): fp32 frames uniform in
    [0, 255) from seed 0, 6 boxes of 40-160 px a frame (12-48 px below 576
    px, as its tiny size) in 40 gt slots, the time embedding of frames
    0..F-1; on `dev`."""
    import numpy as np

    from tscd_torch.ops.position import get_timing_signal_1d
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (Ft, H, H, 3)).astype(np.float32)
    te = get_timing_signal_1d(np.arange(Ft), 256).astype(np.float32)
    lab = np.zeros((Ft, 40, 5), np.float32)
    lo, hi = (40, 160) if H >= 576 else (12, 48)
    for f in range(Ft):
        for g in range(6):
            wh = rng.uniform(lo, hi, 2)
            cxy = rng.uniform(wh / 2, H - wh / 2)
            lab[f, g] = [rng.integers(0, 30), *cxy, *wh]
    return tuple(torch.from_numpy(a).to(dev) for a in (x, lab, te))


def train_model(torch, exp, sd32, dev, dtype, **knobs):
    """`exp`'s TSCD at `dtype` on `dev` with the fp32 weights `sd32`
    (cast on load; BN not folded), `knobs` its training fields."""
    from tscd_torch.models.tscd import TSCD
    model = TSCD(num_classes=exp.num_classes, depth=exp.depth, width=exp.width,
                 num_proposals=exp.num_proposals, minimal_limit=exp.minimal_limit,
                 heads=exp.heads, device=dev, dtype=dtype, **knobs)
    model.load_state_dict(sd32)
    return model


def capture_grads(opt, model):
    """Makes `opt.step` keep the gradients it sees, {name: fp32 clone} (a
    bf16 parameter's from its master), in the returned dict."""
    grads, step = {}, opt.step

    def wrapped():
        opt.accumulate()
        for n, p in model.named_parameters():
            g = opt.masters[n].grad if n in opt.masters else p.grad
            if g is not None:
                grads[n] = g.float().clone()
        step()
    opt.step = wrapped
    return grads


def timed_steps(torch, run, n, warmup=2, reset=None):
    """`run()` warmup + n times, CUDA events around each, peak memory from
    the first: the n timed steps' ms, their wall seconds (synchronised, as
    bench.py times its 8 steps) and the peak GB. `reset()`, where given,
    runs before each step, outside its events."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records = []
    for i in range(warmup + n):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if reset is not None:
            reset()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        records.append((a, b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([a.elapsed_time(b) for a, b in records[warmup:]], wall,
            torch.cuda.max_memory_allocated() / 1e9)


def traced_train_step(torch, run, tag):
    """One `run()` under torch.profiler: each TRACE_NAMES row's launches in
    the device trace, the attention's and the stem's backward ranges
    (calls, kernels, device ms), the device's busy ms and share of the
    step (CUDA events), the step's device time by kernel class (into
    build/profile_<tag>.json)."""
    from torch.autograd import DeviceType

    from tscd_torch.ops.kernels import focus_stem as fs
    from tscd_torch.ops.kernels import fused_attention as fa
    torch.cuda.synchronize()
    with traced(torch) as prof:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
    step_ms = a.elapsed_time(b)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.key != "Activity Buffer Request"
               and LEAD_IN not in e.key]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ranges = {}
    for name, key in ((fa.BACKWARD_RANGE, "attention_backward"), (fs.BACKWARD_RANGE, "stem_backward")):
        got = [range_kernels(e) for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU]
        ranges[key] = {"calls": len(got), "kernels": sum(k for k, _ in got),
                       "ms": sum(ms for _, ms in got)}
    table = sorted(({"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in kernels), key=lambda r: -r["ms"])
    by_class = breakdown(table, TRAIN_KERNEL_CLASSES)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", f"profile_{tag}.json"), "w") as f:
        json.dump({"by_class": by_class, "kernels": table}, f)
    return {"step_ms": step_ms, "device_busy_ms": busy, "device_busy_share": busy / step_ms,
            "launches": trace_launches(prof), **ranges, "by_class": by_class,
            "kernels": sum(r["calls"] for r in table), "top": table[:8]}


# the wrapper (kernel_counters' key) that launches each TRACE_NAMES row
WRAPPER_OF = {"focus_stem": "focus_stem", "focus_stem_bf16": "focus_stem",
              "fused_dual_attention": "fused_dual_attention",
              "fused_dual_attention_bf16": "fused_dual_attention",
              "fused_dual_attention_stream": "fused_dual_attention",
              "hungarian": "hungarian", "nms": "nms"}


def traced_checked(torch, run, tag, name, want, backwards, counters, prepare=None, attempts=3):
    """`traced_train_step` (`prepare()` before it), the wrappers' counts
    set to 0 just before: the wrappers must count `want` ({row: n}, every
    other row 0, each wrapper the sum of its rows) and run `backwards`
    ({range: calls}, the two autograd rules' `backward_calls`) every time,
    or it raises at once; the device trace must hold the same. A trace
    that lacks launches the wrappers counted in that same step is
    torch.profiler dropping records (it has lost a range's spans, and on
    some machines the stem's launch from every trace of the
    backbone-gradient step, while other machines' traces held it): it is
    traced again, `attempts` times at most. Where every trace lacks some,
    the last is kept with what it lost (`trace_lost_launches`); a trace
    with a launch the wrappers did not count, or a backward range missing,
    raises. Each failed trace's counts beside the wrappers' go on the line
    (`failed_traces`)."""
    from tscd_torch.ops.kernels import focus_stem as fs
    from tscd_torch.ops.kernels import fused_attention as fa
    expect = dict.fromkeys(TRACE_NAMES, 0)
    expect.update(want)
    expect_wrappers = dict.fromkeys(counters, 0)
    for row, n in want.items():
        expect_wrappers[WRAPPER_OF[row]] += n
    rules = {"attention_backward": fa.fused_dual_attention, "stem_backward": fs.focus_stem}
    failed = []
    for attempt in range(1, attempts + 1):
        if prepare is not None:
            prepare()
        for c in counters.values():
            c.launches = 0
        for f in rules.values():
            f.backward_calls = 0
        traced = traced_train_step(torch, run, tag)
        wrappers = {k: c.launches for k, c in counters.items()}
        wrapper_bwd = {k: rules[k].backward_calls for k in backwards}
        if wrappers != expect_wrappers or wrapper_bwd != backwards:
            raise AssertionError(f"{name}: the traced step's wrappers launched {wrappers} and ran "
                                 f"backwards {wrapper_bwd}; {expect_wrappers} and {backwards} "
                                 "expected")
        got = {k: traced[k]["calls"] for k in backwards}
        traced["trace_attempts"] = attempt
        traced["failed_traces"] = failed
        if traced["launches"] == expect and got == backwards:
            return traced
        if got != backwards or any(v > expect[k] for k, v in traced["launches"].items()):
            raise AssertionError(f"{name}: the trace holds launches {traced['launches']} and "
                                 f"backwards {got} the wrappers did not count ({expect}, "
                                 f"{backwards})")
        failed.append({"trace_launches": traced["launches"], "trace_kernels": traced["kernels"],
                       "wrapper_launches": wrappers, "wrapper_backwards": wrapper_bwd})
    traced["trace_lost_launches"] = {k: expect[k] - v for k, v in traced["launches"].items()
                                     if v != expect[k]}
    return traced


def trained_delta(after, before, names):
    return {k: after[k].double() - before[k].double() for k in names}


def max_err(got, want, names, spacing=True):
    """max over `names` of |got - want|, beyond the fp32 spacing of want
    where `spacing`."""
    out = 0.0
    for k in names:
        d = (got[k].double() - want[k].double()).abs()
        if spacing:
            d = d - torch_spacing(want[k])
        out = max(out, float(d.max()))
    return out


def torch_spacing(t):
    import numpy as np
    import torch
    return torch.as_tensor(np.spacing(np.abs(t.float().cpu().numpy())), dtype=torch.float64,
                           device=t.device)


def bf16_small_steps(torch, windows=4):
    """The selftest config (depth 0.33, width 0.125, P = 6, 2 + 2 frames,
    128 px): one bench-style step (constant LR 0.01, backbone frozen, its
    gradient stopped, fix_bn) on each of `windows` seeded windows (boxes
    near the model's own proposals), each from the same fp32 weights: the
    port at fp32 and at bf16 on the card machine's CPU and on the card.
    Returns {run: [per window: (losses, params after (fp32 masters), EMA,
    masters, what the step's loss saw: the dense raw outputs `raw`, the
    discrete choices (the proposals' anchor indices `idx` and boxes at
    the local frames, SimOTA's fg mask `fg`) and the loss of the run's
    own head outputs computed on the CPU `losses_on_cpu`)]} and the
    weights."""
    from tscd_torch.exp.tscd_large import selftest_exp
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train import losses as tl
    from tscd_torch.train import step as ts
    from tscd_torch.train.optim import GroupedSGD
    from tscd_torch.train.step import init_train_state, train_step
    exp = selftest_exp()
    L = exp.lframe
    wins = [boxes_near_proposals(torch, exp, train_window(torch, exp, 41 + 2 * i), 42 + 2 * i)
            for i in range(windows)]
    sd32 = random_init_(exp.get_model(device="cpu"), exp.seed).state_dict()
    host = lambda sd: {k: v.detach().float().cpu() for k, v in sd.items()}  # noqa: E731
    seen, simota, loss = {}, tl.simota_assign, ts.tscd_loss

    def simota_seen(*a, **k):
        tgt = simota(*a, **k)
        seen["fg"] = tgt.fg_mask.cpu()
        return tgt

    def on_cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        if isinstance(x, dict):
            return {k: on_cpu(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(on_cpu(v) for v in x))
        return x

    def loss_seen(out, labels, *a, **k):
        seen["idx"] = out["proposals"].idx[:L].cpu()
        seen["boxes"] = out["proposals"].boxes[:L].detach().float().cpu()
        seen["raw"] = out["raw_outputs"].detach().float().cpu()
        with torch.no_grad():
            seen["losses_on_cpu"] = {k2: float(v) for k2, v in loss(
                on_cpu(out), labels.cpu(), *a, **k).items()}
        return loss(out, labels, *a, **k)
    runs = {}
    tl.simota_assign, ts.tscd_loss = simota_seen, loss_seen
    try:
        for name, dev, dtype in (("cpu_fp32", "cpu", torch.float32),
                                 ("cpu_bf16", "cpu", torch.bfloat16),
                                 ("card_fp32", card(torch), torch.float32),
                                 ("card_bf16", card(torch), torch.bfloat16)):
            runs[name] = []
            for window in wins:
                model = train_model(torch, exp, sd32, dev, dtype, stop_backbone_grad=True)
                opt = GroupedSGD(model.named_parameters(), lambda i: 0.01,
                                 freeze_prefixes=("backbone",), masters=sd32)
                st = init_train_state(model, opt, exp.ema_decay)
                losses = train_step(st, *(t.to(dev) for t in window), exp.lframe, exp.gframe)
                runs[name].append(({k: float(v) for k, v in losses.items()},
                                   host(st.model_state()), host(st.ema.state_dict()),
                                   dict(opt.masters), dict(seen)))
    finally:
        tl.simota_assign, ts.tscd_loss = simota, loss
    return runs, sd32


def train_bf16_small(torch):
    """The bf16 step of the selftest config on the card against the same
    step on the card machine's CPU, window by window (4 windows), each
    within BF16_SPREAD x that window's own CPU bf16-to-fp32 distance (max
    |difference|): the dense raw outputs the loss reads (the bf16 stem
    kernel, the convs), the parameter updates and the EMA (every
    gradient, the bf16 attention's backward included). The losses are
    held through their inputs: each run's losses equal the CPU's
    tscd_loss of that run's own head outputs (TRAIN_BN_TOL relative), so
    that the card's losses differ from the CPU's only where its bf16
    outputs do. Their own card-vs-CPU distance is printed, not held: a
    loss term rests on a few proposals, and the refined ones on the
    proposals' bf16 boxes (encode_reg_targets divides by the box and
    takes its log), which two bf16 runs round a few percent apart; on
    the selftest window 0 the matched-IoU term moved 0.104 between card
    and CPU with the same proposals and the same SimOTA fg, while the
    CPU's own bf16 moved it 0.020 from fp32 and the card's 0.085 (PERF.md
    section 4). Printed beside each window: the card's own bf16-to-fp32
    distance, each loss term's differences, the largest update beside
    the update bound, and the discrete choices (proposal anchors, SimOTA's
    fg mask) compared between the runs with the largest relative
    difference of the proposals' boxes. Every bf16 parameter must train
    on an fp32 master and the EMA be fp32."""
    import numpy as np
    runs, sd32 = bf16_small_steps(torch)
    masters = runs["card_bf16"][0][3]
    trained = [k for k in sd32 if not k.startswith("backbone") and "running_" not in k
               and not k.endswith("num_batches_tracked")]

    def vec(run, what, w):
        losses, params, ema, _, seen = runs[run][w]
        if what == "losses":
            return np.array([losses[k] for k in sorted(losses)])
        if what == "raw_outputs":
            return seen["raw"].double().flatten().numpy()
        src = params if what == "updates" else ema
        return np.concatenate([(src[k].double() - (sd32[k].double() if what == "updates" else 0))
                               .flatten().numpy() for k in trained])

    def choices(a, b):
        ca, cb = runs[a][w][4], runs[b][w][4]
        rel = ((ca["boxes"] - cb["boxes"]).abs() / cb["boxes"].abs().clamp(min=1.0)).max()
        return {"proposal_anchors_equal": bool(torch.equal(ca["idx"], cb["idx"])),
                "simota_fg_equal": bool(torch.equal(ca["fg"], cb["fg"])),
                "proposal_boxes_max_rel_diff": float(rel)}

    per_window, ok = [], True
    for w in range(len(runs["card_bf16"])):
        row = {}
        for what in ("raw_outputs", "updates", "ema", "losses"):
            c16, c32, g16, g32 = (vec(r, what, w) for r in ("cpu_bf16", "cpu_fp32", "card_bf16",
                                                            "card_fp32"))
            gap, ref = distance(g16, c16), distance(c16, c32)
            row[what] = {"card_vs_cpu_bf16": gap, "cpu_bf16_vs_fp32": ref,
                         "card_bf16_vs_fp32": distance(g16, g32),
                         "card_vs_cpu_fp32": distance(g32, c32)}
            if what != "losses":
                row[what]["bound"] = BF16_SPREAD * ref["max"]
                row[what]["pass"] = gap["max"] <= BF16_SPREAD * ref["max"]
                ok = ok and row[what]["pass"]
            if what == "updates":
                row[what]["largest_update"] = float(np.abs(c16).max())
        own = max(abs(runs[r][w][0][k] - v) / max(abs(v), 1e-6) for r in runs
                  for k, v in runs[r][w][4]["losses_on_cpu"].items())
        row["losses"]["loss_of_own_outputs_max_rel_err"] = own
        ok = ok and own <= TRAIN_BN_TOL
        terms = sorted(runs["cpu_bf16"][w][0])
        row["loss_terms"] = {k: {"card_minus_cpu_bf16": runs["card_bf16"][w][0][k]
                                 - runs["cpu_bf16"][w][0][k],
                                 "cpu_bf16_minus_fp32": runs["cpu_bf16"][w][0][k]
                                 - runs["cpu_fp32"][w][0][k],
                                 "card_bf16_minus_fp32": runs["card_bf16"][w][0][k]
                                 - runs["card_fp32"][w][0][k]} for k in terms}
        row["choices"] = {"card_vs_cpu_bf16": choices("card_bf16", "cpu_bf16"),
                          "cpu_bf16_vs_fp32": choices("cpu_bf16", "cpu_fp32"),
                          "card_vs_cpu_fp32": choices("card_fp32", "cpu_fp32")}
        per_window.append(row)
    fp32_state = all(v.dtype == torch.float32 for v in masters.values())
    finite = all(np.isfinite(v) for r in runs["card_bf16"] for v in r[0].values())
    ok = ok and fp32_state and len(masters) > 100 and finite
    row = {"config": "selftest 2+2 frames 128px P=6, bf16, LR 0.01, 4 windows",
           "windows": per_window, "bf16_parameters_with_fp32_masters": len(masters),
           "tolerance": f"each window: the dense raw outputs, the updates and the EMA card vs "
                        f"CPU bf16 within {BF16_SPREAD} x that window's CPU bf16-to-fp32 "
                        f"distance (max |difference|); each run's losses the CPU loss of its "
                        f"own outputs within {TRAIN_BN_TOL} relative",
           "pass": ok}
    if not ok:
        emit({"phase": "train_bf16", "part": "selftest card vs cpu", **row})
        raise AssertionError("train_bf16: the card's bf16 step departs from the CPU's")
    return row


def train_bf16_phase(torch, counters, steps=8):
    """bench.py:section_train's step on the port: TSCD-Large computing in
    bf16 (fp32 masters in the optimizer and the EMA), 4 + 12 frames at
    576 px from bench's inputs, constant LR 0.01, the backbone frozen and
    its gradient stopped, fix_bn. Each step starts from the same seeded
    state (weights, masters, momentum, count; restored outside its
    events), where bench.py chains its steps: chained from these random
    weights the step diverges at fp32 as at bf16 (`--phase
    train_bf16_chain`: a NaN gradient at step 10 at fp32 and at step 9
    at bf16, both from the IoU loss's area product of a predicted box
    that overflows, which JAX computes alike, tscd_tpu/ops/boxes.py:97),
    and the solver would then take NaN costs; at bench's tiny shape JAX's
    chain and the port's stay finite and close at both dtypes
    (tests/torch_port_chained_steps.py; PERF.md section 4). Median
    step (CUDA events, after 2), frames/s as bench.py:495 counts them (F
    x steps / wall s of the 8, the restores' copies included), peak
    memory, a traced step (the bf16 stem, the bf16 attention forward and
    backward, the solver; busy share); then the selftest bf16 step on the
    card against the CPU (`train_bf16_small`)."""
    import numpy as np

    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.train.optim import GroupedSGD
    from tscd_torch.train.step import init_train_state, train_step
    exp = large_exp()
    dev = card(torch)
    L, G = exp.lframe, exp.gframe
    sd32 = random_init_(exp.get_model(device=dev), exp.seed).state_dict()
    model = train_model(torch, exp, sd32, dev, torch.bfloat16, stop_backbone_grad=True)
    opt = GroupedSGD(model.named_parameters(), lambda i: 0.01, freeze_prefixes=("backbone",),
                     masters=sd32)
    del sd32
    st = init_train_state(model, opt, exp.ema_decay)
    x, lab, te = bench_train_inputs(torch, dev, exp.input_size[0], L, L + G)
    losses = []
    run = lambda: losses.append(train_step(st, x, lab, te, L, G))  # noqa: E731
    params = dict(model.named_parameters())
    start = {n: t.clone() for n, t in opt.updated.items()}

    @torch.no_grad()
    def reset():
        for n, t in start.items():
            opt.updated[n].copy_(t)
            if n in opt.masters:
                params[n].copy_(t)
            opt.trace[n].zero_()
        opt.count = 0
    for c in counters.values():
        c.launches = 0
    fa.fused_dual_attention.backward_calls = 0
    ms, wall, peak = timed_steps(torch, run, steps, reset=reset)
    n = steps + 2
    launches = {name: c.launches for name, c in counters.items()}
    want = {"focus_stem": n, "fused_dual_attention": 2 * n, "hungarian": L * n, "nms": 0}
    if launches != want or fa.fused_dual_attention.backward_calls != 2 * n:
        raise AssertionError(f"train_bf16: wrapper launches {launches} != {want}")
    host = [{k: float(v) for k, v in r.items()} for r in losses]
    if not all(np.isfinite(v) for r in host for v in r.values()):
        raise AssertionError(f"train_bf16: non-finite losses {host}")
    traced = traced_checked(torch, run, "train_step_bf16", "train_bf16",
                            {"focus_stem_bf16": 1, "fused_dual_attention_bf16": 2, "hungarian": L},
                            {"attention_backward": 2, "stem_backward": 0}, counters,
                            prepare=reset)
    masters_fp32 = (all(m.dtype == torch.float32 for m in opt.masters.values())
                    and all(v.dtype == torch.float32 for v in st.ema.state_dict().values()
                            if v.is_floating_point()))
    small = train_bf16_small(torch)
    emit({"phase": "train_bf16", "config": TRAIN_BF16_CONFIG, "steps": steps,
          "step_ms": ms, "median_step_ms_after_2": float(np.median(ms)),
          "frames_per_s": (L + G) * steps / wall, "peak_mem_gb": peak,
          "losses_first_last": [host[0], host[-1]], "wrapper_launches": launches,
          "fp32_masters_and_ema": masters_fp32, "bf16_parameters": len(opt.masters),
          "traced_step": traced, "selftest_card_vs_cpu": small})
    if not masters_fp32:
        raise AssertionError("train_bf16: a master or an EMA entry is not fp32")
    return traced


def train_bf16_chain_phase(torch, counters, steps=20):
    """bench.py:section_train's chained step (each step from the state the
    one before returned) for `steps` steps at fp32 and at bf16 from the
    same seeded weights: each step's losses and the global norm of its
    gradient before the clip. At the first step whose gradient holds a
    non-finite value the chain stops (its update is not made): the
    parameters whose gradients are non-finite, and the same step redone
    under torch.autograd.detect_anomaly, which names the backward
    function that first returned NaN and the forward line it came from."""
    import warnings

    import numpy as np

    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.losses import tscd_loss
    from tscd_torch.train.optim import GroupedSGD
    from tscd_torch.train.step import init_train_state, train_step
    exp = large_exp()
    dev = card(torch)
    L, G = exp.lframe, exp.gframe
    sd32 = random_init_(exp.get_model(device=dev), exp.seed).state_dict()
    x, lab, te = bench_train_inputs(torch, dev, exp.input_size[0], L, L + G)

    class NonFinite(Exception):
        pass

    for dtype in (torch.float32, torch.bfloat16):
        model = train_model(torch, exp, sd32, dev, dtype, stop_backbone_grad=True)
        opt = GroupedSGD(model.named_parameters(), lambda i: 0.01, freeze_prefixes=("backbone",),
                         masters=sd32)
        st = init_train_state(model, opt, exp.ema_decay)
        rows, found, step = [], {}, opt.step

        def checked():
            opt.accumulate()
            grads = {n: (opt.masters[n].grad if n in opt.masters else p.grad)
                     for n, p in model.named_parameters()}
            grads = {n: g for n, g in grads.items() if g is not None}
            norm = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads.values()])))
            rows.append({"grad_norm": norm})
            if not np.isfinite(norm):
                bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
                found["parameters"] = {"count": len(bad), "first": bad[:12], "last": bad[-4:]}
                raise NonFinite
            step()
        opt.step = checked
        try:
            for _ in range(steps):
                losses = train_step(st, x, lab, te, L, G)
                rows[-1].update({k: float(v) for k, v in losses.items()})
        except NonFinite:
            model.zero_grad(set_to_none=True)
            for m in opt.masters.values():
                m.grad = None
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    with torch.autograd.detect_anomaly(check_nan=True):
                        out = model(x, te, L, G)
                        tscd_loss(out, lab, (8, 16, 32), L)["total_loss"].backward()
                    found["anomaly"] = "the redone step's backward returned no NaN"
                except RuntimeError as e:
                    found["anomaly"] = str(e)
            found["forward_trace"] = [str(w.message)[-4000:] for w in caught
                                      if "anomaly" in str(w.message).lower()
                                      or "Traceback" in str(w.message)][:2]
            found["step"] = len(rows)
        emit({"phase": "train_bf16_chain", "dtype": str(dtype).split(".")[-1],
              "config": TRAIN_BF16_CONFIG, "steps": rows, "first_non_finite": found or None})


def train_bn_small(torch):
    """The selftest config's train-mode-BN step (fix_bn=False) on the card
    against the card machine's CPU: losses and new running statistics
    TRAIN_BN_TOL, updates and EMA TRAIN_UPDATE_TOL of the largest update
    beyond the fp32 spacing (as `train_small`)."""
    from tscd_torch.exp.tscd_large import selftest_exp
    exp = selftest_exp()
    exp.fix_bn = False
    iters = 4
    step0 = iters * exp.warmup_epochs + 1
    window = boxes_near_proposals(torch, exp, train_window(torch, exp, 41), 42)
    cpu = one_train_step(torch, exp, "cpu", window, iters, step0)
    gpu = one_train_step(torch, exp, card(torch), window, iters, step0)
    loss_err = max(abs(gpu[0][k] - v) / max(abs(v), 1e-6) for k, v in cpu[0].items())
    running = [k for k in cpu[2] if ".running_" in k]
    smax = max(float(cpu[2][k].abs().max()) for k in running)
    stats_err = max_err(gpu[2], cpu[2], running, spacing=False) / smax
    moved = sum(not torch.equal(cpu[2][k], cpu[1][k]) for k in running)
    trained = [k for k in cpu[1] if not k.startswith("backbone") and ".running_" not in k
               and cpu[1][k].is_floating_point()]
    dmax = max(float(d.abs().max()) for d in trained_delta(cpu[2], cpu[1], trained).values())
    upd_err = max_err(gpu[2], cpu[2], trained)
    ema_err = max_err({k: gpu[3][k] for k in trained}, cpu[3], trained)
    ok = (loss_err <= TRAIN_BN_TOL and stats_err <= TRAIN_BN_TOL and moved == len(running)
          and dmax > 0 and upd_err <= TRAIN_UPDATE_TOL * dmax and ema_err <= TRAIN_UPDATE_TOL * dmax)
    row = {"config": "selftest 2+2 frames 128px P=6, fix_bn=False", "loss_max_rel_err": loss_err,
           "running_stats_max_err_of_largest": stats_err, "running_stats_moved": moved,
           "max_update": dmax, "update_max_err_beyond_spacing": upd_err,
           "ema_max_err_beyond_spacing": ema_err,
           "tolerance": {"losses, running stats": TRAIN_BN_TOL,
                         "updates, EMA": f"{TRAIN_UPDATE_TOL} of the largest update"},
           "pass": ok}
    if not ok:
        emit({"phase": "train_bn", "part": "selftest card vs cpu", **row})
        raise AssertionError("train_bn: the card's train-mode-BN step departs from the CPU's")
    return row


def large_fp32_state(torch, exp, dev):
    """TSCD-Large (`exp`'s model) on `dev` with seeded weights, and a copy
    of its state to start each step from."""
    from tscd_torch.models.tscd import random_init_
    model = random_init_(exp.get_model(device=dev), exp.seed)
    return model, {k: v.clone() for k, v in model.state_dict().items()}


def fresh_state(model, sd0, exp, iters, step0, window_batch=1):
    from tscd_torch.train.step import init_train_state
    model.load_state_dict(sd0)
    opt = exp.get_optimizer(model, iters, window_batch=window_batch)
    opt.count = step0
    return init_train_state(model, opt, exp.ema_decay)


def train_bn_phase(torch, counters, steps=4):
    """fix_bn=False (train-mode BatchNorm: batch statistics, new running
    averages, JAX's XLA conv route in the stem): the selftest step on the
    card against the CPU (`train_bn_small`), then TSCD-Large in fp32 at the
    `train` phase's shape (4 + 12 frames, 576 px, in-memory window): step
    ms, peak memory, the running statistics moved, and a traced step with
    no stem kernel in it."""
    import numpy as np

    from tscd_torch.train.step import train_step
    small = train_bn_small(torch)
    exp = large_exp()
    exp.fix_bn = False
    dev = card(torch)
    L, G = exp.lframe, exp.gframe
    iters, step0 = 8, 9
    model, sd0 = large_fp32_state(torch, exp, dev)
    st = fresh_state(model, sd0, exp, iters, step0)
    x, lab, te = (t.to(dev) for t in train_window(torch, exp, 43))
    losses = []
    run = lambda: losses.append(train_step(st, x, lab, te, L, G, fix_bn=False))  # noqa: E731
    for c in counters.values():
        c.launches = 0
    ms, _, peak = timed_steps(torch, run, steps)
    launches = {name: c.launches for name, c in counters.items()}
    n = steps + 2
    want = {"focus_stem": 0, "fused_dual_attention": 2 * n, "hungarian": L * n, "nms": 0}
    after = model.state_dict()
    running = [k for k in after if ".running_" in k]
    moved = sum(not torch.equal(after[k], sd0[k]) for k in running)
    finite = all(torch.isfinite(after[k]).all() for k in running) and all(
        np.isfinite(float(v)) for r in losses for v in r.values())
    if launches != want or moved != len(running) or not finite:
        raise AssertionError(f"train_bn: wrapper launches {launches} != {want}, or "
                             f"{moved}/{len(running)} running statistics moved, finite {finite}")
    traced = traced_checked(torch, run, "train_step_bn", "train_bn",
                            {"fused_dual_attention": 2, "hungarian": L},
                            {"attention_backward": 2, "stem_backward": 0}, counters)
    emit({"phase": "train_bn", "config": "TSCD-Large 4+12 frames 576px P=50, fp32, fix_bn=False, "
                                         "stop_backbone_grad, backbone frozen",
          "steps": steps, "step_ms": ms, "median_step_ms_after_2": float(np.median(ms)),
          "frames_per_s": (L + G) * len(ms) / (sum(ms) / 1e3), "peak_mem_gb": peak,
          "wrapper_launches": launches, "stem_launches": launches["focus_stem"],
          "running_stats_moved": moved, "traced_step": traced, "selftest_card_vs_cpu": small})


def train_backbone_grad_phase(torch, counters, steps=3):
    """stop_backbone_grad=False under fix_bn: the backbone's backward runs,
    the stem's through its autograd rule (the kernel forward, the plain
    recompute's VJP). TSCD-Large fp32, 4 + 12 frames at 576 px, from one
    seeded state: the updates equal the stop_backbone_grad=True step's
    (both freeze the backbone; TRAIN_UPDATE_TOL of the largest update
    beyond the fp32 spacing) and the backbone stays bit-unchanged; the
    gradients with remat_backbone equal those without (REMAT_GRAD_TOL of
    each one's largest value); step ms and peak memory without and with
    remat (remat must take less); a traced step: the stem's backward
    calls and device ms."""
    import numpy as np

    from tscd_torch.ops.kernels import focus_stem as fs
    from tscd_torch.train.step import train_step
    exp = large_exp()
    dev = card(torch)
    L, G = exp.lframe, exp.gframe
    iters, step0 = 8, 9
    model, sd0 = large_fp32_state(torch, exp, dev)
    x, lab, te = (t.to(dev) for t in train_window(torch, exp, 44))
    trained = [n for n, _ in model.named_parameters() if not n.startswith("backbone")]
    backbone = [n for n, _ in model.named_parameters() if n.startswith("backbone")]

    def one(stop, remat):
        model.stop_backbone_grad, model.remat_backbone = stop, remat
        st = fresh_state(model, sd0, exp, iters, step0)
        grads = capture_grads(st.optimizer, model)
        b0 = fs.focus_stem.backward_calls
        train_step(st, x, lab, te, L, G)
        after = {k: v.clone() for k, v in model.state_dict().items()}
        return after, grads, fs.focus_stem.backward_calls - b0

    for c in counters.values():
        c.launches = 0
    # cuDNN's deterministic algorithms for the comparisons: with its
    # default ones remat's gradients sat 0.8-1.1e-6 of their largest value
    # from the plain step's on the H100, across REMAT_GRAD_TOL (PERF.md §7)
    torch.backends.cudnn.deterministic = True
    try:
        stopped, g_stop, b_stop = one(True, False)
        opened, g_open, b_open = one(False, False)
        _, g_remat, b_remat = one(False, True)
    finally:
        torch.backends.cudnn.deterministic = False
    dmax = max(float(d.abs().max()) for d in trained_delta(stopped, sd0, trained).values())
    upd_err = max_err(opened, stopped, trained)
    frozen = all(torch.equal(opened[k], sd0[k]) and torch.equal(stopped[k], sd0[k]) for k in backbone)
    remat_err = max(float((g_remat[k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                    for k, g in g_open.items())
    bb_grads = sum(k in g_open for k in backbone)
    times = {}
    for remat in (False, True):
        model.stop_backbone_grad, model.remat_backbone = False, remat
        st = fresh_state(model, sd0, exp, iters, step0)
        ms, _, peak = timed_steps(torch, lambda: train_step(st, x, lab, te, L, G), steps)
        times["remat" if remat else "no_remat"] = {"step_ms": ms, "median_step_ms": float(np.median(ms)),
                                                   "peak_mem_gb": peak}
    launches = {name: c.launches for name, c in counters.items()}
    n, n_remat = 3 + 2 * (steps + 2), 1 + steps + 2
    # remat's backward recomputes the backbone's forward, the stem's kernel included
    want = {"focus_stem": n + n_remat, "fused_dual_attention": 2 * n, "hungarian": L * n,
            "nms": 0}
    if launches != want:
        raise AssertionError(f"train_backbone_grad: wrapper launches {launches} != {want}")
    model.stop_backbone_grad, model.remat_backbone = False, False
    held = {}
    traced = traced_checked(
        torch, lambda: train_step(held["st"], x, lab, te, L, G), "train_step_backbone",
        "train_backbone_grad", {"focus_stem": 1, "fused_dual_attention": 2, "hungarian": L},
        {"attention_backward": 2, "stem_backward": 1}, counters,
        prepare=lambda: held.update(st=fresh_state(model, sd0, exp, iters, step0)))
    ok = (dmax > 0 and upd_err <= TRAIN_UPDATE_TOL * dmax and frozen and bb_grads == len(backbone)
          and g_stop.keys().isdisjoint(backbone) and remat_err <= REMAT_GRAD_TOL
          and (b_stop, b_open, b_remat) == (0, 1, 1)
          and times["remat"]["peak_mem_gb"] < times["no_remat"]["peak_mem_gb"])
    emit({"phase": "train_backbone_grad",
          "config": "TSCD-Large 4+12 frames 576px P=50, fp32, fix_bn, stop_backbone_grad=False, "
                    "backbone frozen",
          "max_update": dmax, "update_vs_stopped_max_err_beyond_spacing": upd_err,
          "backbone_bit_unchanged": frozen, "backbone_gradients": bb_grads,
          "remat_grad_max_rel_err": remat_err, "compared_with_cudnn_deterministic": True,
          "wrapper_launches": launches,
          "stem_backward_calls": {"stopped": b_stop, "open": b_open, "remat": b_remat},
          "stem_backward_ms_per_call": traced["stem_backward"]["ms"],
          "stem_backward_kernels_per_call": traced["stem_backward"]["kernels"],
          **times, "traced_step": traced,
          "tolerance": {"updates": f"{TRAIN_UPDATE_TOL} of the largest update beyond the spacing",
                        "remat gradients": f"{REMAT_GRAD_TOL} of each gradient's largest value"},
          "pass": ok})
    if not ok:
        raise AssertionError("train_backbone_grad: see the line above")
    return traced


def train_window_batch_phase(torch, counters):
    """B = 2 windows a step (TSCD-Large fp32, 4 + 12 frames at 576 px,
    fix_bn) from one seeded state: its gradient is the mean of the two
    windows' own (WINDOW_GRAD_TOL of each one's largest value), its LR
    twice the schedule's; the step's ms and peak memory; the wrappers'
    launches over the part. grad_accum is exact by construction: the
    step runs one window at a time whatever the chunking, so it takes no
    grad_accum (the exp checks that it divides B)."""
    import numpy as np

    from tscd_torch.train.losses import tscd_loss
    from tscd_torch.train.step import train_step
    exp = large_exp()
    dev = card(torch)
    L, G = exp.lframe, exp.gframe
    iters, step0 = 8, 9
    model, sd0 = large_fp32_state(torch, exp, dev)
    wins = [[t.to(dev) for t in train_window(torch, exp, seed)] for seed in (45, 46)]
    batch = [torch.stack([w[i] for w in wins]) for i in range(3)]
    names = [n for n, _ in model.named_parameters()]
    for c in counters.values():
        c.launches = 0
    st = fresh_state(model, sd0, exp, iters, step0, window_batch=2)
    lr = st.optimizer.lr()
    grads = capture_grads(st.optimizer, model)
    train_step(st, *batch, L, G)
    model.load_state_dict(sd0)
    model.train()
    single = []
    for x, lab, te in wins:
        model.zero_grad(set_to_none=True)
        out = model(x, te, L, G)
        tscd_loss(out, lab, (8, 16, 32), L)["total_loss"].backward()
        single.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    mean = {n: (single[0][n] + single[1][n]) / 2 for n in single[0]}
    grad_err = max(float((grads[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                   for n, g in mean.items())
    lr_x2 = lr == 2 * exp.get_lr_schedule(iters)(step0)
    st = fresh_state(model, sd0, exp, iters, step0, window_batch=2)
    ms, _, peak = timed_steps(torch, lambda: train_step(st, *batch, L, G), 2, warmup=1)
    launches = {name: c.launches for name, c in counters.items()}
    n = 2 + 2 + 2 * 3           # windows: the step, the two alone, 3 timed steps
    want = {"focus_stem": n, "fused_dual_attention": 2 * n, "hungarian": L * n, "nms": 0}
    ok = (grad_err <= WINDOW_GRAD_TOL and lr_x2 and launches == want
          and set(mean) == set(grads) - set(n for n in names if n.startswith("backbone")))
    emit({"phase": "train_window_batch",
          "config": "TSCD-Large 2 windows x (4+12 frames) 576px P=50, fp32, fix_bn",
          "lr": lr, "lr_is_twice_the_schedule": lr_x2,
          "grad_vs_mean_of_single_windows_max_rel_err": grad_err,
          "step_ms": ms, "median_step_ms": float(np.median(ms)), "peak_mem_gb": peak,
          "wrapper_launches": launches,
          "tolerance": {"gradients": f"{WINDOW_GRAD_TOL} of each gradient's largest value"},
          "pass": ok})
    if not ok:
        raise AssertionError("train_window_batch: see the line above")


# -- phase files: frame files and JAX checkpoints ------------------------------

FILE_FIXTURE = os.path.join("tscd_torch", "data", "fixtures")
OLD_FIXTURE = os.path.join("YOLOX_outputs", "validate_ref")
# the bf16 evaluator's recorded rate on the card: evaluated local frames/s,
# each a window of 1 + 31 frames that the loader decodes (PERF.md §2)
BF16_EVAL_WINDOWS_PER_S = 26.57
WINDOW_FRAMES = 32


def host_cpu():
    """The host's CPU as /proc/cpuinfo names it (model name, vendor, family
    and model numbers, its widest vector extension) and its core count."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not ln.strip():
                    break
                k, _, v = ln.partition(":")
                info[k.strip()] = v.strip()
    except OSError:
        pass
    flags = info.get("flags", "").split()
    vec = next((x for x in ("avx512f", "avx2", "sse4_2", "asimd") if x in flags), "unknown")
    return {"model": info.get("model name", "not read"), "vendor": info.get("vendor_id"),
            "family": info.get("cpu family"), "model_number": info.get("model"),
            "widest_vector": vec, "cores": os.cpu_count()}


def host_ms(fn, items, reps):
    """Median over `reps` passes of the host ms `fn` takes an item."""
    import numpy as np
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for it in items:
            fn(it)
        times.append((time.perf_counter() - t0) * 1e3 / len(items))
    return float(np.median(times))


def decode_checks():
    """Every frame of both fixtures decoded, letterboxed to 576 px, HSV
    jittered and, in its 576 px window, resized as float32 to two
    multiscale sizes by the port against the sha256 of cv2's pixels for
    the same calls (recorded with cv2 where it exists), then host ms a
    frame of decode, letterbox and HSV round trip at each source size and
    of the multiscale resize, and the decode threads the bf16 evaluator
    needs at its recorded rate."""
    import hashlib

    import numpy as np

    from tscd_torch.data import image
    with open(os.path.join(HERE, FILE_FIXTURE, "vid", "frame_sha256.json")) as f:
        recorded = json.load(f)
    sha = lambda a: hashlib.sha256(a.tobytes()).hexdigest()   # noqa: E731
    bad, by_size, checked = [], {}, 0
    for rel, rec in recorded["frames"].items():
        path = os.path.join(HERE, rel)
        img = image.imread(path)
        h, w = img.shape[:2]
        r = min(576 / h, 576 / w)
        boxed = image.resize_linear(img, int(h * r), int(w * r))
        jittered = boxed.copy()
        image.augment_hsv(jittered, recorded["hsv_gains"])
        window = np.full((576, 576, 3), 114, np.uint8)
        window[:boxed.shape[0], :boxed.shape[1]] = jittered
        got = {"sha256": sha(img), "letterbox_576_sha256": sha(boxed),
               "hsv_jitter_sha256": sha(jittered)}
        want = {op: rec[op] for op in got}
        for size, v in rec["multiscale_sha256"].items():
            th, tw = (int(x) for x in size.split("x"))
            got[f"multiscale_{size}_sha256"] = sha(image.resize_linear_float(window, th, tw))
            want[f"multiscale_{size}_sha256"] = v
        checked += len(got)
        bad += [f"{rel} {op}" for op, v in got.items() if v != want[op]]
        if list(img.shape) != rec["shape"]:
            bad.append(f"{rel} shape")
        with open(path, "rb") as f:
            by_size.setdefault(f"{img.shape[1]}x{img.shape[0]}", []).append(f.read())
    timing = {}
    for size, blobs in sorted(by_size.items()):
        imgs = [image.imdecode(b) for b in blobs]
        h, w = imgs[0].shape[:2]
        r = min(576 / h, 576 / w)
        boxed = [image.resize_linear(i, int(h * r), int(w * r)) for i in imgs]
        timing[size] = {
            "frames": len(blobs), "jpeg_kb_mean": float(np.mean([len(b) for b in blobs])) / 1e3,
            "decode_ms": host_ms(image.imdecode, blobs, 5),
            "letterbox_576_ms": host_ms(lambda i: image.resize_linear(i, int(h * r), int(w * r)),
                                        imgs, 5),
            "letterboxed": [int(h * r), int(w * r)],
            "hsv_round_trip_ms": host_ms(lambda i: image.augment_hsv(i.copy(), (3, 20, -20)),
                                         boxed, 5)}
    big = timing["1280x720"]
    need = BF16_EVAL_WINDOWS_PER_S * WINDOW_FRAMES
    emit({"phase": "files", "part": "decode", "frames": len(recorded["frames"]),
          "ops_checked": ["imread", "letterbox to 576", "HSV jitter with gains "
                          f"{recorded['hsv_gains']}", "float32 multiscale resize of the "
                          "jittered 576 px window to 448 and 704"],
          "sha256_match": checked - len(bad), "sha256_checked": checked, "mismatched": bad,
          "reference": f"cv2 {recorded['cv2']}", "host_cpu": host_cpu(),
          "host_ms_per_frame": timing, "pass": not bad,
          "multiscale_float_576_to_704_ms": host_ms(
              lambda i: image.resize_linear_float(i, 704, 704), [window] * 4, 5),
          "bf16_evaluator_frames_per_s_to_decode": need,
          "decode_threads_for_bf16_evaluator": need * big["decode_ms"] / 1e3,
          "decode_letterbox_threads_for_bf16_evaluator":
              need * (big["decode_ms"] + big["letterbox_576_ms"]) / 1e3})
    if bad:
        raise AssertionError(f"{len(bad)} results differ from cv2's pixels: {bad[:4]}")


def eval_cli(argv, rows):
    """tscd_eval.main(argv) with each window's detection rows appended to
    `rows` (make_predict_fn wrapped where the CLI imports it)."""
    import tscd_torch.core.predict as cp
    from tscd_torch.tools import tscd_eval
    real = cp.make_predict_fn
    cp.make_predict_fn = lambda *a, **k: recording(real(*a, **k), rows)
    try:
        return tscd_eval.main(argv)
    finally:
        cp.make_predict_fn = real


def eval_cli_phase(torch, counters):
    """The eval CLI in process on frame files: the selftest exp from the
    committed JAX variables (converted_ckpt.msgpack, read without flax) on
    the card and on the card machine's CPU, detections and stats 1e-4; then
    TSCD-Large (seeded weights, full width, 1 + 31 frames at 576 px) on the
    720p fixture video, its launches counted in the device trace."""
    import numpy as np

    from tscd_torch.exp.tscd_large import Exp
    from tscd_torch.models.tscd import random_init_
    quiet_opts = ["data_dir", os.path.join(HERE, OLD_FIXTURE, "vid"),
                  "val_seq_path", os.path.join(HERE, OLD_FIXTURE, "vid", "val_seq.npy")]
    ckpt = os.path.join(HERE, OLD_FIXTURE, "converted_ckpt.msgpack")
    out = {}
    for dev in ("cpu", "cuda"):
        rows = []
        res = eval_cli(["--exp", "selftest", "-c", ckpt, "--device", dev, *quiet_opts], rows)
        out[dev] = (res, rows)
    worst, n = match_rows(out["cpu"][1], out["cuda"][1], 1e-4, 1e-4)
    stats_err = float(np.abs(np.subtract(out["cpu"][0]["stats"], out["cuda"][0]["stats"])).max())
    emit({"phase": "files", "part": "eval_cli_selftest", "checkpoint": os.path.relpath(ckpt, HERE),
          "windows": len(out["cuda"][1]), "detections": n, "max_abs_err": worst,
          "stats_max_abs_err": stats_err, "stats": out["cuda"][0]["stats"],
          "tolerance": {"detections": 1e-4, "stats": 1e-4}, "pass": stats_err <= 1e-4})
    if stats_err > 1e-4:
        raise AssertionError(f"eval CLI: the card's stats differ from the CPU's by {stats_err}")

    # TSCD-Large on the 720p fixture, seeded weights saved as a port .pth
    exp = Exp()
    build = os.path.join(HERE, "build", "files_phase")
    os.makedirs(build, exist_ok=True)
    weights = os.path.join(build, "tscd_large_seeded.pth")
    torch.save(random_init_(exp.get_model(device="cpu"), exp.seed).state_dict(), weights)
    video = os.path.join(HERE, FILE_FIXTURE, "vid")
    argv = ["--exp", "tscd_large", "-c", weights, "--device", "cuda",
            "data_dir", video, "val_seq_path", os.path.join(video, "val_seq.npy")]
    # the first window runs eagerly, then its graph is captured (the
    # wrappers run again, recording), then 31 replays run no Python
    per_window = window_launches(1, exp.lframe_val, bf16=False)
    want_wrapped = {name: 2 * per_window[name] for name in counters}
    # a trace that holds fewer launches than the run made, and of no row
    # more, lost records (PERF.md §7): the CLI's run is traced again, 3
    # times in all
    for attempt in range(1, 4):
        for c in counters.values():
            c.launches = 0
        rows = []
        with traced(torch) as prof:
            t0 = time.perf_counter()
            res = eval_cli(argv, rows)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
        wrapped = {name: c.launches for name, c in counters.items()}
        nw = len(rows)
        launches = trace_launches(prof)
        want = window_launches(nw, exp.lframe_val, bf16=False)
        finite = all(r.ndim == 2 and r.shape[1] == 7 and np.isfinite(r).all()
                     for per_frame in rows for r in per_frame)
        ok = (nw == 32 and launches == want and wrapped == want_wrapped and finite
              and len(res["stats"]) == 12 and np.isfinite(res["stats"]).all())
        lost = (not ok and nw == 32 and wrapped == want_wrapped and finite
                and all(launches[k] <= n for k, n in want.items()))
        if not lost or attempt == 3:
            break
        emit({"phase": "trace", "eval_cli_tscd_large": launches, "want": want,
              "attempt": attempt})
    os.remove(weights)
    emit({"phase": "files", "part": "eval_cli_tscd_large",
          "config": "TSCD-Large 1+31 frames 576px P=50, fp32, seeded weights",
          "source": "32 JPEG frames 1280x720 q90 4:2:0", "windows": nw,
          "evaluate_s": eval_s, "frames_per_s_traced": nw * exp.lframe_val / eval_s,
          "launches": launches, "launches_from": "the device trace of the CLI's run",
          "wrapper_launches": wrapped, "traces": attempt,
          "detections": int(sum(len(r) for per_frame in rows for r in per_frame)),
          "stats": res["stats"], "pass": bool(ok)})
    if not ok:
        raise AssertionError(f"TSCD-Large file eval: {nw} windows, trace {launches} != {want} "
                             f"or wrappers {wrapped} != {want_wrapped}, finite {finite}")
    return launches


def multiscale_epoch_phase(torch):
    """One augmented epoch (HSV jitter, flip, multiscale) of the selftest
    exp from the fixture's JPEG files on the card: each step's size is the
    exp's rule at random.Random(updates so far), re-drawn every 10 steps;
    losses finite. At 128 px the video rule's 64-px steps reach 0 px, so
    this epoch takes the still-image rule's 32."""
    import shutil

    import numpy as np

    from tscd_torch.exp.tscd_large import selftest_exp
    exp = selftest_exp()
    exp.enable_multiscale, exp.multiscale_step = True, 32
    exp.max_epoch, exp.eval_interval, exp.hsv_prob, exp.flip_prob = 1, 2, 1.0, 0.5
    exp.output_dir = os.path.join(HERE, "build", "files_phase", "multiscale")
    trainer = exp.get_trainer(device="cuda")
    seen, dtypes, step_fn = [], [], trainer.step

    def step(frames, labels, te):
        seen.append([trainer.state.step, list(frames.shape[1:3])])
        dtypes.append(str(frames.dtype).replace("torch.", ""))
        losses = step_fn(frames, labels, te)
        seen[-1].append(float(losses["total_loss"]))
        return losses

    trainer.step = step
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    shutil.rmtree(exp.output_dir, ignore_errors=True)
    rule = [list(exp.random_input_size(random.Random(s - n % 10))) for n, (s, _, _) in enumerate(seen)]
    # resized windows come as float32, JAX's cv2 values (held by the hashes
    # of decode_checks); a window at the base size stays uint8
    base = list(exp.input_size)
    ok = (len(seen) == len(trainer.dataset.res) > 1 and [hw for _, hw, _ in seen] == rule
          and all(np.isfinite(l) for _, _, l in seen)
          and dtypes == ["uint8" if hw == base else "float32" for hw in rule])
    emit({"phase": "files", "part": "multiscale_epoch", "config": "selftest 2+2 frames, 128px "
          "base, hsv_prob 1.0, flip 0.5, multiscale +-3 x 32px", "steps": len(seen),
          "sizes": [hw for _, hw, _ in seen], "dtypes": dtypes, "losses": [l for _, _, l in seen],
          "train_s": train_s, "pass": ok})
    if not ok:
        raise AssertionError(f"multiscale epoch: sizes {seen} ({dtypes}) against the rule {rule}")


def jax_checkpoint_phase(torch):
    """The JAX trainer's checkpoint of the selftest exp after epoch 0 (its
    msgpack format: EMA params, raw params, batch stats, optax state), read
    without flax and resumed on the card: start epoch 1, the EMA weights,
    the Nesterov traces and the update count restored, then epoch 1 trained
    and evaluated on the fixture's files."""
    import shutil

    import numpy as np

    from tscd_torch.exp.tscd_large import selftest_exp
    from tscd_torch.train.checkpoint import load_checkpoint
    path = os.path.join(HERE, FILE_FIXTURE, "jax_selftest_ckpt.msgpack")
    exp = selftest_exp()
    exp.output_dir = os.path.join(HERE, "build", "files_phase", "resume")
    args = type("Args", (), {"resume": True, "ckpt": path})()
    trainer = exp.get_trainer(args, device="cuda")
    trainer.dataset = exp.get_train_dataset()
    iters = len(trainer.dataset.res)
    trainer._init_state(iters)
    st = trainer.state
    ckpt = load_checkpoint(path, exp.get_model(device="cpu"))
    weights_ok = all(torch.equal(st.ema.state[k].cpu(), v) for k, v in ckpt["model"].items())
    traces_ok = (sorted(ckpt["optimizer"]["trace"]) == sorted(st.optimizer.trained) and all(
        torch.equal(st.optimizer.trace[n].cpu(), t) for n, t in ckpt["optimizer"]["trace"].items()))
    moving = sum(float(t.abs().sum()) for t in st.optimizer.trace.values())
    count = st.optimizer.count
    losses = []
    step_fn = trainer.step
    trainer.step = lambda *a: losses.append(step_fn(*a)) or losses[-1]
    state = trainer.train()
    torch.cuda.synchronize()
    shutil.rmtree(exp.output_dir, ignore_errors=True)
    finite = all(np.isfinite(float(v)) for l in losses for v in l.values())
    ok = (trainer.start_epoch == 1 and weights_ok and traces_ok and moving > 0
          and count == iters and len(losses) == iters and state.step == 2 * iters and finite)
    emit({"phase": "files", "part": "jax_checkpoint_resume",
          "checkpoint": os.path.relpath(path, HERE),
          "checkpoint_mb": os.path.getsize(path) / 2 ** 20, "start_epoch": trainer.start_epoch,
          "ema_weights_restored": weights_ok, "momentum_restored": traces_ok,
          "momentum_abs_sum": moving, "update_count": count, "steps_after": len(losses),
          "losses_last": {k: float(v) for k, v in losses[-1].items()} if losses else None,
          "eval_ap50": trainer.best_ap, "pass": ok})
    if not ok:
        raise AssertionError("the JAX checkpoint did not resume on the card")


def files_phase(torch, counters):
    decode_checks()
    launches = eval_cli_phase(torch, counters)
    multiscale_epoch_phase(torch)
    jax_checkpoint_phase(torch)
    return launches


HAND_KERNELS = ("focus_stem_kernel", "focus_stem_mma", "fused_dual_attention",
                "linear_sum_assignment",
                "nms_pack_iou", "nms_walk_rows")
KERNEL_CLASSES = (   # first match wins
    ("cuDNN implicit-GEMM convs", ("fprop", "implicit_convolve", "convolve_common")),
    ("cuDNN FFT convs", ("fft", "pointwise_mult_and_sum_complex", "cf32cf32")),
    ("cuDNN layout transposes", ("nhwcToNchw", "nchwToNhwc")),
    ("BatchNorm inference", ("bn_fw_inf",)),
    # a conv's bias (the folded BN's shift) added by PyTorch in a
    # broadcast pass of its own after cuDNN's conv
    ("conv bias adds", ("gpu_kernel_impl_nocast<at::native::CUDAFunctor_add",)),
    ("SiLU", ("silu_kernel",)),
    ("hand kernels", HAND_KERNELS),
    ("frame upload", ("Memcpy HtoD",)),
)


# a training step's kernels: the backward's convs and the optimizer too
TRAIN_KERNEL_CLASSES = (   # first match wins
    ("cuDNN FFT convs (FFTs, complex GEMMs, products)",
     ("fft", "pointwise_mult_and_sum_complex", "cf32cf32")),
    ("cuDNN convs, forward (implicit GEMM)", ("fprop", "implicit_convolve")),
    ("cuDNN convs, backward (dgrad, wgrad, winograd)", ("dgrad", "wgrad", "winograd")),
    ("GEMMs (Linear layers, einsums)", ("gemm",)),
    ("BatchNorm forward and backward", ("bn_fw_inf", "batch_norm_backward")),
    ("SiLU forward and backward", ("silu_",)),
    ("hand kernels", HAND_KERNELS),
    ("SGD and EMA (multi-tensor)", ("multi_tensor_apply",)),
    ("sorts (SimOTA top-k, proposals)", ("RadixSort",)),
)


def breakdown(table, classes=KERNEL_CLASSES):
    """Device ms by kernel class over rows {"name", "ms"}."""
    out = {name: 0.0 for name, _ in classes}
    out["the rest"] = 0.0
    for row in table:
        cls = next((name for name, keys in classes
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


def profile_window(torch, pred, exp, state, dtype="fp32"):
    """Device time by kernel over one more window (torch.profiler),
    window 4 resumed from `state` (a video's first window comes once a
    video), dispatched launch by launch, and the window's device-busy
    time; its launches are not counted. Each attention call runs in a
    profiler range, so that the copies made inside it (of its inputs) are
    counted apart. The bf16 model gets uint8 frames, as the loader ships
    them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from tscd_torch.models import aggregation
    from tscd_torch.ops import postprocess
    attend = aggregation.fused_dual_attention
    suppress = postprocess.batched_class_aware_nms

    def ranged(fn, name):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    aggregation.fused_dual_attention = ranged(attend, "aggregation attention call")
    postprocess.batched_class_aware_nms = ranged(suppress, NMS_STAGE)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, lat, _ = run_windows(torch, pred, exp, 1, 7, True, state, 4, eager=True,
                                    uint8=dtype == "bf16")
    finally:
        aggregation.fused_dual_attention = attend
        postprocess.batched_class_aware_nms = suppress
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
    # both NMS calls: everything batched_class_aware_nms launched
    spans = stage_kernels(prof, NMS_STAGE)
    names = [k.name for s in spans for k in s]
    if len(spans) != 2 or not all(any(h in n for n in names) for h in HAND_KERNELS[-2:]):
        raise AssertionError(f"{len(spans)} NMS stage spans in the window, or no hand "
                             f"NMS kernel in them: {names}")
    stage = {"calls": len(spans), "launches": [len(s) for s in spans],
             "ms": [sum(k.time_range.elapsed_us() for k in s) / 1e3 for s in spans],
             "kernels": [[k.name[:80] for k in s] for s in spans]}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    name = "profile_window.json" if dtype == "fp32" else f"profile_window_{dtype}.json"
    with open(os.path.join(HERE, "build", name), "w") as f:
        json.dump({"by_class": by_class, "attention": attention, "nms_stage": stage,
                   "kernels": table}, f)
    # cuDNN's layout transposes, paid where a conv's input and its chosen
    # algorithm disagree on the memory format
    emit({"phase": "profile", "dtype": dtype, "sequence_start": False, "window_ms": lat[0],
          "by_class": by_class,
          "device_busy_ms": sum(r[1] for r in rows),
          "transpose_ms": by_class["cuDNN layout transposes"],
          "attention": attention,
          "hungarian_ms": sum(r["ms"] for r in table if "linear_sum_assignment" in r["name"]),
          "nms_ms": sum(r["ms"] for r in table if "nms_" in r["name"]),
          "nms_stage_ms": sum(stage["ms"]), "nms_stage": stage,
          "top": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:15]]})


def replay_breakdown(prof, windows):
    """Device ms a window by kernel class in the traced graph replays of
    the bf16 phase, as `profile_window` classes an eager window; every
    kernel into build/profile_replay_bf16.json."""
    from torch.autograd import DeviceType
    table = [{"name": e.key, "ms": e.self_device_time_total / 1e3 / windows,
              "calls": e.count / windows}
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation
             and e.key != "Activity Buffer Request" and LEAD_IN not in e.key]
    table.sort(key=lambda r: -r["ms"])
    by_class = breakdown(table)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "profile_replay_bf16.json"), "w") as f:
        json.dump({"windows": windows, "by_class": by_class, "kernels": table}, f)
    emit({"phase": "profile", "dtype": "bf16", "graph_replay": True, "windows": windows,
          "kernels_a_window": sum(r["calls"] for r in table),
          "device_busy_ms": sum(r["ms"] for r in table), "by_class": by_class,
          "hand_kernels": [r for r in table if any(k in r["name"] for k in HAND_KERNELS)]})


# -- phase heads: the rest of the TSCD head, and TSCD-Base ------------------

# rows of the kernels line at this phase's shapes: {row: (the row whose
# kernel it is, the shape)}
HEAD_ROWS = {
    "nms_prenms": ("nms", "use_pre_nms: 32 frames x K = 750, class-shifted, IoU 0.75"),
    "fused_dual_attention_d32": ("fused_dual_attention",
                                 "TSCD-Base: B 1, h 4, q 50, k 1600, d 32, fp32"),
    "fused_dual_attention_bf16_d32": ("fused_dual_attention_bf16",
                                      "TSCD-Base: B 1, h 4, q 50, k 1600, d 32, bf16 q/k/v"),
    "focus_stem_c32": ("focus_stem", "TSCD-Base: 32 x 576 x 576 fp32 frames -> 32 channels"),
    "focus_stem_bf16_c32": ("focus_stem_bf16",
                            "TSCD-Base: 32 x 576 x 576 uint8 frames -> 32 channels, bf16"),
}
# the eval windows each heads part streams after its warm-up
HEAD_WINDOWS = 3
TURNS = 5                    # windows of a branch and of the dense default, in turns
FEATURE_TOL = {"cls": (1e-4, 1e-5), "reg": (1e-4, 1e-5), "edge": (1e-3, 1e-5)}   # rtol, atol


def exp_with(exp, **knobs):
    for k, v in knobs.items():
        setattr(exp, k, v)
    return exp


def seeded_head_bn_(torch, model, seed):
    """The BatchNorm shifts and running means of `model`'s head (of
    `model` itself where it has none) drawn N(0.1, 0.3) from `seed` (on
    the CPU, then copied): conv(0) != 0, so the patch path's zeroing
    outside the map matters."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in getattr(model, "head", model).modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t in (m.bias, m.running_mean):
                    t.copy_(0.1 + 0.3 * torch.randn(t.shape, generator=gen))
    return model


def device_window(torch, exp, seed, w=0):
    """A seeded eval window of `exp` on the card: uint8 frames and the
    time embedding of frames w .. w + F - 1."""
    import numpy as np

    from tscd_torch.ops.position import get_timing_signal_1d
    rng = np.random.default_rng(seed)
    F = exp.lframe_val + exp.gframe_val
    x = torch.as_tensor(rng.integers(0, 256, (F, *exp.test_size, 3), dtype=np.uint8),
                        device=card(torch))
    return x, torch.as_tensor(get_timing_signal_1d(np.arange(w, w + F)), device=card(torch))


def warm_predict(torch, model, exp):
    """`model`'s predict function (the exp's) and the state after its first
    window (eager, then the window's graph captured)."""
    pred = exp.get_predict_fn(model)
    _, _, state = run_windows(torch, pred, exp, 1, 100, True, uint8=True)
    torch.cuda.synchronize()
    return pred, state


def replays(torch, counters, pred, exp, state, bf16, nms=2, n=HEAD_WINDOWS, want=None):
    """`n` streamed windows as graph replays under torch.profiler
    (`traced_path`: each window's hand kernels in the trace, `want` where
    given, none counted by a wrapper): window ms (CUDA events), launches,
    the device kernels and device ms a window, detections (finite, 7
    columns). Returns the record and the carried state."""
    import numpy as np
    from torch.autograd import DeviceType
    (dets, lat, state), launches, prof = traced_path(
        torch, counters, lambda: run_windows(torch, pred, exp, n, 60, True, state, 1, uint8=True),
        n, exp.lframe_val, bf16, nms, attempts=3, want=want)
    work = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation and e.key != "Activity Buffer Request"
            and "Memcpy" not in e.key and LEAD_IN not in e.key]
    n_det = 0
    for d in dets:
        for r in pred.materialize(d):
            if r.ndim != 2 or r.shape[1] != 7 or not np.isfinite(r).all():
                raise AssertionError(f"bad detections {r.shape}")
            n_det += len(r)
    if n_det == 0:
        raise AssertionError("no detections")
    table = sorted(({"name": e.key[:90], "ms": e.self_device_time_total / 1e3 / n,
                     "calls": e.count / n} for e in work), key=lambda r: -r["ms"])
    return {"window_ms": lat, "launches": launches, "traces": traced_path.attempts,
            "kernels_a_window": sum(e.count for e in work) / n,
            "device_ms_a_window": sum(e.self_device_time_total for e in work) / 1e3 / n,
            "by_class_ms": breakdown(table), "top": table[:12], "detections": n_det}, state


def graph_loop(torch, pred, exp, state, n=10):
    """`n` streamed windows back to back as graph replays, frames on the
    card: frames/s as bench.py:307 counts (F x windows / s), evaluated
    local frames/s, window ms, the device's busy share."""
    wins = [device_window(torch, exp, 80 + w, w) for w in range(n)]
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for (x, te), (a, b) in zip(wins, evs):
        a.record()
        _, state = pred.dispatch(x, te, True, state)
        b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = [a.elapsed_time(b) for a, b in evs]
    F = exp.lframe_val + exp.gframe_val
    return {"windows": n, "wall_s": wall, "frames_per_s": F * n / wall,
            "evaluated_frames_per_s": exp.lframe_val * n / wall, "window_ms": spans,
            "device_busy_share": sum(spans) / 1e3 / wall}


def stem_maps(torch, model, x):
    """The head's stem outputs of window x, a map a level."""
    with torch.no_grad():
        return [model.head.stems[k](f) for k, f in enumerate(model.backbone(x, None))]


def tower_features(torch, head, stems, idx, lframe, sparse):
    """The video-tower and edge features (cls, reg, edge) of `head` at
    anchors `idx`, from the stem maps `stems`, on the patches or on the
    dense maps."""
    with torch.no_grad():
        return head.vid_features(stems, None, idx, lframe, None, sparse)


def fp64_features(torch, head, stems, idx, lframe):
    """The dense path's features with every conv in fp64 (BatchNorm
    still rounds its output to fp32, as `blocks.batch_norm` runs it):
    elementwise within a few fp32 ulps of the exact values, where cuDNN's
    fp32 FFT convs on the maps err by about 1e-6 of a map's largest
    value."""
    import copy
    ref = copy.deepcopy(head)
    for m in ref.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.double()
    return tower_features(torch, ref, [s.double() for s in stems], idx, lframe, False)


def feature_excess(torch, got, want, part):
    """max of |got - want| - (atol + rtol |want|) with FEATURE_TOL[part]
    (<= 0 within the tolerance), and max |got - want|."""
    rtol, atol = FEATURE_TOL[part]
    d = (got.double() - want.double()).abs()
    return float((d - (atol + rtol * want.double().abs())).max()), float(d.max())


def against(torch, baseline, pred, state, exp, rounds=TURNS):
    """`pred`'s windows (from `state`) and the dense default's
    (`baseline`: its predict function and state) in turns (dense, branch,
    dense, ...) on the same seeded frames, `rounds` of each, every one a
    graph replay timed with CUDA events: each's window ms and median, and
    the ratio of the medians."""
    import numpy as np
    x, te = device_window(torch, exp, 70, 1)
    runs = {"dense": list(baseline), "branch": [pred, state]}
    times = {k: [] for k in runs}
    for _ in range(rounds):
        for name, run in runs.items():
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            _, run[1] = run[0].dispatch(x, te, True, run[1])
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b))
    med = {k: float(np.median(v)) for k, v in times.items()}
    return {"alternating_window_ms": times, "median_ms": med,
            "branch_over_dense": med["branch"] / med["dense"]}


def free_card(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def sparse_part(torch, counters):
    """(a) The proposal-patch towers at TSCD-Large (1 + 31 frames, 576 px),
    dense and sparse on the same seeded weights (the head's BN shifted off
    0): fp32 (TF32 off) vid features at the model's proposals within JAX's
    tolerance (FEATURE_TOL) of the dense path computed with fp64 convs
    (`fp64_features`; the fp32 dense maps' own distance from it, and the
    sparse features' from them, beside), detections of a fresh window
    equal as sets within 1e-4; bf16 with BN folded, the sparse
    features within BF16_SPREAD x the dense bf16 features' distance from
    fp32 at the same anchors; at each dtype the windows of both in turns
    as graph replays, then traced (launches, kernels a window). Returns
    the fp32 weights."""
    from tscd_torch.models.tscd import random_init_
    exp = large_exp()
    L, G = exp.lframe_val, exp.gframe_val
    dense = seeded_head_bn_(torch, random_init_(exp.get_model(device=card(torch)), exp.seed), 61)
    sd32 = dense.state_dict()
    sparse = exp_with(large_exp(), sparse_vid_towers=True).get_model(device=card(torch))
    sparse.load_state_dict(sd32)
    x, te = device_window(torch, exp, 62)
    with torch.no_grad():
        idx = dense(x, te, L, G)["proposals"].idx
    stems = stem_maps(torch, dense, x)
    fd = tower_features(torch, dense.head, stems, idx, L, False)
    fs = tower_features(torch, dense.head, stems, idx, L, True)
    f64 = fp64_features(torch, dense.head, stems, idx, L)
    feats = {}
    for part, s, d, r in zip(FEATURE_TOL, fs, fd, f64):
        feats[part] = {"abs_max": float(r.abs().max())}
        for pair, a, b in (("sparse_vs_fp64", s, r), ("dense_vs_fp64", d, r),
                           ("sparse_vs_dense", s, d)):
            excess, err = feature_excess(torch, a, b, part)
            feats[part][pair] = {"max_abs_err": err, "excess_over_tol": excess}
    ok = all(f["sparse_vs_fp64"]["excess_over_tol"] <= 0 for f in feats.values())
    emit({"phase": "heads", "part": "sparse", "check": "fp32 vid features: sparse against "
          "the dense path with fp64 convs", "features": feats,
          "tolerance": {k: {"rtol": r, "atol": a} for k, (r, a) in FEATURE_TOL.items()},
          "pass": ok})
    if not ok:
        raise AssertionError(f"sparse towers: fp32 features {feats}")
    del fd, fs, f64
    sparse_windows(torch, counters, exp, dense, sparse, "fp32")
    d16 = bf16_model(torch, large_exp(), sd32, card(torch))
    s16 = bf16_model(torch, exp_with(large_exp(), sparse_vid_towers=True), sd32, card(torch))
    with torch.no_grad():
        idx16 = d16(x, te, L, G)["proposals"].idx
    f32 = tower_features(torch, dense.head, stems, idx16, L, False)
    stems16 = stem_maps(torch, d16, x)
    f16d = tower_features(torch, d16.head, stems16, idx16, L, False)
    f16s = tower_features(torch, d16.head, stems16, idx16, L, True)
    feats16 = {}
    for part, a, b, c in zip(FEATURE_TOL, f16s, f16d, f32):
        a, b, c = (t.float().cpu().numpy() for t in (a, b, c))
        feats16[part] = {"sparse_vs_dense": distance(a, b), "dense_vs_fp32": distance(b, c)}
    ok = all(0 < v["dense_vs_fp32"][k] and v["sparse_vs_dense"][k]
             <= BF16_SPREAD * v["dense_vs_fp32"][k]
             for v in feats16.values() for k in ("max", "p999"))
    emit({"phase": "heads", "part": "sparse", "check": "bf16 vid features, sparse vs "
          "dense, at the bf16 model's proposals", "features": feats16,
          "tolerance": f"sparse_vs_dense <= {BF16_SPREAD} x dense_vs_fp32 (max, p99.9)",
          "pass": ok})
    if not ok:
        raise AssertionError(f"sparse towers: bf16 features {feats16}")
    del dense, sparse, stems, stems16, f32, f16d, f16s
    free_card(torch)
    sparse_windows(torch, counters, exp, d16, s16, "bf16")
    return sd32


def sparse_windows(torch, counters, exp, dense, sparse, dtype):
    """The dense and the sparse model's windows in turns (`against`), then
    each's traced replays; at fp32 first one fresh window's detections of
    both, equal as sets within 1e-4."""
    (pd, sd), (ps, ss) = warm_predict(torch, dense, exp), warm_predict(torch, sparse, exp)
    rec = {}
    if dtype == "fp32":
        xw, tw = device_window(torch, exp, 63)
        rows = [[p.materialize(p.dispatch(xw, tw, False, None)[0])] for p in (pd, ps)]
        worst, n = match_rows(*rows, 1e-4, 1e-4)
        rec["detections_sparse_vs_dense"] = {"max_abs_err": worst, "rows": n,
                                             "tolerance": "sets, atol = rtol = 1e-4"}
    rec.update(against(torch, (pd, sd), ps, ss, exp))
    rec["dense"], _ = replays(torch, counters, pd, exp, sd, dtype == "bf16")
    rec["sparse"], _ = replays(torch, counters, ps, exp, ss, dtype == "bf16")
    emit({"phase": "heads", "part": "sparse", "config": f"TSCD-Large 1+31 frames 576px "
          f"P=50, {dtype}{', BN folded' if dtype == 'bf16' else ''}; branch: sparse towers",
          **rec, "pass": True})
    del pd, ps
    free_card(torch)


def pre_nms_part(torch, counters, sd32, baseline, lat, clock):
    """(b) use_pre_nms on TSCD-Large at fp32: an eager window's NMS calls
    (the pre-NMS at (32, 750) and the postprocess's two), its windows and
    the dense default's (`baseline`, the same weights) in turns, then
    traced graph replays (3 NMS calls a window). Returns the (32, 750)
    call's kernels-line row."""
    from tscd_torch.ops import nms
    from tscd_torch.ops.kernels import nms as kn
    exp = exp_with(large_exp(), use_pre_nms=True)
    model = exp.get_model(device=card(torch))
    model.load_state_dict(sd32)
    pred, state = warm_predict(torch, model, exp)
    calls = []
    state = capture_window(torch, pred, exp, state, {(nms, "nms_sorted"): calls})
    shapes = [tuple(c[0].shape[:2]) for c in calls]
    F = exp.lframe_val + exp.gframe_val
    H, W = exp.test_size
    K = min(750, sum((H // st) * (W // st) for st in model.head.strides))
    if shapes.count((F, K)) != 1 or len(shapes) != 3:
        raise AssertionError(f"NMS calls of a pre-NMS window {shapes}: one ({F}, {K}) and "
                             "the postprocess's two expected")
    times = against(torch, baseline, pred, state, exp)
    rec, state = replays(torch, counters, pred, exp, state, False, nms=3)
    emit({"phase": "heads", "part": "use_pre_nms", **times, "config": "TSCD-Large 1+31 frames 576px "
          "P=50, fp32, use_pre_nms (top 750 by obj, class-aware NMS at 0.75)",
          "nms_calls_a_window": shapes, **rec, "pass": True})
    boxes_s, valid_s, thr = next(c for c in calls if tuple(c[0].shape[:2]) == (F, K))
    err, _ = check_nms(torch, f"pre-NMS window's call ({F}, {K})", boxes_s, valid_s, thr)
    row = dict(max_abs_err=err,
               **timed(torch, lambda: kn.nms_sorted(boxes_s, valid_s, thr), 100, "nms_"),
               plain_ms=cuda_ms(torch, lambda: kn.nms_sorted_plain(boxes_s, valid_s, thr), 3, 1),
               **nms_bounds(F, K, lat, clock), bound_by="operations",
               bound_model=NMS_BOUND, library_ms=None,
               kept=int(kn.nms_sorted(boxes_s, valid_s, thr).sum()),
               valid=int(valid_s.sum()))
    # the trace's NMS walks beyond the postprocess's two a window
    row["launches"] = rec["launches"]["nms"] - 2 * HEAD_WINDOWS
    del pred, model
    free_card(torch)
    return row


def aware_part(torch, counters, baseline):
    """(c) agg_type mca_aware on TSCD-Large at fp32 (its own seeded
    weights: the aggregators' tree differs): its windows and the dense
    default's (`baseline`) in turns, then traced graph replays, the
    attention and the solver in each."""
    from tscd_torch.models.tscd import random_init_
    exp = exp_with(large_exp(), agg_type="mca_aware")
    model = seeded_head_bn_(torch, random_init_(exp.get_model(device=card(torch)), exp.seed), 61)
    pred, state = warm_predict(torch, model, exp)
    times = against(torch, baseline, pred, state, exp)
    rec, _ = replays(torch, counters, pred, exp, state, False)
    emit({"phase": "heads", "part": "mca_aware", **times, "config": "TSCD-Large 1+31 frames 576px P=50, "
          "fp32, agg_type mca_aware (edge features of every frame)", **rec, "pass": True})
    del pred, model
    free_card(torch)


def base_part(torch, counters):
    """(d) TSCD-Base (exps/TSCD_VID/vid_tscd_base.py: depth 0.33, width 0.5,
    1 + 31 frames at 576 px, seeded weights): fp32 and bf16 (BN folded)
    windows traced as graph replays, 10 back to back (frames/s); one fp32
    stage-2 step of 4 + 12 frames (fix_bn, frozen backbone), timed after
    one. Returns the launches of the TSCD-Base rows."""
    import numpy as np

    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.step import init_train_state, train_step
    exp = base_exp()
    m32 = random_init_(exp.get_model(device=card(torch)), exp.seed)
    launches = {}
    for dtype in ("fp32", "bf16"):
        model = m32 if dtype == "fp32" else bf16_model(torch, exp, m32.state_dict(), card(torch))
        pred, state = warm_predict(torch, model, exp)
        rec, state = replays(torch, counters, pred, exp, state, dtype == "bf16")
        loop = graph_loop(torch, pred, exp, state)
        emit({"phase": "heads", "part": "tscd_base", "config": f"TSCD-Base 1+31 frames 576px "
              f"P=50, {dtype}{', BN folded' if dtype == 'bf16' else ''}", **rec, "loop": loop,
              "pass": True})
        sfx = "_bf16" if dtype == "bf16" else ""
        launches[f"focus_stem{sfx}_c32"] = rec["launches"][f"focus_stem{sfx}"]
        launches[f"fused_dual_attention{sfx}_d32"] = rec["launches"][f"fused_dual_attention{sfx}"]
        del pred
    del model
    free_card(torch)
    opt = exp.get_optimizer(m32, 8)
    st = init_train_state(m32, opt, exp.ema_decay)
    window = tuple(t.to(card(torch)) for t in train_window(torch, exp, 64))
    losses = []
    ms, wall, peak = timed_steps(torch, lambda: losses.append(train_step(
        st, *window, exp.lframe, exp.gframe, ota_mode=exp.ota_mode, fix_bn=exp.fix_bn)), 3, 1)
    host = [{k: float(v) for k, v in lo.items()} for lo in losses]
    ok = all(np.isfinite(v) for lo in host for v in lo.values()) and opt.lr() > 0
    emit({"phase": "heads", "part": "tscd_base", "config": "TSCD-Base stage 2, 4+12 frames "
          "576px, fp32, fix_bn, frozen backbone", "step_ms": ms, "median_ms": float(np.median(ms)),
          "frames_per_s": 3 * (exp.lframe + exp.gframe) / wall, "peak_mem_gb": peak,
          "losses": host[-1], "pass": ok})
    if not ok:
        raise AssertionError(f"TSCD-Base step: losses {host}")
    del m32, st, opt
    free_card(torch)
    return launches


def cat_ota_fg_part(torch):
    """(e) cat_ota_fg on a TSCD-Large fp32 stage-2 step (4 + 12 frames,
    576 px, seeded weights and window): step ms after one, finite losses,
    SimOTA run once a step, in the head (the loss reuses it)."""
    import numpy as np

    from tscd_torch.models import tscd_head
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train import losses as loss_mod
    from tscd_torch.train.step import init_train_state, train_step
    exp = exp_with(large_exp(), cat_ota_fg=True)
    model = random_init_(exp.get_model(device=card(torch)), exp.seed)
    opt = exp.get_optimizer(model, 8)
    opt.count = 8                        # past the warm-up's first updates
    st = init_train_state(model, opt, exp.ema_decay)
    window = tuple(t.to(card(torch)) for t in train_window(torch, exp, 65))
    calls = {"head": 0, "loss": 0}

    def counted(mod, name, key):
        fn = getattr(mod, name)

        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        setattr(mod, name, call)
        return fn

    kept = [(tscd_head, counted(tscd_head, "simota_assign", "head")),
            (loss_mod, counted(loss_mod, "simota_assign", "loss"))]
    losses = []
    try:
        ms, wall, peak = timed_steps(torch, lambda: losses.append(train_step(
            st, *window, exp.lframe, exp.gframe, ota_mode=exp.ota_mode, fix_bn=exp.fix_bn)), 3, 1)
    finally:
        for mod, fn in kept:
            mod.simota_assign = fn
    host = [{k: float(v) for k, v in lo.items()} for lo in losses]
    ok = (calls == {"head": len(losses), "loss": 0}
          and all(np.isfinite(v) for lo in host for v in lo.values()))
    emit({"phase": "heads", "part": "cat_ota_fg", "config": "TSCD-Large stage 2, 4+12 frames "
          "576px, fp32, cat_ota_fg", "step_ms": ms, "median_ms": float(np.median(ms)),
          "peak_mem_gb": peak, "simota_calls": calls, "steps": len(losses),
          "losses": host[-1], "pass": ok})
    if not ok:
        raise AssertionError(f"cat_ota_fg step: SimOTA calls {calls}, losses {host}")
    del model, st, opt
    free_card(torch)


# (f): knobs of JAX's TSCD, through the exp; knobs its TSCD does not pass,
# through TSCDHead as JAX's head takes them
SMALL_MODEL_BRANCHES = {"sparse_vid_towers": {"sparse_vid_towers": True},
                        "use_pre_nms": {"use_pre_nms": True},
                        "mca_aware": {"agg_type": "mca_aware"},
                        "reconf_off": {"reconf": False},
                        "decouple_reg_off": {"decouple_reg": False},
                        "act_relu": {"act": "relu"}}
SMALL_HEAD_BRANCHES = {"ave_off": {"ave": False}, "use_mask": {"use_mask": True},
                       "vid_cls_off": {"vid_cls": False}, "vid_reg_off": {"vid_reg": False}}


def close_record(got, want, tol=1e-4):
    """max |got - want| (host tensors) and whether within tol relative
    (atol tol x the largest |want|, at least tol)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err <= tol * max(1.0, float(want.abs().max()))


def small_branches_part(torch):
    """(f) Every branch at the selftest size (width 0.125, P = 6, 1 + 3
    frames, 128 px; the head's BN shifted off 0): the card against the
    port on the card machine's CPU, fp32. Model knobs: 2 streamed windows
    (the card's second a graph replay), detections as sets, 1e-4. Head
    knobs: TSCDHead on seeded FPN features, every output 1e-4. The Focus
    stem at ksize 5 and act relu (JAX's XLA route), 1e-4. A cat_ota_fg
    stage-2 step at `step_agreement`'s bounds. Detection boxes are compared
    in units of the frame's side (a corner near 0 is a difference of
    coordinates of the frame's scale)."""
    import copy

    import numpy as np

    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp.tscd_large import selftest_exp
    from tscd_torch.models.blocks import Focus
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.models.tscd_head import TSCDHead
    res, failed = {}, {}
    x0, te0 = device_window(torch, selftest_exp(), 1)
    scale = np.array([1 / max(selftest_exp().test_size)] * 4 + [1, 1, 1], np.float32)
    for name, knobs in SMALL_MODEL_BRANCHES.items():
        exp = exp_with(selftest_exp(), **knobs)
        rows, first = {}, {}
        for dev in ("cpu", card(torch)):
            model = seeded_head_bn_(torch, random_init_(exp.get_model(device=dev), exp.seed), 66)
            with torch.no_grad():
                out = model(x0.to(dev), te0.to(dev), exp.lframe_val, exp.gframe_val)
            first[dev] = (out["raw_outputs"].cpu(), out["proposals"].idx.cpu(),
                          out["refined_cls_logits"].cpu())
            pred = make_predict_fn(model, exp.lframe_val, exp.gframe_val, exp.nmsthre,
                                   exp.test_conf)
            dets, _, _ = run_windows(torch, pred, exp, 2, 1, False)
            # boxes in units of the frame's side: 1e-4 of the coordinates'
            # scale, where a corner near 0 cancels larger terms
            rows[dev] = [[r * scale for r in pred.materialize(d)] for d in dets]
        (rc, ic, cc), (rg, ig, cg) = first["cpu"], first[card(torch)]
        res[name] = {"raw_outputs_max_abs_err": float((rc - rg).abs().max()),
                     "proposals_equal": bool(torch.equal(ic, ig)),
                     "refined_cls_max_abs_err": float((cc - cg).abs().max())}
        try:
            res[name]["max_abs_err"], res[name]["detections"] = match_rows(
                rows["cpu"], rows[card(torch)], 1e-4, 1e-4)
        except AssertionError as e:
            failed[name] = str(e)
    rng = np.random.default_rng(67)
    xs = [torch.as_tensor(rng.normal(size=(4, c, s, s)).astype(np.float32))
          for c, s in ((32, 16), (64, 8), (128, 4))]
    te = torch.as_tensor(rng.normal(size=(4, 256)).astype(np.float32))
    for name, knobs in SMALL_HEAD_BRANCHES.items():
        cpu = seeded_head_bn_(torch, random_init_(TSCDHead(30, width=0.125, num_proposals=6,
                                                           **knobs), 68), 69).eval()
        dev = copy.deepcopy(cpu).to(card(torch))
        with torch.no_grad():
            want = cpu(xs, te, 1)
            got = dev([x.to(card(torch)) for x in xs], te.to(card(torch)), 1)
        if not torch.equal(got["proposals"].idx.cpu(), want["proposals"].idx):
            raise AssertionError(f"{name}: the card's proposals differ from the CPU's")
        errs = {k: close_record(got[k].cpu(), want[k])
                for k in ("raw_outputs", "refined_cls_logits", "matcher_obj_logits",
                          "refined_boxes")}
        res[name] = {k: e for k, (e, _) in errs.items()}
        if not all(ok for _, ok in errs.values()):
            raise AssertionError(f"{name}: card against CPU {errs}")
    x = torch.as_tensor(rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32))
    for name, kw in (("focus_ksize5", {"ksize": 5}), ("focus_relu", {"act": "relu"})):
        cpu = seeded_head_bn_(torch, random_init_(Focus(3, 16, **kw), 70), 71).eval()
        dev = copy.deepcopy(cpu).to(card(torch))
        with torch.no_grad():
            err, ok = close_record(dev(x.to(card(torch))).cpu(), cpu(x))
        res[name] = {"max_abs_err": err}
        if not ok or cpu.kernel:
            raise AssertionError(f"{name}: card against CPU {err}")
    exp = exp_with(selftest_exp(), cat_ota_fg=True)
    window = boxes_near_proposals(torch, exp, train_window(torch, exp, 41), 42)
    step = step_agreement(torch, exp, window, 4, 4 * exp.warmup_epochs + 1)
    res["cat_ota_fg_step"] = step
    ok = step["pass"] and not failed
    emit({"phase": "heads", "part": "small", "config": "selftest, card against the card "
          "machine's CPU, fp32", "branches": res, "failed": failed,
          "tolerance": "1e-4 (detections as sets, boxes in units of the frame's side); "
                       "the step at train_small's bounds",
          "pass": ok})
    if not ok:
        raise AssertionError(f"selftest branches, card against CPU: {list(failed)}"
                             f"{'' if step['pass'] else ' and the cat_ota_fg step'} depart")


def head_kernel_rows(torch, dev):
    """The hand kernels at TSCD-Base's shapes against their plain
    versions, then timed, with their bounds: the attention at head dim 32
    (B 1, h 4, q 50, k 1600; fp32 and bf16 q/k/v; random inputs with 20%
    invalid keys and the aggregation's strided views, 1e-5 as at d 64),
    the stem writing 32 channels (fp32 frames -> fp32, 1e-4 relative;
    uint8 -> bf16, BF16_TOL), checked on 4 frames and timed on 32."""
    import numpy as np
    import torch.nn.functional as F

    from tscd_torch.models.aggregation import DualBranchAttention, _split_heads
    from tscd_torch.ops.kernels import focus_stem as fs
    from tscd_torch.ops.kernels import fused_attention as fa
    rng = np.random.default_rng(50)
    bf = torch.bfloat16
    t = lambda a, dt=torch.float32: torch.as_tensor(a, device=dev).to(dt)   # noqa: E731
    rows = {}
    B, h, q, k, d = 1, 4, 50, 1600, 32
    for name, dt in (("fused_dual_attention_d32", torch.float32),
                     ("fused_dual_attention_bf16_d32", bf)):
        qc, qr = (t(rng.normal(size=(B, h, q, d)), dt) for _ in range(2))
        kc, vc, kr, vr = (t(rng.normal(size=(B, h, k, d)), dt) for _ in range(4))
        score = t(rng.uniform(0, 1, (B, k)))
        valid = t(rng.uniform(size=(B, k)) > 0.2, torch.bool)
        torch.manual_seed(0)
        att = DualBranchAttention(h * d, h, dtype=dt).to(dev)
        x_cls, x_reg = (t(rng.normal(size=(B, k, h * d)), dt) for _ in range(2))
        with torch.no_grad():
            k_cls, v_cls = att.kv_cls(x_cls).chunk(2, -1)
            k_reg, v_reg = att.kv_reg(x_reg).chunk(2, -1)
            main = (_split_heads(att.q_cls_local(x_cls[:, :q]), h), _split_heads(k_cls, h),
                    _split_heads(v_cls, h), _split_heads(att.q_reg_local(x_reg[:, :q]), h),
                    _split_heads(k_reg, h), _split_heads(v_reg, h), score, valid)
        errs = []
        for case, a in (("20% invalid keys", (qc, kc, vc, qr, kr, vr, score, valid)),
                        ("main-path layout", main)):
            got, want = fa.fused_dual_attention(*a), fa.fused_dual_attention_plain(*a)
            for part, g, w in zip(("out_cls", "out_reg", "attn"), got, want):
                errs.append(check_close(f"{name} {case} {part}", g, w, atol=1e-5, rtol=1e-4))
        size = 2 if dt == bf else 4
        nbytes = size * (2 * B * h * q * d + 4 * B * h * k * d) + 4 * B * k + B * k \
            + 4 * (2 * B * h * q * d + B * h * q * k)
        half = B * h * 2 * 2 * q * k * d          # the logits, or attn @ V
        b_ms, b_by = bound(nbytes, (half, H100_BF16_FLOPS if dt == bf else H100_FP32_FLOPS),
                           (half, H100_FP32_FLOPS))
        rows[name] = dict(
            max_abs_err=max(errs),
            **timed(torch, lambda: fa.fused_dual_attention(*main), 200, "fused_dual_attention"),
            plain_ms=cuda_ms(torch, lambda: fa.fused_dual_attention_plain(*main), 50),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    O, Fr, H, W = 32, 32, 576, 576
    w3 = t(rng.normal(0, 1 / np.sqrt(108), (O, 12, 3, 3)))
    scale = t(rng.uniform(0.5, 1.5, O))
    shift = t(rng.normal(0, 0.5, O))
    x8 = t(rng.integers(0, 256, (Fr, H, W, 3), dtype=np.uint8), torch.uint8)
    x32 = x8.float()
    flops = 2 * Fr * (H // 2) * (W // 2) * O * 108
    w6 = fs.rearrange_weight(w3, scale)
    for name, x, out, tol, size, rate in (
            ("focus_stem_c32", x32, torch.float32, {"atol": 1e-3, "rtol": 1e-4}, 4,
             H100_FP32_FLOPS),
            ("focus_stem_bf16_c32", x8, bf, BF16_TOL, 1, H100_BF16_FLOPS)):
        got = fs.focus_stem(x[:4], w3, scale, shift, out_dtype=out)
        want = fs.focus_stem_plain(x[:4], w3, scale, shift, out)
        err = check_close(f"{name} (4, {H}, {W}, 3) -> {O}", got, want, **tol)
        del got, want
        nbytes = size * Fr * H * W * 3 + (4 if out == torch.float32 else 2) * Fr * (
            H // 2) * (W // 2) * O + 4 * (w3.numel() + 2 * O)
        b_ms, b_by = bound(nbytes, (flops, rate))
        xn = x.to(out).permute(0, 3, 1, 2)      # channels_last view
        wl, sl = w6.to(out), shift.to(out)
        rows[name] = dict(
            max_abs_err=err,
            **timed(torch, lambda: fs.focus_stem(x, w3, scale, shift, out_dtype=out), 20,
                    "focus_stem"),
            plain_ms=cuda_ms(torch, lambda: fs.focus_stem_plain(x, w3, scale, shift, out), 10),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(torch, lambda: F.conv2d(xn, wl, sl, stride=2, padding=2), 20))
        del xn
    emit({"phase": "kernels", "heads": {n: {k: v for k, v in r.items() if "ms" in k}
                                        for n, r in rows.items()}})
    return rows


def heads_phase(torch, counters):
    """The TSCD head's other branches and TSCD-Base on the card: (a) the
    proposal-patch towers against the dense ones at TSCD-Large, fp32 and
    bf16; (b) use_pre_nms; (c) mca_aware; (d) TSCD-Base windows and a
    step; (e) a cat_ota_fg step; (f) every branch at the selftest size,
    card against CPU. Returns {"launches": {row: n}, "nms_prenms": row}
    for the kernels line."""
    from tscd_torch.ops.kernels import library
    t0 = time.time()
    lat, clock = latencies(torch, library.load()), sm_clock_mhz()
    sd32 = sparse_part(torch, counters)
    dense = large_exp().get_model(device=card(torch))
    dense.load_state_dict(sd32)
    baseline = warm_predict(torch, dense, large_exp())
    nms_row = pre_nms_part(torch, counters, sd32, baseline, lat, clock)
    aware_part(torch, counters, baseline)
    del sd32, dense, baseline
    free_card(torch)
    launches = base_part(torch, counters)
    launches["nms_prenms"] = nms_row.pop("launches")
    cat_ota_fg_part(torch)
    small_branches_part(torch)
    emit({"phase": "heads", "seconds": time.time() - t0})
    return {"launches": launches, "nms_prenms": nms_row}


def nms_stage_main(torch):
    """`--nms-stage`: the NMS stage alone (`nms_stage_rows`) on the
    batched_class_aware_nms arguments of one streamed window of
    TSCD-Large at fp32 (seeded weights and frames, after a warm-up
    window), and nothing else. It reaches the port only through entry
    points older trees have too, so that a copy of this script times
    another commit's stage the same way."""
    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp.tscd_large import Exp
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops import postprocess
    exp = Exp()
    model = random_init_(exp.get_model(), exp.seed)
    pred = make_predict_fn(model, exp.lframe_val, exp.gframe_val, exp.nmsthre, exp.test_conf)
    _, _, state = run_windows(torch, pred, exp, 1, 100, True)
    stage = []
    capture_window(torch, pred, exp, state, {(postprocess, "batched_class_aware_nms"): stage})
    if len(stage) != 2:
        raise AssertionError(f"{len(stage)} NMS calls in a window, 2 expected")
    emit({"phase": "nms_stage", "tree": HERE, "stage_alone": nms_stage_rows(torch, stage, 50),
          "valid": [int(a[3].sum()) for a in stage]})


# -- phases still and ovis: the OVIS recipe, stage 1 (still-image YOLOX) and
# stage 2 (TSCD on OVIS-format video) ---------------------------------------

OVIS_FIXTURE = os.path.join(FILE_FIXTURE, "ovis")
STILL_CONFIG = ("ovis_yolox_l: YOLOX-L (depth 1.0, width 1.0), 25 classes, batches of 16 at "
                "640 px (mosaic, mixup, affine warp, HSV, flip), eval batches of 8 at 576 px, "
                "fp32")
OVIS_CONFIG = ("ovis_tscd_large: TSCD-Large (depth 1.0, width 1.0), 25 classes, P=50, eval "
               "windows of 8 + 24 frames at 576 px, training windows of 4 + 12, fp32")
STILL_STEPS = 8            # 4 epochs of the fixture's 32 frames in batches of 16
STILL_EXP = "ovis_yolox_l"
# where `still` leaves the stage-1 checkpoint that `ovis` starts stage 2 from
STAGE1_DIR = os.path.join("build", "still_phase")
# rows of the kernels line at these phases' shapes: {row: (its kernel's row, the shape)}
RECIPE_ROWS = {
    "focus_stem_yolox_576": ("focus_stem",
                             "ovis_yolox_l eval batch: 8 x 576 x 576 fp32 frames -> 64 channels"),
    "focus_stem_yolox_640": ("focus_stem",
                             "yolox_l eval batch: 8 x 640 x 640 fp32 frames -> 64 channels"),
    "nms_dense_065": ("nms", "postprocess_dense: B 8, K 2048, 25 classes shifted, IoU 0.65 "
                             "(ovis_yolox_l, yolox_l)"),
    "nms_dense_05": ("nms", "postprocess_dense: B 8, K 2048, 25 classes shifted, IoU 0.5 "
                            "(yoloxl_ovis, 640 x 960)"),
    "fused_dual_attention_ovis": ("fused_dual_attention",
                                  "ovis_tscd_large window: B 8, h 4, q 50, k 1600, d 64, fp32"),
    "hungarian_ovis": ("hungarian", "ovis_tscd_large window: each local frame's 50 x 50 "
                                    "carried-state cost, 8 a window"),
    "nms_ovis": ("nms", "ovis_tscd_large postprocess_refined: 8 frames x K = 1250 (50 "
                        "proposals x 25 classes, shifted), IoU 0.5"),
}


def warp_canvas(img, offset):
    """The frame letterboxed to 640 px on a 1280 x 1280 canvas of 114 at
    `offset` (y, x), as the mosaic places a tile (the canvas the fixture's
    recorded warps start from, tests/torch_port_ovis_fixture.py)."""
    import numpy as np

    from tscd_torch.data import image
    h, w = img.shape[:2]
    r = min(640 / h, 640 / w)
    tile = image.resize_linear(img, int(h * r), int(w * r))
    canvas = np.full((1280, 1280, 3), 114, np.uint8)
    y, x = offset
    canvas[y:y + tile.shape[0], x:x + tile.shape[1]] = tile
    return canvas


def warp_checks():
    """The port's warp (data/image.py:warp_affine) of each fixture frame's
    mosaic canvas by its recorded matrix, against the sha256 of
    cv2.warpAffine's pixels recorded where cv2 exists
    (tscd_torch/data/fixtures/ovis/warp_sha256.json); and the host ms of
    one warp of a 1280 x 1280 canvas to 640 x 640."""
    import hashlib

    import numpy as np

    from tscd_torch.data import image
    with open(os.path.join(HERE, OVIS_FIXTURE, "warp_sha256.json")) as f:
        recorded = json.load(f)
    w, h = recorded["size"][1], recorded["size"][0]
    bad, canvases = [], []
    for rel, rec in recorded["frames"].items():
        canvas = warp_canvas(image.imread(os.path.join(HERE, rel)), rec["offset"])
        out = image.warp_affine(canvas, np.asarray(rec["matrix"]), (w, h), recorded["border"])
        if hashlib.sha256(out.tobytes()).hexdigest() != rec["sha256"]:
            bad.append(rel)
        canvases.append((canvas, np.asarray(rec["matrix"])))
    ms = host_ms(lambda c: image.warp_affine(c[0], c[1], (w, h), 114), canvases[:4], 3)
    return {"frames": len(recorded["frames"]), "sha256_match": len(recorded["frames"]) - len(bad),
            "mismatched": bad, "reference": f"cv2 {recorded['cv2']}",
            "host_ms_warp_1280_to_640": ms, "pass": not bad}


def call_grid(torch, fn, kernel, path, attempts=3):
    """The grid of the one `kernel` launch that `fn()` makes, from a
    torch.profiler trace of that call alone. A trace without it lost its
    record (PERF.md §7) and is taken again, `attempts` times in all."""
    for attempt in range(1, attempts + 1):
        with traced(torch) as prof:
            fn()
            torch.cuda.synchronize()
        grids = [k["grid"] for k in trace_kernels(trace_events(prof, path))
                 if kernel in k["name"]]
        if len(grids) == 1:
            return grids[0]
        emit({"phase": "trace", "call_grid": kernel, "launches": len(grids),
              "attempt": attempt})
        if grids or attempt == attempts:
            raise AssertionError(f"{len(grids)} {kernel} launches in the trace of one call "
                                 f"({attempt} traces)")


def trace_lead_in_phase(torch, counters, rounds=3):
    """Which kernel records torch.profiler traces lose (not in the default
    run). Three workloads, each traced `rounds` times in three ways, fresh
    each time: as it is, after `lead_in` (a small kernel, waited for), and
    with a small kernel after it, before the trace stops. The workloads:
    the block solver on a 129 x 129 random cost and the fp32 stem on 8 x
    640 x 640 frames, 20 calls each as `timed` makes them; and
    ovis_tscd_large's replayed evaluation of the fixture's val json (its
    window graph captured first). For each trace: each host launch's
    index where its kernel record is missing (`launch_records`), the
    launches of each row, and for the evaluation the replays that differ
    from the others (`odd_replays`)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops.kernels import focus_stem as fs
    from tscd_torch.ops.kernels import hungarian as hu
    quiet = lambda *a: None   # noqa: E731
    dev = card(torch)
    rng = np.random.default_rng(6)
    cost = torch.as_tensor(rng.uniform(0, 2, (1, 129, 129)).astype(np.float32), device=dev)
    w3 = torch.as_tensor(rng.normal(0, 0.1, (64, 12, 3, 3)), device=dev).float()
    scale, shift = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    x = torch.as_tensor(rng.integers(0, 256, (8, 640, 640, 3)), device=dev).float()
    exp = ovis_exp(OVIS_EXP)
    L = exp.lframe_val
    model = random_init_(exp.get_model(device=dev), exp.seed)
    pred = make_predict_fn(model, L, exp.gframe_val, exp.nmsthre, exp.test_conf)
    loader = exp.get_eval_loader(pin_memory=card(torch).type == "cuda")
    first = next(iter(loader))
    pred.materialize(pred.dispatch(first["imgs"], first["time_embedding"], False, None)[0])
    nw = len(loader.dataset.res)
    want = window_launches(nw, L, False)

    def calls(fn, n=20):
        def run():
            for _ in range(n):
                fn()
        return run

    def evaluate():
        exp.get_evaluator(exp.get_eval_loader(pin_memory=True)).evaluate(
            recording(pred, []), quiet)

    workloads = {"hungarian_block_129": calls(lambda: hu.linear_sum_assignment(cost)),
                 "focus_stem_640": calls(lambda: fs.focus_stem(x, w3, scale, shift,
                                                               out_dtype=torch.float32)),
                 "ovis_eval": evaluate}
    for run in workloads.values():
        run()
    torch.cuda.synchronize()
    path = os.path.join(HERE, "build", "trace_lead_in.json")
    summary = {}
    for r in range(rounds):
        for name, run in workloads.items():
            for way in ("plain", "lead_in", "lead_out"):
                for c in counters.values():
                    c.launches = 0
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    if way == "lead_in":
                        lead_in(torch)
                    run()
                    if way == "lead_out":
                        torch.ones(1, device="cuda").add_(1)
                    torch.cuda.synchronize()
                launches = trace_launches(prof)
                evs = trace_events(prof, path)
                seq = launch_records(evs)
                rec = {"round": r, "workload": name, "way": way, "launches": launches,
                       "host_launches": len(seq),
                       "lost_at": [i for i, (_, ks) in enumerate(seq) if not ks],
                       "wrapper_launches": {k: c.launches for k, c in counters.items()}}
                if name == "ovis_eval":
                    rec["complete"] = launches == want
                    rec["replays"], rec["odd_replays"] = odd_replays(trace_kernels(evs))
                summary.setdefault(f"{name} {way}", []).append(len(rec["lost_at"]))
                emit({"phase": "trace_lead_in", **rec})
    emit({"phase": "trace_lead_in", "lost_records_a_trace": summary, "rounds": rounds})


@contextlib.contextmanager
def keeping_calls(torch, targets):
    """Inside it, every call of each `targets` entry, (module, function
    name) -> list, keeps a copy of its arguments in that list."""
    def keeping(fn, kept):
        def call(*args, **kw):
            kept.append(tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a
                              for a in args))
            return fn(*args, **kw)
        return call

    with contextlib.ExitStack() as undo:
        for (module, name), kept in targets.items():
            fn = getattr(module, name)
            setattr(module, name, keeping(fn, kept))
            undo.callback(setattr, module, name, fn)
        yield


def stem_row(torch, dev, rng, F, H, W, O=64):
    """The fp32 stem on F x H x W x 3 frames writing O channels against its
    plain version (1e-4 relative, as phase kernels), then timed, with its
    bound and the folded F.conv2d's time."""
    import numpy as np
    import torch.nn.functional as Fn

    from tscd_torch.ops.kernels import focus_stem as fs
    t = lambda a, dt=torch.float32: torch.as_tensor(a, device=dev).to(dt)   # noqa: E731
    w3 = t(rng.normal(0, 1 / np.sqrt(108), (O, 12, 3, 3)))
    scale = t(rng.uniform(0.5, 1.5, O))
    shift = t(rng.normal(0, 0.5, O))
    x = t(rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8))
    err = check_close(f"focus_stem ({F}, {H}, {W}, 3) -> {O}",
                      fs.focus_stem(x, w3, scale, shift, out_dtype=torch.float32),
                      fs.focus_stem_plain(x, w3, scale, shift, torch.float32),
                      atol=1e-3, rtol=1e-4)
    nbytes = 4 * F * H * W * 3 + 4 * F * (H // 2) * (W // 2) * O + 4 * (w3.numel() + 2 * O)
    b_ms, b_by = bound(nbytes, (2 * F * (H // 2) * (W // 2) * O * 108, H100_FP32_FLOPS))
    xn, w6 = x.permute(0, 3, 1, 2), fs.rearrange_weight(w3, scale)
    return dict(max_abs_err=err,
                **timed(torch, lambda: fs.focus_stem(x, w3, scale, shift,
                                                     out_dtype=torch.float32), 20, "focus_stem"),
                plain_ms=cuda_ms(torch, lambda: fs.focus_stem_plain(x, w3, scale, shift,
                                                                   torch.float32), 10),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=cuda_ms(torch, lambda: Fn.conv2d(xn, w6, shift, stride=2, padding=2),
                                   20))


def dense_nms_row(torch, dev, rng, thr, lat, clock, B=8, K=2048, C=25):
    """The NMS kernels at postprocess_dense's shape: B frames of its top K
    candidates (boxes in clusters, so that it suppresses; 25 classes
    shifted apart, scores sorted), checked element for element and bit for
    bit against the plain version, then timed, with the latency bound."""
    import numpy as np

    from tscd_torch.ops.kernels import nms as kn
    from tscd_torch.ops.nms import class_shift, score_order
    centres = rng.uniform(40, 560, (B, 60, 2))
    xy = np.take_along_axis(centres, rng.integers(0, 60, (B, K))[..., None], 1) \
        + rng.normal(0, 8, (B, K, 2))
    wh = rng.uniform(20, 160, (B, K, 2))
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    boxes = t(np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32))
    cls = t(rng.integers(0, C, (B, K)))
    valid = t(np.ones((B, K), bool))
    _, bs, vs = score_order(class_shift(boxes, cls, valid),
                            t(rng.uniform(size=(B, K)).astype(np.float32)), valid)
    err, want = check_nms(torch, f"postprocess_dense ({B}, {K}) IoU {thr}", bs, vs, thr)
    return dict(max_abs_err=err, **timed(torch, lambda: kn.nms_sorted(bs, vs, thr), 100, "nms_"),
                plain_ms=cuda_ms(torch, lambda: kn.nms_sorted_plain(bs, vs, thr), 2, 1),
                **nms_bounds(B, K, lat, clock), bound_by="operations", bound_model=NMS_BOUND,
                library_ms=None, kept=int(want.sum()))


def fixture_still_exp(name, seed=2024):
    """A built-in still exp on the committed OVIS-format fixture (stage 1's
    json over the 720p frames)."""
    from tscd_torch.exp.yolox_base import STILL_EXPS
    exp = STILL_EXPS[name]()
    exp.data_dir = os.path.join(HERE, FILE_FIXTURE)
    exp.train_ann = os.path.join("ovis", "annotations_train.json")
    exp.val_ann = os.path.join("ovis", "annotations_valid.json")
    exp.train_name = exp.val_name = os.path.join("vid", "Data", "VID", "val")
    exp.seed = seed
    return exp


def OVIS_EXP():
    """The configuration phase ovis drives: ovis_tscd_large."""
    from tscd_torch.exp.ovis_tscd_base import LargeExp
    return LargeExp()


def ovis_exp(cls):
    """An OVIS TSCD exp on the committed fixture's json and frames."""
    exp = cls()
    exp.data_dir = os.path.join(HERE, FILE_FIXTURE, "vid")
    exp.ovis_name = os.path.join("Data", "VID", "val")
    exp.ovis_train_json = os.path.join(HERE, OVIS_FIXTURE, "annotations_train.json")
    exp.ovis_val_json = os.path.join(HERE, OVIS_FIXTURE, "annotations_valid.json")
    return exp


def still_agreement(torch):
    """The selftest-size YOLOX (depth 0.33, width 0.125, 25 classes) from
    the same seeded weights on the card machine's CPU and on the card: raw
    outputs (1e-4 of the largest) and detections (1e-4, as sets) on four
    fixture frames letterboxed to 128 px, then one step (train-mode BN,
    grouped SGD, EMA) on a mosaic batch: losses TRAIN_LOSS_RTOL relative,
    updates and EMA TRAIN_UPDATE_TOL of the largest update beyond the fp32
    spacing, the running statistics TRAIN_BN_TOL of their largest."""
    import numpy as np

    from tscd_torch.core.trainer import make_predict_fn
    from tscd_torch.data.transforms import letterbox
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.step import init_train_state, yolox_train_step
    exp = fixture_still_exp("ovis_still_selftest", seed=0)
    ds = exp.get_eval_dataset()
    imgs = np.stack([letterbox(ds.pull_item(i)[0], exp.test_size, np.uint8)[0]
                     for i in (0, 9, 18, 27)])
    loader = exp.get_data_loader(rng=random.Random(5), np_rng=np.random.RandomState(5),
                                 img_dtype=np.uint8)
    it = iter(loader)
    batch = next(it)
    it.close()
    host = lambda sd: {k: v.detach().cpu().clone() for k, v in sd.items()}   # noqa: E731
    res = {}
    for dev in ("cpu", card(torch)):
        model = random_init_(exp.get_model(device=dev), exp.seed)
        with torch.no_grad():
            raw = model(torch.as_tensor(imgs).to(dev), decode=False)["outputs"].cpu()
        rows = make_predict_fn(model, exp.num_classes, 1e-4, exp.nmsthre)(imgs)
        opt = exp.get_optimizer(model, loader.steps_per_epoch)
        opt.count = loader.steps_per_epoch * exp.warmup_epochs + 1
        st = init_train_state(model, opt, exp.ema_decay)
        before = host(model.state_dict())
        losses = yolox_train_step(st, torch.as_tensor(batch["imgs"]).to(dev),
                                  torch.as_tensor(batch["labels"]).to(dev))
        res[str(dev)] = (raw, rows, {k: float(v) for k, v in losses.items()}, before,
                         host(model.state_dict()), host(st.ema.state_dict()))
    cpu, gpu = res["cpu"], res[str(card(torch))]
    raw_err = float((gpu[0] - cpu[0]).abs().max()) / float(cpu[0].abs().max())
    worst, n = match_rows([cpu[1]], [gpu[1]], 1e-4, 1e-4)
    loss_err = max(abs(gpu[2][k] - v) / max(abs(v), 1e-6) for k, v in cpu[2].items())
    params = [k for k, v in cpu[3].items() if v.is_floating_point() and ".running_" not in k]
    running = [k for k in cpu[3] if ".running_" in k]
    dmax = max(float((cpu[4][k].double() - cpu[3][k].double()).abs().max()) for k in params)
    upd_err, ema_err = max_err(gpu[4], cpu[4], params), max_err(gpu[5], cpu[5], params)
    bn_err = max(float((gpu[4][k] - cpu[4][k]).abs().max()) / float(cpu[4][k].abs().max())
                 for k in running)
    ok = (raw_err <= 1e-4 and loss_err <= TRAIN_LOSS_RTOL and dmax > 0 and bn_err <= TRAIN_BN_TOL
          and upd_err <= TRAIN_UPDATE_TOL * dmax and ema_err <= TRAIN_UPDATE_TOL * dmax
          and all(np.isfinite(v) for v in gpu[2].values()))
    rec = {"config": "ovis_still_selftest: depth 0.33, width 0.125, 25 classes, 128 px",
           "raw_max_rel_err": raw_err, "detections": n, "detections_max_abs_err": worst,
           "losses_card": gpu[2], "losses_cpu": cpu[2], "loss_max_rel_err": loss_err,
           "max_update": dmax, "update_max_err_beyond_spacing": upd_err,
           "ema_max_err_beyond_spacing": ema_err, "running_stats_max_rel_err": bn_err,
           "tolerance": {"raw outputs": "1e-4 of the largest", "detections": 1e-4,
                         "losses": f"{TRAIN_LOSS_RTOL} relative",
                         "updates and EMA": f"{TRAIN_UPDATE_TOL} of the largest update beyond "
                                            "each value's fp32 spacing",
                         "running statistics": f"{TRAIN_BN_TOL} of the largest"},
           "pass": ok}
    emit({"phase": "still", "part": "card_against_cpu", **rec})
    if not ok:
        raise AssertionError("still: the selftest-size card run departs from the CPU's")


def still_phase(torch, counters):
    """Stage 1 of the OVIS recipe: the warp hashes; the selftest size card
    against CPU; ovis_yolox_l at full width through Trainer for
    STILL_STEPS steps on the fixture (6 with mosaic, mixup and the warp, 2
    in the no-aug tail with L1), each step timed with CUDA events, one more
    traced (busy share), the wrappers' launches (0: train-mode BN takes the
    conv route); the EMA weights through COCOEvaluator at ovis_yolox_l's,
    yolox_l's and yoloxl_ovis's sizes (stem and NMS launches a pass); the
    checkpoint `ovis` starts from; the kernels at the new shapes. Returns
    {"rows": kernels-line rows, "launches": {row: n}}."""
    import shutil

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tscd_torch.core.trainer import make_predict_fn
    from tscd_torch.ops.kernels import library
    t_phase = time.time()
    warp = warp_checks()
    emit({"phase": "still", "part": "warp", **warp})
    if not warp["pass"]:
        raise AssertionError(f"warp: {len(warp['mismatched'])} frames differ from cv2's pixels")
    still_agreement(torch)

    exp = fixture_still_exp(STILL_EXP)
    exp.max_epoch, exp.no_aug_epochs, exp.warmup_epochs, exp.batch_size = 4, 1, 1, 16
    exp.eval_interval = exp.ckpt_interval = 100     # evaluated below; the last epoch saves
    exp.print_interval = 2
    exp.output_dir = os.path.join(HERE, STAGE1_DIR)
    shutil.rmtree(exp.output_dir, ignore_errors=True)
    trainer = exp.get_trainer(device=card(torch))
    step_fn, records = trainer.step, []

    def timed_step(images, labels, use_l1=False):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses = step_fn(images, labels, use_l1)
        b.record()
        records.append((a, b, losses, use_l1, time.perf_counter()))
        return losses

    trainer.step = timed_step
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    state = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    wrapped = {name: c.launches for name, c in counters.items()}
    losses = [{k: float(v) for k, v in r[2].items()} for r in records]
    step_ms = [a.elapsed_time(b) for a, b, *_ in records]
    l1 = [r[3] for r in records]
    ok = (len(records) == STILL_STEPS and not any(wrapped.values())
          and l1 == [False] * (STILL_STEPS - 2) + [True] * 2
          and all(np.isfinite(v) for row in losses for v in row.values()))
    if not ok:
        raise AssertionError(f"still training: {len(records)} steps, L1 {l1}, wrapper launches "
                             f"{wrapped}, losses {losses}")
    B = exp.batch_size
    timed_ms = step_ms[2:]
    batch = next(it := iter(trainer._loader(False)))
    it.close()
    images, labels = trainer._upload(batch["imgs"], batch["labels"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step_fn(images, labels)
        b.record()
        torch.cuda.synchronize()
    traced_ms = a.elapsed_time(b)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.key != "Activity Buffer Request"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    table = sorted(({"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in kernels), key=lambda r: -r["ms"])
    with open(os.path.join(HERE, "build", "profile_still_step.json"), "w") as f:
        json.dump({"by_class": breakdown(table, TRAIN_KERNEL_CLASSES), "kernels": table}, f)
    ckpt = os.path.join(trainer.file_name, "latest_ckpt.pth")
    emit({"phase": "still", "part": "train", "config": STILL_CONFIG, "steps": len(records),
          "data": "the OVIS fixture's 32 JPEGs 1280x720 decoded by the port",
          "losses": losses, "l1_on": l1, "step_ms": step_ms,
          "median_step_ms_after_2": float(np.median(timed_ms)),
          "images_per_s": B * len(timed_ms) / (sum(timed_ms) / 1e3),
          "loop_images_per_s": B * (len(records) - 1) / (records[-1][4] - records[0][4]),
          "train_s": train_s, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "wrapper_launches": wrapped, "host_cpu": host_cpu(),
          "traced_step": {"step_ms": traced_ms, "device_busy_ms": busy_ms,
                          "device_busy_share": busy_ms / traced_ms,
                          "by_class": breakdown(table, TRAIN_KERNEL_CLASSES),
                          "kernels": sum(r["calls"] for r in table), "top": table[:10]},
          "checkpoint": os.path.relpath(ckpt, HERE),
          "checkpoint_mb": os.path.getsize(ckpt) / 2 ** 20})
    del images, labels, prof, trainer.step

    # the EMA weights through COCOEvaluator at three exps' eval settings
    model = exp.get_model(device=card(torch))
    model.load_state_dict(state.ema.state_dict())
    del state, trainer
    free_card(torch)
    from tscd_torch.exp.yolox_base import STILL_EXPS
    passes = {}
    for name in ("ovis_yolox_l", "yolox_l", "yoloxl_ovis"):
        # the fixture's val json, at that exp's eval settings
        e = fixture_still_exp(STILL_EXP)
        ref = STILL_EXPS[name]()
        e.test_size, e.nmsthre, e.test_conf = ref.test_size, ref.nmsthre, ref.test_conf
        predict = make_predict_fn(model, e.num_classes, e.test_conf, e.nmsthre)
        predict(np.full((8, *e.test_size, 3), 114, np.uint8))     # warm-up at this size
        for c in counters.values():
            c.launches = 0
        res = e.get_evaluator().evaluate(predict, log=lambda *a: None)
        torch.cuda.synchronize()
        n = {k: c.launches for k, c in counters.items()}
        batches = -(-32 // 8)
        if n != {"focus_stem": batches, "fused_dual_attention": 0, "hungarian": 0,
                 "nms": batches}:
            raise AssertionError(f"eval at {e.test_size}: wrapper launches {n}")
        passes[name] = {"test_size": list(e.test_size), "nmsthre": e.nmsthre,
                        "test_conf": e.test_conf, "ms_per_image": res.get("ms_per_image"),
                        "stats": res.get("stats"), "AP50": res["AP50"], "launches": n}
    emit({"phase": "still", "part": "eval", "images": 32, "batch": 8, "passes": passes})
    del model
    free_card(torch)

    dev = card(torch)
    lat, clock = latencies(torch, library.load()), sm_clock_mhz()
    rng = np.random.default_rng(60)
    rows = {"focus_stem_yolox_576": stem_row(torch, dev, rng, 8, 576, 576),
            "focus_stem_yolox_640": stem_row(torch, dev, rng, 8, 640, 640),
            "nms_dense_065": dense_nms_row(torch, dev, rng, 0.65, lat, clock),
            "nms_dense_05": dense_nms_row(torch, dev, rng, 0.5, lat, clock)}
    launches = {"focus_stem_yolox_576": passes["ovis_yolox_l"]["launches"]["focus_stem"],
                "focus_stem_yolox_640": passes["yolox_l"]["launches"]["focus_stem"],
                "nms_dense_065": passes["ovis_yolox_l"]["launches"]["nms"]
                + passes["yolox_l"]["launches"]["nms"],
                "nms_dense_05": passes["yoloxl_ovis"]["launches"]["nms"]}
    emit({"phase": "still", "seconds": time.time() - t_phase,
          "rows": {n: {k: v for k, v in r.items() if "ms" in k} for n, r in rows.items()}})
    return {"rows": rows, "launches": launches}


def ovis_phase(torch, counters):
    """Stage 2 of the OVIS recipe: ovis_tscd_large (seeded weights) over
    the fixture's val json through OVISEvaluator (4 windows of 8 + 24
    frames at 576 px): one window eagerly with its attention, solver and
    NMS inputs kept (the kernels checked and timed on them), the window's
    graph captured, then the evaluation timed (window ms, local frames/s)
    under torch.profiler, its launches counted in its own device trace (8
    solvers a window; the K = P x C NMS call told from the K = P one by its
    pack kernel's grid); one stage-2 step of ovis_tscd_large from `still`'s
    checkpoint; the selftest size (ovis_selftest) through the eval CLI on
    the card and on the card machine's CPU. Returns {"rows", "launches"}."""
    import numpy as np

    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.exp.ovis_tscd_base import OVISSelftestExp
    from tscd_torch.models import aggregation
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops import hungarian, nms
    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.ops.kernels import hungarian as hu
    from tscd_torch.ops.kernels import library
    from tscd_torch.ops.kernels import nms as kn
    t_phase = time.time()
    quiet = lambda *a: None   # noqa: E731
    exp = ovis_exp(OVIS_EXP)
    L = exp.lframe_val
    dev = card(torch)
    pin = dev.type == "cuda"
    model = random_init_(exp.get_model(device=dev), exp.seed)
    pred = make_predict_fn(model, L, exp.gframe_val, exp.nmsthre, exp.test_conf)
    loader = exp.get_eval_loader(pin_memory=pin)
    first = next(iter(loader))
    att, costs, sorted_in = [], [], []
    with keeping_calls(torch, {(aggregation, "fused_dual_attention"): att,
                               (hungarian, "linear_sum_assignment"): costs,
                               (nms, "nms_sorted"): sorted_in}):
        pred.materialize(pred.dispatch_eager(first["imgs"], first["time_embedding"], False,
                                             None)[0])
    shapes = [tuple(a[0].shape) for a in att], [tuple(c[0].shape) for c in costs], \
        [tuple(s[0].shape[:2]) for s in sorted_in]
    P = exp.num_proposals
    if (len(att) != 2 or shapes[0][0][0] != L or len(costs) != L
            or shapes[2] != [(L, P * exp.num_classes), (L, P)]):
        raise AssertionError(f"an OVIS window's calls: attention, solver, NMS {shapes}")

    # the window's CUDA graph, captured at its first dispatch (which runs
    # the window eagerly), before the timed evaluation replays it
    pred.materialize(pred.dispatch(first["imgs"], first["time_embedding"], False, None)[0])
    # the val json's one video of 32 frames: 32 // L windows
    nw = len(loader.dataset.res)
    rows_ev, times = [], {}

    def evaluate():
        rows_ev.clear()
        times.update(events=[], dispatch_s=[], materialize_s=[], marks=[])
        t0 = time.perf_counter()
        res = exp.get_evaluator(exp.get_eval_loader(pin_memory=pin)).evaluate(
            recording(pred, rows_ev, times), quiet)
        return res, time.perf_counter() - t0

    # the timed evaluation traced: every window a replay, its kernels
    # counted in the device trace, none by a wrapper
    (res, eval_s), launches, prof = traced_path(torch, counters, evaluate, nw, L, bf16=False,
                                                attempts=3)
    eval_kernels = trace_kernels(trace_events(prof, os.path.join(HERE, "build",
                                                                 "trace_ovis_eval.json")))
    del prof
    window_ms = [a.elapsed_time(b) for a, b in times["events"]]
    if (nw != 32 // L or len(rows_ev) != nw or len(res.get("stats", [])) != 12
            or not np.isfinite(res["stats"]).all()):
        raise AssertionError(f"OVIS eval: {len(rows_ev)} of {nw} windows, result {res}")
    emit({"phase": "ovis", "part": "eval", "config": OVIS_CONFIG,
          "data": "the OVIS fixture's valid json: 1 video of 32 JPEGs 1280x720",
          "windows": nw, "evaluated_frames": nw * L, "evaluate_s": eval_s,
          "local_frames_per_s": nw * L / eval_s, "window_ms": window_ms,
          "window_ms_mean": float(np.mean(window_ms)), "ms_per_frame": res["ms_per_frame"],
          "launches": launches, "traces": traced_path.attempts,
          "launches_from": "the device trace of this timed evaluation (graph replays, "
                           "under torch.profiler)",
          "solver_launches_a_window": launches["hungarian"] / nw, "stats": res["stats"],
          "pass": True})

    # the kernels on the window's own inputs
    lat, clock = latencies(torch, library.load()), sm_clock_mhz()
    a = att[0]
    errs = [check_close(f"fused_dual_attention OVIS window {part}", g, w, atol=1e-5, rtol=1e-4)
            for part, g, w in zip(("out_cls", "out_reg", "attn"), fa.fused_dual_attention(*a),
                                  fa.fused_dual_attention_plain(*a))]
    B, h, q, d = a[0].shape
    k = a[1].shape[2]
    nbytes = 4 * (2 * B * h * q * d + 4 * B * h * k * d + B * k) + B * k \
        + 4 * (2 * B * h * q * d + B * h * q * k)
    b_ms, b_by = bound(nbytes, (B * h * 8 * q * k * d, H100_FP32_FLOPS))
    rows = {"fused_dual_attention_ovis": dict(
        max_abs_err=max(errs), **timed(torch, lambda: fa.fused_dual_attention(*a), 100,
                                       "fused_dual_attention"),
        plain_ms=cuda_ms(torch, lambda: fa.fused_dual_attention_plain(*a), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)}
    cost = costs[-1][0]
    for c in costs:
        check_hungarian("hungarian OVIS window's cost", c[0])
    rows["hungarian_ovis"] = dict(
        max_abs_err=0, **hungarian_cost_row(torch, cost, lat, clock), bound_by="operations",
        bound_model=HUNGARIAN_BOUND, library_ms=None,
        plain_ms=cuda_ms(torch, lambda: hu.linear_sum_assignment_plain(cost), 3, 1))
    boxes_s, valid_s, thr = sorted_in[0]
    err, want = check_nms(torch, f"OVIS window's refined call {tuple(boxes_s.shape[:2])}",
                          boxes_s, valid_s, thr)
    rows["nms_ovis"] = dict(
        max_abs_err=err, **timed(torch, lambda: kn.nms_sorted(boxes_s, valid_s, thr), 100, "nms_"),
        plain_ms=cuda_ms(torch, lambda: kn.nms_sorted_plain(boxes_s, valid_s, thr), 3, 1),
        **nms_bounds(L, boxes_s.shape[1], lat, clock), bound_by="operations",
        bound_model=NMS_BOUND, library_ms=None, kept=int(want.sum()),
        valid=int(valid_s.sum()))
    # the K = P x C call's launches in the timed evaluation's trace: its
    # pack kernel's grid, read from a trace of that call alone
    grid = call_grid(torch, lambda: kn.nms_sorted(boxes_s, valid_s, thr), "nms_pack_iou",
                     os.path.join(HERE, "build", "trace_nms_ovis.json"))
    packs = [k["grid"] for k in eval_kernels if "nms_pack_iou" in k["name"]]
    n_ovis = sum(g == grid for g in packs)
    if n_ovis != nw or len(packs) != 2 * nw:
        raise AssertionError(f"OVIS eval trace: {n_ovis} NMS calls of grid {grid} and "
                             f"{len(packs)} in all for {nw} windows")
    rows["nms_ovis"]["pack_grid"] = grid
    recipe_launches = {"fused_dual_attention_ovis": launches["fused_dual_attention"],
                       "hungarian_ovis": launches["hungarian"], "nms_ovis": n_ovis}
    del pred, model, att, costs, sorted_in, first, loader
    free_card(torch)

    # one stage-2 step from stage 1's checkpoint
    ckpt = os.path.join(HERE, STAGE1_DIR, STILL_EXP, "latest_ckpt.pth")
    exp = ovis_exp(OVIS_EXP)
    exp.output_dir = os.path.join(HERE, "build", "ovis_phase")
    args = type("Args", (), {"ckpt": ckpt, "resume": False, "start_epoch": 0})()
    trainer = exp.get_trainer(args, device=dev)
    trainer.dataset = exp.get_train_dataset()
    iters = len(trainer.dataset.res)
    trainer._init_state(iters)
    stage1 = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    loaded = [k for k, v in trainer.model.state_dict().items()
              if k in stage1 and v.shape == stage1[k].shape and v.is_floating_point()]
    same = all(torch.equal(trainer.model.state_dict()[k].cpu(), stage1[k]) for k in loaded)
    it = iter(trainer._loader(0))
    batch = next(it)
    it.close()
    frames, labels, te = trainer._upload(batch)
    step_ms, step_losses = [], []
    for _ in range(2):            # the first step, and a second from its state
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step_losses.append({k: float(v) for k, v in trainer.step(frames, labels, te).items()})
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
    ok = same and len(loaded) > 300 and all(np.isfinite(v) for row in step_losses
                                            for v in row.values())
    emit({"phase": "ovis", "part": "stage2_step", "from": os.path.relpath(ckpt, HERE),
          "tensors_from_stage1": len(loaded), "equal_to_stage1": same,
          "windows": iters, "step_ms": step_ms, "losses": step_losses, "pass": ok})
    if not ok:
        raise AssertionError("ovis: stage 2 did not start from stage 1's weights, or its "
                             f"losses are not finite: {step_losses}")
    del trainer, frames, labels, te
    free_card(torch)

    # the selftest size through the eval CLI, card against CPU
    sexp = ovis_exp(OVISSelftestExp)
    build = os.path.join(HERE, "build", "ovis_phase")
    os.makedirs(build, exist_ok=True)
    weights = os.path.join(build, "ovis_selftest_seeded.pth")
    torch.save(random_init_(sexp.get_model(device="cpu"), sexp.seed).state_dict(), weights)
    opts = ["data_dir", sexp.data_dir, "ovis_name", sexp.ovis_name,
            "ovis_val_json", sexp.ovis_val_json, "ovis_train_json", sexp.ovis_train_json]
    out = []
    for d in ("cpu", str(card(torch))):
        rows_d = []
        out.append((eval_cli(["--exp", "ovis_selftest", "--dataset", "ovis", "-c", weights,
                              "--device", d, *opts], rows_d), rows_d))
    os.remove(weights)
    worst, n = match_rows(out[0][1], out[1][1], 1e-4, 1e-4)
    stats_err = float(np.abs(np.subtract(out[0][0]["stats"], out[1][0]["stats"])).max())
    emit({"phase": "ovis", "part": "selftest_card_against_cpu",
          "config": "ovis_selftest: depth 0.33, width 0.125, P=6, 2+6 frames, 128 px",
          "windows": len(out[1][1]), "detections": n, "max_abs_err": worst,
          "stats_max_abs_err": stats_err, "tolerance": {"detections": 1e-4, "stats": 1e-4},
          "pass": stats_err <= 1e-4})
    if stats_err > 1e-4:
        raise AssertionError(f"ovis selftest: the card's stats differ from the CPU's by {stats_err}")
    emit({"phase": "ovis", "seconds": time.time() - t_phase,
          "rows": {n: {k: v for k, v in r.items() if "ms" in k} for n, r in rows.items()}})
    return {"rows": rows, "launches": recipe_launches}



# -- phase yolov: the YOLOV family (YOLOV, YOLOV++, TSCD's localagg) ---------

YOLOV_CONFIG = ("yolov_l: YOLOV-L (depth 1.0, width 1.0), 30 classes, 4 heads, P=30, eval windows "
                "of 0 + 32 frames at 576 px (the pre-NMS at 0.75 on, MSA over 960 proposals), "
                "training windows of 0 + 16, fp32, seeded weights")
# rows of the kernels line at the YOLOV family's shapes: {row: (its kernel's row, the shape)}
YOLOV_ROWS = {
    "fused_dual_attention_msa": ("fused_dual_attention_stream",
                                 "yolov_l window self-attention: B 1, h 4, q = k = 960 (32 "
                                 "frames x 30 proposals), d 64, fp32 (streaming route; the "
                                 "split route timed beside it)"),
    "fused_dual_attention_msa_d32": ("fused_dual_attention_stream",
                                     "v++_base_decoupleReg window self-attention: B 1, h 4, "
                                     "q = k = 960, d 32, fp32 (agg and agg_iou; streaming "
                                     "route)"),
    "nms_yolov_refined": ("nms", "yolov_l postprocess_refined: 32 frames x K = 900 (30 "
                                 "proposals x 30 classes, shifted), IoU 0.5"),
}
# each window's hand-kernel launches by TRACE_NAMES row (the others none):
# the MSA's q = k = 960 streams, v++_large's MCA (q = 50) splits
YOLOV_WINDOWS = {
    "yolov_l": {"focus_stem": 1, "fused_dual_attention_stream": 1, "nms": 2},
    "v++_base_decoupleReg": {"focus_stem": 1, "fused_dual_attention_stream": 2, "nms": 1},
    "v++_large": {"focus_stem": 1, "fused_dual_attention": 2, "nms": 1}}


def yolov_exp(name, **knobs):
    from tscd_torch.exp import get_exp_by_name
    return exp_with(get_exp_by_name(name), **knobs)


def _yolov_window_out(torch, exp, model, x, te):
    """The head's dict of one window and its refined detections (the
    eval postprocess of the model's family)."""
    from tscd_torch.core.yolov_trainer import yolov_forward
    from tscd_torch.models.tscd import tscd_eval_postprocess
    from tscd_torch.models.yolov import yolov_eval_postprocess
    L, G = exp.lframe_val, exp.gframe_val
    with torch.no_grad():
        if hasattr(model, "refined_frames"):
            out = yolov_forward(model, x, L, G, te)
            post = lambda o: yolov_eval_postprocess(   # noqa: E731
                o, model.refined_frames(L, G), exp.num_classes, exp.nmsthre, exp.test_conf)[0]
        else:
            out = model(x, te, L, G)
            post = lambda o: tscd_eval_postprocess(    # noqa: E731
                o, L, exp.num_classes, exp.nmsthre, exp.test_conf)[0]
    return out, post


def _moved(out, dev):
    """The head dict's tensors (and its proposals') on `dev`."""
    import torch
    from tscd_torch.models.tscd_head import FrameProposals
    res = {}
    for k, v in out.items():
        if isinstance(v, FrameProposals):
            res[k] = FrameProposals(*(t.to(dev) for t in v))
        elif isinstance(v, torch.Tensor):
            res[k] = v.to(dev)
    return res


# A localagg head's relation bias enters its logits as log(relu(b) + 1e-6),
# whose slope reaches 1e6 near b = 0: at random weights fp32 roundings move
# those logits by up to 1.2% of their largest (v_plus_base_localagg's
# refined cls logits, the card against the CPU, H100 80GB HBM3 at 700 W),
# so its refined outputs are held to this share of their largest, and the
# aggregation is compared in float64, on the same inputs (the CPU's), on
# the card and on the CPU, to LOCALAGG_F64_TOL of its largest
LOCALAGG_FP32_TOL = 2e-2
LOCALAGG_F64_TOL = 1e-6


def localagg_f64(torch, model, args, dev):
    """`model`'s localagg aggregation (no hand kernel: tensor ops) on a
    float64 copy, on `dev`, on the captured call's arguments."""
    import copy
    agg = copy.deepcopy(model.head.agg).to(dev).double()
    args = [a.to(dev).double() if torch.is_tensor(a) and a.is_floating_point()
            else a.to(dev) if torch.is_tensor(a) else a for a in args]
    with torch.no_grad():
        return [t.cpu() for t in agg(*args)]


def card_cpu_record(torch, name, exp):
    """One window of `exp` from one seeded state on the card machine's CPU
    (plain versions) and on the card (kernels): the raw outputs 1e-4 of
    their largest, the proposals (anchors, validity) exactly, every refined
    output 1e-4 of its largest; for localagg, whose fp32 logits are
    ill-conditioned, the refined outputs LOCALAGG_FP32_TOL of their
    largest and the aggregation in float64 on the CPU's inputs on both
    (LOCALAGG_F64_TOL); the card's postprocess (the NMS kernels) on the
    CPU's head outputs equal to the CPU's detections as sets, 1e-4. Then 2
    windows through the model's predict function on the card (the second
    a graph replay): finite rows. Returns the record."""
    import numpy as np

    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops.position import get_timing_signal_1d
    sd = random_init_(exp.get_model(device="cpu"), exp.seed).state_dict()
    F = exp.lframe_val + exp.gframe_val
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.uniform(0, 255, (F, *exp.test_size, 3)).astype(np.float32))
    te = torch.as_tensor(get_timing_signal_1d(np.arange(F)))
    localagg = exp.agg_type == "localagg"
    res, agg_args = {}, []
    for dev in ("cpu", card(torch)):
        model = exp.get_model(device=dev)
        model.load_state_dict(sd)
        hook = (model.head.agg.register_forward_hook(lambda m, a, o: agg_args.append(a))
                if localagg else None)
        res[str(dev)] = (model,) + _yolov_window_out(torch, exp, model, x.to(dev), te.to(dev))
        if hook is not None:
            hook.remove()
    (cpu_model, cpu, post), (model, gpu, _) = res["cpu"], res[str(card(torch))]
    errs = {}
    for k, v in cpu.items():
        if k in ("raw_outputs", "decoded") or k.startswith(("refined_", "matcher_")):
            if k == "matcher_state":
                continue
            err = float((gpu[k].cpu().double() - v.double()).abs().max())
            errs[k] = err / max(1.0, float(v.abs().max()))
            tol = (LOCALAGG_FP32_TOL if localagg and k not in ("raw_outputs", "decoded")
                   else 1e-4)
            if errs[k] > tol:
                raise AssertionError(f"{name}: {k} on the card {err} from the CPU's "
                                     f"(of its largest: {errs[k]} > {tol})")
    if localagg:
        want = localagg_f64(torch, cpu_model, agg_args[0], "cpu")
        got = localagg_f64(torch, model, agg_args[0], card(torch))
        errs["aggregation_float64"] = max(
            float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            for g, w in zip(got, want))
        if errs["aggregation_float64"] > LOCALAGG_F64_TOL:
            raise AssertionError(f"{name}: the float64 aggregation on the card "
                                 f"{errs['aggregation_float64']} from the CPU's")
    for f in ("idx", "valid"):
        if not torch.equal(getattr(gpu["proposals"], f).cpu(), getattr(cpu["proposals"], f)):
            raise AssertionError(f"{name}: the card's proposals ({f}) differ from the CPU's")
    pred = exp.get_predict_fn(model)
    rows = lambda d: [pred.materialize(d)]          # noqa: E731
    worst, n = match_rows(rows(post(_moved(cpu, card(torch)))), rows(post(cpu)), 1e-4, 1e-4)
    dets, _, _ = run_windows(torch, pred, exp, 2, 9, False)
    finite = all(np.isfinite(r).all() and r.shape[1] == 7 for d in dets
                 for r in pred.materialize(d))
    if not finite:
        raise AssertionError(f"{name}: non-finite detections on the card")
    return {"max_err_of_largest": errs, "postprocess_detections": n,
            "postprocess_max_abs_err": worst}


SMALL_TOLERANCE = {"outputs": "1e-4 of the largest (localagg's refined outputs "
                   f"{LOCALAGG_FP32_TOL}; its aggregation in float64 on the CPU's "
                   f"inputs {LOCALAGG_F64_TOL})", "proposals": "exact",
                   "detections": {"atol": 1e-4, "rtol": 1e-4}}


def yolov_small_part(torch):
    """(a) At the selftest size (yolov_selftest: depth 0.33, width 0.125,
    P = 8, 64 px): YOLOV, YOLOV++ msa + decouple_reg, v++_large's mca (1 +
    3 frames), v_plus_base's localagg and TSCD's localagg (the selftest
    exp), each `card_cpu_record`."""
    from tscd_torch.exp.tscd_large import selftest_exp
    plus = dict(model_family="yolov_plus", reconf=True)
    configs = {
        "yolov": yolov_exp("yolov_selftest"),
        "v++_msa_decoupleReg": yolov_exp("yolov_selftest", agg_type="msa", decouple_reg=True,
                                         **plus),
        "v++_large_mca": yolov_exp("yolov_selftest", agg_type="mca", decouple_reg=True,
                                   lframe_val=1, gframe_val=3, **plus),
        "v_plus_base_localagg": yolov_exp("yolov_selftest", agg_type="localagg",
                                          decouple_reg=False, **plus),
        "tscd_localagg": exp_with(selftest_exp(), agg_type="localagg"),
    }
    recs = {name: card_cpu_record(torch, name, exp) for name, exp in configs.items()}
    emit({"phase": "yolov", "part": "small", "configs": recs, "tolerance": SMALL_TOLERANCE,
          "pass": True})


def yolov_windows_part(torch, counters):
    """(b) yolov_l, v++_base_decoupleReg and v++_large windows at full
    width (seeded weights, fp32, uint8 frames): a warm-up window (eager,
    then the graph captured), 3 streamed graph replays traced (each
    window's hand-kernel launches from its own device trace: the stem, the
    attention, the NMS walks, no solver; the streaming attention's grid,
    which names its q), then 5 replays back to back untraced (window ms
    from CUDA events, frames/s, busy share). yolov_l's pre-NMS and refined
    NMS inputs are kept from one eager window. Returns {exp: record} and
    yolov_l's NMS calls."""
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops import nms
    recs, calls = {}, []
    for name, per_window in YOLOV_WINDOWS.items():
        exp = yolov_exp(name)
        torch.cuda.reset_peak_memory_stats()
        model = random_init_(exp.get_model(device=card(torch)), exp.seed)
        pred = exp.get_predict_fn(model)
        run_windows(torch, pred, exp, 1, 100, True, uint8=True)          # warm-up, capture
        if name == "yolov_l":
            capture_window(torch, pred, exp, None, {(nms, "nms_sorted"): calls})
        if name == "yolov_l":
            H, W = exp.test_size
            P, F = model.head.num_proposals, exp.lframe_val + exp.gframe_val
            nms_shapes = sorted([(F, min(750, sum((H // st) * (W // st)
                                                  for st in model.head.strides))),
                                 (F, P * exp.num_classes)])
            # the streaming route: query tiles of stream_plan's rows x B h, at q = k = F P
            grid = stream_grid(torch, exp.heads, F * P)
        n = 3
        want = dict.fromkeys(TRACE_NAMES, 0)
        want.update({row: k * n for row, k in per_window.items()})
        (dets, lat, _), launches, prof = traced_path(
            torch, counters, lambda: run_windows(torch, pred, exp, n, 60, True, uint8=True),
            n, 0, False, attempts=3, want=want)
        grids = sorted({tuple(k["grid"]) for k in trace_kernels(trace_events(
            prof, os.path.join(HERE, "build", f"trace_{name}.json")))
            if "fused_dual_attention_stream" in k["name"]})
        import numpy as np
        n_det = sum(len(r) for d in dets for r in pred.materialize(d)
                    if r.ndim == 2 and r.shape[1] == 7 and np.isfinite(r).all())
        loop = graph_loop(torch, pred, exp, None, n=5)
        F = exp.lframe_val + exp.gframe_val
        R = model.refined_frames(exp.lframe_val, exp.gframe_val)
        loop["evaluated_frames_per_s"] = R * loop["windows"] / loop["wall_s"]
        q = model.head.num_proposals * (F if exp.agg_type != "mca" else 1)
        recs[name] = {"frames": F, "refined_frames": R, "P": model.head.num_proposals,
                      "traced_window_ms": lat, "launches": launches,
                      "traces": traced_path.attempts, "attention_grids": grids,
                      "attention_q": q, "detections": n_det, **loop,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if n_det == 0:
            raise AssertionError(f"{name}: no detections")
        emit({"phase": "yolov", "part": "window", "exp": name, **recs[name], "pass": True})
        del pred, model
        free_card(torch)
    g = recs["yolov_l"]["attention_grids"]
    if g != [grid]:
        raise AssertionError(f"yolov_l's streaming attention grids {g}: {[grid]} (q = k = F P) "
                             "expected")
    shapes = sorted(tuple(c[0].shape[:2]) for c in calls)
    if shapes != nms_shapes:
        raise AssertionError(f"yolov_l's NMS calls {shapes}: the pre-NMS and the refined "
                             f"postprocess, {nms_shapes}, expected")
    return recs, calls


def yolov_eval_part(torch):
    """(c) vid_eval on the 720p fixture's files (1 video of 32 frames: one
    0 + 32 window) with yolov_l from seeded weights saved as a port .pth;
    then the evaluator again on the same predict function (its graph
    captured): local frames/s and the busy share of the card (dispatch
    spans from CUDA events over the evaluation's wall time)."""
    import numpy as np

    from tscd_torch.core import yolov_trainer
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.tools import vid_eval
    exp = yolov_exp("yolov_l")
    build = os.path.join(HERE, "build", "yolov_phase")
    os.makedirs(build, exist_ok=True)
    weights = os.path.join(build, "yolov_l_seeded.pth")
    torch.save(random_init_(exp.get_model(device="cpu"), exp.seed).state_dict(), weights)
    video = os.path.join(HERE, FILE_FIXTURE, "vid")
    opts = ["data_dir", video, "val_seq_path", os.path.join(video, "val_seq.npy")]
    kept, rows = [], []
    real = yolov_trainer.make_predict_fn

    def keep(*a, **k):
        kept.append(real(*a, **k))
        return recording(kept[-1], rows)
    yolov_trainer.make_predict_fn = keep
    try:
        t0 = time.perf_counter()
        res = vid_eval.main(["--exp", "yolov_l", "-c", weights, "--device", str(card(torch)),
                             *opts])
        cli_s = time.perf_counter() - t0
    finally:
        yolov_trainer.make_predict_fn = real
    os.remove(weights)
    exp.merge(opts)
    times = {"events": [], "dispatch_s": [], "materialize_s": [], "marks": []}
    rows2 = []
    loader = exp.get_eval_loader(pin_memory=card(torch).type == "cuda")
    t0 = time.perf_counter()
    res2 = exp.get_evaluator(loader).evaluate(recording(kept[0], rows2, times),
                                             log=lambda *a: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = sum(a.elapsed_time(b) for a, b in times["events"]) / 1e3
    frames = sum(len(w) for w in rows2)
    ok = (len(rows) == WINDOW_FRAMES // exp.gframe_val and len(rows[0]) == exp.gframe_val
          and np.isfinite(res["stats"]).all()
          and all(r.ndim == 2 and r.shape[1] == 7 for w in rows + rows2 for r in w))
    rec = {"config": YOLOV_CONFIG, "source": "tscd_torch/data/fixtures/vid: 32 JPEG frames "
           "1280x720", "windows": len(rows), "cli_s": cli_s, "evaluate_s": wall,
           "local_frames": frames, "local_frames_per_s": frames / wall,
           "device_busy_share": busy / wall, "dispatch_ms": [1e3 * t for t in times["dispatch_s"]],
           "stats": res["stats"], "stats_second_run": res2["stats"],
           "detections": int(sum(len(r) for w in rows for r in w)), "pass": bool(ok)}
    emit({"phase": "yolov", "part": "eval", **rec})
    if not ok:
        raise AssertionError("yolov_l on the fixture files: bad windows or detections")
    del kept
    free_card(torch)


def yolov_train_window(torch, exp, seed, near=True):
    """train_window of `exp` with each frame's first 3 gts near the
    seeded model's first 3 proposals there (as boxes_near_proposals)."""
    import numpy as np

    from tscd_torch.core.yolov_trainer import yolov_forward
    from tscd_torch.models.tscd import random_init_
    x, lab, te = train_window(torch, exp, seed)
    if not near:
        return x, lab, te
    model = random_init_(exp.get_model(device="cpu"), exp.seed)
    with torch.no_grad():
        b = yolov_forward(model, x, exp.lframe, exp.gframe, te)["proposals"].boxes[:, :3].numpy()
    rng = np.random.default_rng(seed + 1)
    cxcywh = np.concatenate([(b[..., :2] + b[..., 2:]) / 2, b[..., 2:] - b[..., :2]], -1)
    cxcywh[..., :2] += rng.uniform(-2, 2, cxcywh[..., :2].shape)
    cxcywh[..., 2:] *= rng.uniform(1.1, 1.4, cxcywh[..., 2:].shape)
    lab = lab.clone()
    lab[:, :3, 1:] = torch.from_numpy(cxcywh.astype(np.float32))
    return x, lab, te


def yolov_step_state(torch, exp, dev, iters, step0):
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.step import init_train_state
    model = random_init_(exp.get_model(device=dev), exp.seed)
    opt = exp.get_optimizer(model, iters)
    opt.count = step0
    return init_train_state(model, opt, exp.ema_decay)


def yolov_step(torch, st, exp, window):
    from tscd_torch.core.yolov_trainer import yolov_window_loss
    from tscd_torch.train.step import train_step
    return train_step(st, *window, exp.lframe, exp.gframe, fix_bn=exp.fix_bn,
                      window_loss=yolov_window_loss)


def yolov_train_part(torch):
    """(d) One YOLOV step (YOLOVTrainer's: fix_bn, frozen backbone, SimOTA,
    yolov_loss, grouped SGD, EMA) at the selftest size from the same
    seeded weights and window past warm-up, on the card machine's CPU and
    on the card: losses 1e-4 relative, updates and EMA 1e-3 of the largest
    update beyond the fp32 spacing. Then yolov_l at 0 + 16 frames, 576 px:
    2 warm-up and 3 timed steps (CUDA events), frames/s, peak memory, the
    attention's forward and backward calls a step."""
    import numpy as np

    from tscd_torch.ops.kernels import fused_attention as fa
    exp = yolov_exp("yolov_selftest")
    iters, step0 = 4, 5
    window = yolov_train_window(torch, exp, 43)
    out = {}
    for dev in ("cpu", card(torch)):
        st = yolov_step_state(torch, exp, dev, iters, step0)
        before = {k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()}
        losses = yolov_step(torch, st, exp, [t.to(dev) for t in window])
        out[str(dev)] = ({k: float(v) for k, v in losses.items()}, before,
                    {k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()},
                    {k: v.detach().cpu().clone() for k, v in st.ema.state_dict().items()})
    cpu, gpu = out["cpu"], out[str(card(torch))]
    loss_err = max(abs(gpu[0][k] - v) / max(abs(v), 1e-6) for k, v in cpu[0].items())
    trained = [k for k, v in cpu[1].items() if not k.startswith("backbone")
               and v.is_floating_point()]
    dmax = max(float((cpu[2][k].double() - cpu[1][k].double()).abs().max()) for k in trained)
    upd_err = max_err(gpu[2], cpu[2], trained)
    ema_err = max_err(gpu[3], cpu[3], [k for k, v in gpu[3].items() if v.is_floating_point()])
    ok = (loss_err <= TRAIN_LOSS_RTOL and dmax > 0 and upd_err <= TRAIN_UPDATE_TOL * dmax
          and ema_err <= TRAIN_UPDATE_TOL * dmax and cpu[0]["loss_refined_cls"] > 0
          and all(np.isfinite(v) for v in gpu[0].values()))
    emit({"phase": "yolov", "part": "train_small", "config": "yolov_selftest 0+4 frames 64px P=8",
          "losses_card": gpu[0], "loss_max_rel_err": loss_err, "max_update": dmax,
          "update_max_err_beyond_spacing": upd_err, "ema_max_err_beyond_spacing": ema_err,
          "tolerance": {"losses": TRAIN_LOSS_RTOL, "updates and EMA": TRAIN_UPDATE_TOL},
          "pass": ok})
    if not ok:
        raise AssertionError("yolov train_small: the card's step departs from the CPU's")

    exp = yolov_exp("yolov_l")
    st = yolov_step_state(torch, exp, card(torch), iters, step0)
    window = [t.to(card(torch)) for t in yolov_train_window(torch, exp, 44, near=False)]
    b0, n0 = fa.fused_dual_attention.backward_calls, fa.fused_dual_attention.launches
    losses = {}
    ms, wall, peak = timed_steps(torch, lambda: losses.update(yolov_step(torch, st, exp, window)),
                                 3, warmup=2)
    calls = ((fa.fused_dual_attention.launches - n0) / 5,
             (fa.fused_dual_attention.backward_calls - b0) / 5)
    F = exp.lframe + exp.gframe
    rec = {"config": YOLOV_CONFIG, "step_ms": ms, "frames_per_s": F * len(ms) / wall,
           "peak_mem_gb": peak, "attention_calls_a_step": {"forward": calls[0],
                                                           "backward": calls[1]},
           "losses": {k: float(v) for k, v in losses.items()}}
    ok = calls == (1.0, 1.0) and all(np.isfinite(v) for v in rec["losses"].values())
    emit({"phase": "yolov", "part": "train", **rec, "pass": ok})
    if not ok:
        raise AssertionError(f"yolov_l step: attention calls {calls}, losses {rec['losses']}")
    del st, window
    free_card(torch)


def split_route(torch, args, scale=25.0):
    """The split route's launch on fp32 `args` (the wrapper's argument
    order, fg last or absent), called through the library: the wrapper
    takes it only up to q = 128, and this times it beside the streaming
    route at a larger q on the same inputs (the port never calls it so)."""
    import ctypes

    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.ops.kernels import library
    *qkv, score, valid = args[:8]
    fg = args[8] if len(args) > 8 else None
    B, h, q, d = qkv[0].shape
    k = qkv[1].shape[2]
    qkv = [t if t.stride(-1) == 1 else t.contiguous() for t in qkv]
    nch, dp = -(-k // fa.KEY_CHUNK), -(-d // 4) * 4
    f32 = dict(device=qkv[0].device, dtype=torch.float32)
    scratch = torch.empty(B * h * q * (4 * nch + 4 * nch * dp + 2 * k), **f32)
    out_c, out_r = torch.empty(B, h, q, d, **f32), torch.empty(B, h, q, d, **f32)
    attn = torch.empty(B, h, q, k, **f32)
    strides = (ctypes.c_longlong * 18)(*(st for t in qkv for st in t.stride()[:3]))
    lib = library.load()
    rc = lib.tscd_fused_dual_attention(
        *(t.data_ptr() for t in qkv), score.data_ptr(), None if fg is None else fg.data_ptr(),
        valid.data_ptr(), out_c.data_ptr(), out_r.data_ptr(), attn.data_ptr(),
        scratch.data_ptr(), 4 * scratch.numel(), strides, B, h, q, k, d, float(scale), 0,
        torch.cuda.current_stream().cuda_stream)
    library.check(lib, rc, "fused_dual_attention (split route)")
    return out_c, out_r, attn


def stream_grid(torch, h, q, d=64):
    """The streaming kernel's grid at B 1, h heads, q = k: query tiles of
    `stream_plan`'s rows x h (the YOLOV family's head dims, 32 and 64, take
    the same rows)."""
    from tscd_torch.ops.kernels import fused_attention as fa
    rows, _ = fa.stream_plan(1, h, q, d, torch.cuda.get_device_properties(0).multi_processor_count)
    return (-(-q // rows), h, 1)


def stream_resources(torch, lib, B, h, n, d, bf16=False):
    """The streaming kernel as launched at (B, h, q = n, d): the instance's
    ptxas registers and spills (build/kernels/build.log), and from the
    runtime its block (query rows, key slices, threads, blocks), dynamic
    shared memory, blocks a SM, registers and local bytes a thread; the
    block the wrapper's `stream_plan` mirrors must be the one launched."""
    import ctypes

    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.ops.kernels import library
    out = (ctypes.c_int * 8)()
    library.check(lib, lib.tscd_fused_dual_attention_stream_config(B, h, n, d, int(bf16), out),
                  "fused_dual_attention_stream config")
    rec = dict(rows=out[0], key_slices=out[7], threads=out[1], blocks=out[2] * B * h,
               smem_bytes=out[3], blocks_per_sm=out[4], registers=out[5], local_bytes=out[6])
    plan = fa.stream_plan(B, h, n, d, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan != (rec["rows"], rec["key_slices"]):
        raise AssertionError(f"stream_plan {plan} at (B {B}, h {h}, q {n}, d {d}) is not the "
                             f"launched block {rec}")
    dpad = 32 if d <= 32 else 64 if d <= 64 else 128
    name = (f"fused_dual_attention_stream{'I13__nv_bfloat16' if bf16 else 'If'}Li{dpad}ELi"
            f"{rec['key_slices']}E")
    ptxas, keep = [], False
    for line in open(os.path.join(HERE, "build", "kernels", "build.log")).read().splitlines():
        if "Compiling entry function" in line:
            keep = name in line
        if keep and ("spill" in line or "Used" in line):
            ptxas.append(line.strip())
    if not ptxas:
        raise AssertionError(f"no ptxas record of {name} in build/kernels/build.log")
    rec["ptxas"] = ptxas
    return rec


def stream_attention_row(torch, dev, rng, h, n, d, fg=False, reps=50, plain_reps=10,
                         cases=("random", "views"), split=False):
    """The attention's streaming route at q = k = n, head dim d, with the
    online MSA's per-key fg score or without: against the plain version
    (1e-5 absolute, 1e-4 relative) on each of `cases` ("random": random
    q/k/v with 20% of the keys invalid; "views": the joint projection's
    strided views, a DualBranchAttention(cross=False) on seeded features,
    the same keys invalid; "bf16": those views in bf16), then timed on the
    views: `ms` (device), `call_ms`, the plain version's ms, its bound (8 q
    k d flops a head, each done as 3 TF32 products on the tensor cores,
    against the bytes: q/k/v, the scores and the mask read once, attn and
    the outputs written once), the same work's fp32 FMA bound, the
    design's own floor (1.5x the tensor cores' operations: pass 2
    recomputes the logits) and the kernel's resources at this shape
    (`stream_resources`); with `split`, the split route's ms on the same
    views."""
    import numpy as np

    from tscd_torch.models.aggregation import DualBranchAttention
    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.ops.kernels import library
    B = 1
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)   # noqa: E731
    score = t(rng.uniform(0, 1, (B, n)))
    fgs = t(rng.uniform(0.05, 1, (B, n))) if fg else None
    valid = torch.as_tensor(rng.uniform(size=(B, n)) > 0.2, device=dev)
    torch.manual_seed(0)
    att = DualBranchAttention(h * d, h, cross=False).to(dev)
    with torch.no_grad():
        views = att.project(t(rng.normal(size=(B, n, h * d))), t(rng.normal(size=(B, n, h * d))),
                            n)
    inputs = {"views": lambda: views,
              "random": lambda: [t(rng.normal(size=(B, h, n, d))) for _ in range(6)],
              "bf16": lambda: [v.to(torch.bfloat16) for v in views]}
    tag = f"fused_dual_attention (stream) q = k = {n}, d {d}{', fg' if fg else ''}"
    errs = {}
    for case in cases:
        a = (*inputs[case](), score, valid)
        got = fa.fused_dual_attention(*a, 25.0, fgs)
        want = fa.fused_dual_attention_plain(*a, 25.0, fgs)
        errs[case] = max(check_close(f"{tag}: {case} {part}", g, w, atol=1e-5, rtol=1e-4)
                         for part, g, w in zip(("out_cls", "out_reg", "attn"), got, want))
        del got, want, a
        free_card(torch)
    main = (*views, score, valid)
    nbytes = 4 * 6 * B * h * n * d + 4 * B * n * (2 if fg else 1) + B * n \
        + 4 * (2 * B * h * n * d + B * h * n * n)
    flops = B * h * 2 * 2 * 2 * n * n * d          # q.k of both branches, attn @ v_c, v_r
    b_ms, b_by = bound(nbytes, (3 * flops, H100_TF32_FLOPS))
    row = dict(max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
               **timed(torch, lambda: fa.fused_dual_attention(*main, 25.0, fgs), reps,
                       "fused_dual_attention_stream"),
               plain_ms=cuda_ms(torch, lambda: fa.fused_dual_attention_plain(*main, 25.0, fgs),
                                plain_reps, 1),
               bound_ms=b_ms, bound_by=b_by,
               bound_model="3 TF32 tensor-core products a product (3xTF32) at 495 TFLOP/s",
               fp32_fma_bound_ms=bound(nbytes, (flops, H100_FP32_FLOPS))[0],
               design_floor_ms=1.5 * 3 * flops / H100_TF32_FLOPS * 1e3,
               library_ms=None, route=fa.route(n), fg_score=fg,
               shape={"B": B, "h": h, "q": n, "k": n, "d": d},
               resources=stream_resources(torch, library.load(), B, h, n, d),
               scratch_bytes=4 * fa.scratch_floats(B, h, n, n, d),
               launch_bytes=fa.launch_bytes(B, h, n, n, d))
    if split:
        row["split_route"] = timed(torch, lambda: split_route(torch, (*main, fgs) if fg else main),
                                   reps, "fused_dual_attention_")
    return row


def yolov_backward_row(torch, dev, rng, h=4, n=480, d=64, reps=20):
    """The attention's backward (the plain recompute's VJP) at a 16-frame
    training window's q = k = 480: the six q/k/v gradients through the
    wrapper's autograd path (one kernel launch and one backward, counted)
    against autograd of the plain version (ATTN_BWD_TOL of each gradient's
    max), then timed as attention_backward_phase times it."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tscd_torch.ops.kernels import fused_attention as fa
    B = 1
    mk = lambda *sh: torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=dev)
    qkv = [mk(B, h, n, d) for _ in range(6)]
    score = torch.as_tensor(rng.uniform(0, 1, (B, n)).astype(np.float32), device=dev)
    valid = torch.as_tensor(rng.uniform(size=(B, n)) > 0.2, device=dev)
    cot = [mk(B, h, n, d), mk(B, h, n, d), mk(B, h, n, n)]
    ins = [t.clone().requires_grad_(True) for t in qkv]
    ref = [t.clone().requires_grad_(True) for t in qkv]
    n0, b0 = fa.fused_dual_attention.launches, fa.fused_dual_attention.backward_calls
    got = torch.autograd.grad(fa.fused_dual_attention(*ins, score, valid), ins, cot)
    if (fa.fused_dual_attention.launches - n0, fa.fused_dual_attention.backward_calls - b0) != (1, 1):
        raise AssertionError(f"attention at q = k = {n}: the autograd path did not launch the "
                             "kernel once and run its backward once")
    want = torch.autograd.grad(fa.fused_dual_attention_plain(*ref, score, valid), ref, cot)
    errs = {nm: float((g - w).abs().max() / w.abs().max())
            for nm, g, w in zip(("qc", "kc", "vc", "qr", "kr", "vr"), got, want)}
    ok = all(np.isfinite(v) and v <= ATTN_BWD_TOL for v in errs.values())
    emit({"phase": "kernels", "check": f"fused_dual_attention backward (B 1, h {h}, q = k = {n}, "
          f"d {d})", "max_rel_err": errs, "tolerance": f"{ATTN_BWD_TOL} of each gradient's max",
          "pass": ok})
    if not ok:
        raise AssertionError(f"attention backward at q = k = {n}: {errs}")
    outs = fa.fused_dual_attention(*ins, score, valid)
    bwd = lambda: torch.autograd.grad(outs, ins, cot, retain_graph=True)   # noqa: E731
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            bwd()
        torch.cuda.synchronize()
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                 and e.key != "Activity Buffer Request") / 1e3 / reps
    nbytes = 4 * (2 * 2 * B * h * n * d + 4 * B * h * n * d + B * n + B * h * n * n) + B * n
    b_ms, b_by = bound(nbytes, (B * h * 24 * n * n * d, H100_FP32_FLOPS))
    return dict(route="plain PyTorch recompute: autograd of fused_dual_attention_plain",
                replaces="tscd_tpu/ops/pallas/fused_attention.py:95-106 (_fused_bwd_rule: "
                         "XLA's VJP of dual_attention_reference, no Pallas kernel)",
                shape={"B": B, "h": h, "q": n, "k": n, "d": d}, max_rel_err=max(errs.values()),
                ms=dev_ms, call_ms=cuda_ms(torch, bwd, reps),
                plain_fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                    fa.fused_dual_attention_plain(*ref, score, valid), ref, cot), reps),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def yolov_phase(torch, counters):
    """The YOLOV family on the card: (a) card against CPU at the selftest
    size (YOLOV, YOLOV++ msa + decouple_reg, mca, localagg, TSCD's
    localagg); (b) yolov_l, v++_base_decoupleReg and v++_large windows,
    traced and timed; (c) vid_eval on the fixture's files; (d) training
    steps; (e) the kernels line's rows at the family's shapes: the
    attention at q = k = 960 (d 64 and 32) with its backward at q = k =
    480, on seeded random inputs and projections, and the NMS at the
    refined postprocess's (32, 900), on yolov_l's own window's inputs.
    Returns {"rows": ..., "launches": ...}."""
    from tscd_torch.ops.kernels import library
    from tscd_torch.ops.kernels import nms as kn
    import numpy as np
    t0 = time.time()
    yolov_small_part(torch)
    wins, calls = yolov_windows_part(torch, counters)
    yolov_eval_part(torch)
    yolov_train_part(torch)
    dev = card(torch)
    rng = np.random.default_rng(60)
    rows = {"fused_dual_attention_msa": stream_attention_row(torch, dev, rng, 4, 960, 64,
                                                             split=True),
            "fused_dual_attention_msa_d32": stream_attention_row(torch, dev, rng, 4, 960, 32,
                                                                 split=True)}
    rows["fused_dual_attention_msa"]["backward"] = yolov_backward_row(torch, dev, rng)
    lat, clock = latencies(torch, library.load()), sm_clock_mhz()
    exp = yolov_exp("yolov_l")
    F, K = exp.gframe_val, exp.num_proposals * exp.num_classes
    boxes_s, valid_s, thr = next(c for c in calls if tuple(c[0].shape[:2]) == (F, K))
    err, want = check_nms(torch, f"yolov_l refined postprocess ({F}, {K})", boxes_s, valid_s, thr)
    rows["nms_yolov_refined"] = dict(
        max_abs_err=err, **timed(torch, lambda: kn.nms_sorted(boxes_s, valid_s, thr), 100, "nms_"),
        plain_ms=cuda_ms(torch, lambda: kn.nms_sorted_plain(boxes_s, valid_s, thr), 3, 1),
        **nms_bounds(F, K, lat, clock), bound_by="operations", bound_model=NMS_BOUND,
        library_ms=None, kept=int(want.sum()), valid=int(valid_s.sum()))
    launches = {"fused_dual_attention_msa":
                    wins["yolov_l"]["launches"]["fused_dual_attention_stream"],
                "fused_dual_attention_msa_d32":
                    wins["v++_base_decoupleReg"]["launches"]["fused_dual_attention_stream"],
                "nms_yolov_refined": wins["yolov_l"]["launches"]["nms"]}
    bwd = rows["fused_dual_attention_msa"]["backward"]
    emit({"phase": "yolov", "seconds": time.time() - t0,
          "rows": {n: {k: v for k, v in r.items() if "ms" in k} for n, r in rows.items()},
          "backward_q_k_480": {k: v for k, v in bwd.items() if "ms" in k},
          "launches_in_3_traced_windows": launches})
    return {"rows": rows, "launches": launches}

STREAM_SHAPE = ("the online MSA (yolov_l online: 30 proposals + a bank of 31 x 30): B 1, h 4, "
                "q = k = 960, d 64, fp32, the reg logits fg-guided, on the joint projection's "
                "views")
# rows of the kernels line at OVIS YOLOV++'s shapes: {row: (its kernel's row, the shape)}
OVIS_PLUS_ROWS = {
    "fused_dual_attention_stream_16000": (
        "fused_dual_attention_stream", "ovis_v++_large_decoupleReg eval window self-attention "
        "(0 + 32 frames x 500 slots): B 1, h 4, q = k = 16000, d 64, fp32 (agg and agg_iou)"),
    "fused_dual_attention_stream_16000_d32": (
        "fused_dual_attention_stream", "ovis_v++_base_decoupleReg eval window self-attention: "
        "B 1, h 4, q = k = 16000, d 32, fp32 (agg and agg_iou)"),
    "fused_dual_attention_stream_8000_d32": (
        "fused_dual_attention_stream", "ovis_v++_base_decoupleReg training window (0 + 16 "
        "frames x 500 slots): B 1, h 4, q = k = 8000, d 32, fp32 (agg and agg_iou, forward)"),
    "nms_ovis_v++_refined": (
        "nms", "ovis_v++_base_decoupleReg postprocess_refined: 32 frames x K = 12500 (500 "
        "proposals x 25 classes, shifted), IoU 0.5, on the window's own inputs"),
}


def stream_edge_checks(torch, dev, rng):
    """The streaming route where masks decide: a batch of 2 at q = k = 300
    (ragged tiles), the first with every key invalid but one (all its
    rows' mass on that key), the second with every key invalid (uniform
    rows), against the plain version; and two calls bit-identical."""
    import numpy as np

    from tscd_torch.ops.kernels import fused_attention as fa
    n, h, d = 300, 2, 32
    t = lambda *sh: torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=dev)  # noqa
    args = [t(2, h, n, d) for _ in range(6)]
    score = torch.as_tensor(rng.uniform(0, 1, (2, n)).astype(np.float32), device=dev)
    fg = torch.as_tensor(rng.uniform(0.05, 1, (2, n)).astype(np.float32), device=dev)
    valid = torch.zeros(2, n, dtype=torch.bool, device=dev)
    valid[0, 17] = True
    got = fa.fused_dual_attention(*args, score, valid, 25.0, fg)
    again = fa.fused_dual_attention(*args, score, valid, 25.0, fg)
    want = fa.fused_dual_attention_plain(*args, score, valid, 25.0, fg)
    err = max(check_close(f"fused_dual_attention (stream) q = k = {n}: all keys invalid but "
                          f"one, and all invalid: {part}", g, w, atol=1e-5, rtol=1e-4)
              for part, g, w in zip(("out_cls", "out_reg", "attn"), got, want))
    mass = float((got[2][0, :, :, 17] - 1).abs().max())
    uniform = float((got[2][1] - 1.0 / n).abs().max())
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = mass <= 1e-6 and uniform <= 1e-8 and same
    emit({"phase": "kernels", "check": "fused_dual_attention (stream) masks and determinism",
          "max_abs_err": err, "one_valid_key_mass_err": mass, "all_invalid_uniform_err": uniform,
          "bit_identical_calls": same, "pass": ok})
    if not ok:
        raise AssertionError(f"streaming attention masks: {mass}, {uniform}, identical {same}")


def attention_stream_phase(torch, dev):
    """The `kernels` phase's rows of the attention's streaming route, each
    checked against the plain version first (`stream_attention_row`): the
    online MSA's q = k = 960, d 64 with fg (also in bf16; and d 32 with
    fg), and OVIS YOLOV++'s 8000 (d 32) and 16000 (d 64 and 32) on the
    joint projection's views, whose plain version needs about 5 x 4.1 GB;
    the mask and determinism checks. Returns the rows."""
    import numpy as np
    t0 = time.time()
    rng = np.random.default_rng(70)
    stream_edge_checks(torch, dev, rng)
    row = stream_attention_row(torch, dev, rng, 4, 960, 64, fg=True,
                               cases=("random", "views", "bf16"), split=True)
    row["d32_fg"] = stream_attention_row(torch, dev, rng, 4, 960, 32, fg=True, reps=20,
                                         cases=("random",))
    row["shape"] = STREAM_SHAPE
    rows = {"fused_dual_attention_stream": row}
    for name, n, d in (("fused_dual_attention_stream_8000_d32", 8000, 32),
                       ("fused_dual_attention_stream_16000", 16000, 64),
                       ("fused_dual_attention_stream_16000_d32", 16000, 32)):
        rows[name] = stream_attention_row(torch, dev, rng, 4, n, d, reps=3, plain_reps=1,
                                          cases=("views",))
        free_card(torch)
    emit({"phase": "kernels", "part": "attention_stream", "seconds": time.time() - t0,
          "rows": {n: {k: v for k, v in r.items() if "ms" in k} for n, r in rows.items()}})
    return rows


OVIS_PLUS_CONFIG = ("ovis_v++_base_decoupleReg / ovis_v++_large_decoupleReg: YOLOV++ (depth "
                    "0.33 / 1.0, width 0.5 / 1.0), 25 classes, 4 heads, msa + the decoupled obj "
                    "MSA, P = 500, eval windows of 0 + 32 frames at 576 px (the attention at q = "
                    "k = 16000), training windows of 0 + 16 (8000), fp32, seeded weights")
OVIS_PLUS_EXPS = ("ovis_v++_base_decoupleReg", "ovis_v++_large_decoupleReg")


def ovis_plus_small_part(torch):
    """(a) YOLOV++ msa + decouple_reg at the selftest size with P raised to
    40 (4 frames: q = k = 160, the streaming route on the card and the
    plain version on the CPU): `card_cpu_record`."""
    from tscd_torch.ops.kernels import fused_attention as fa
    exp = yolov_exp("yolov_selftest", model_family="yolov_plus", reconf=True, agg_type="msa",
                    decouple_reg=True, minimal_limit=40, maximal_limit=40)
    q = exp.num_proposals * (exp.lframe_val + exp.gframe_val)
    if fa.route(q) != "stream":
        raise AssertionError(f"q = {q} does not take the streaming route")
    rec = card_cpu_record(torch, "v++_msa_decoupleReg_P40", exp)
    emit({"phase": "ovis_yolov_plus", "part": "small", "config": "yolov_selftest as YOLOV++ msa "
          "+ decouple_reg, P = 40, 0 + 4 frames at 64 px", "attention_q": q, **rec,
          "tolerance": SMALL_TOLERANCE, "pass": True})


def ovis_plus_windows_part(torch, counters):
    """(b) Each exp's eval window (0 + 32 frames at 576 px, P = 500) at full
    width from seeded weights, uint8 frames: a warm-up (eager, then the
    window's graph captured), 2 graph replays traced (each window's stem,
    2 streaming attention launches at q = k = 16000 and its NMS walk from
    the device trace; the attention's grid), 3 back to back (window ms,
    frames/s, busy share), peak memory. The base exp's NMS inputs are kept
    from one eager window. Returns {exp: record} and those NMS calls."""
    import numpy as np

    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops import nms
    recs, calls = {}, []
    for name in OVIS_PLUS_EXPS:
        exp = yolov_exp(name)
        free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        model = random_init_(exp.get_model(device=card(torch)), exp.seed)
        pred = exp.get_predict_fn(model)
        t0 = time.time()
        run_windows(torch, pred, exp, 1, 100, True, uint8=True)          # warm-up, capture
        warm_s = time.time() - t0
        if name == "ovis_v++_base_decoupleReg":
            capture_window(torch, pred, exp, None, {(nms, "nms_sorted"): calls})
        F, P = exp.lframe_val + exp.gframe_val, model.head.num_proposals
        n = 2
        want = dict.fromkeys(TRACE_NAMES, 0)
        want.update(focus_stem=n, fused_dual_attention_stream=2 * n, nms=n)
        (dets, lat, _), launches, prof = traced_path(
            torch, counters, lambda: run_windows(torch, pred, exp, n, 60, True, uint8=True),
            n, 0, False, attempts=3, want=want)
        grids = sorted({tuple(k["grid"]) for k in trace_kernels(trace_events(
            prof, os.path.join(HERE, "build", f"trace_{name}.json")))
            if "fused_dual_attention_stream" in k["name"]})
        if grids != [stream_grid(torch, exp.heads, F * P)]:
            raise AssertionError(f"{name}: streaming attention grids {grids} at q = k = {F * P}")
        n_det = sum(len(r) for d in dets for r in pred.materialize(d)
                    if r.ndim == 2 and r.shape[1] == 7 and np.isfinite(r).all())
        loop = graph_loop(torch, pred, exp, None, n=3)
        loop["evaluated_frames_per_s"] = F * loop["windows"] / loop["wall_s"]
        recs[name] = {"config": OVIS_PLUS_CONFIG, "frames": F, "P": P, "attention_q": F * P,
                      "warm_up_and_capture_s": warm_s, "traced_window_ms": lat,
                      "launches": launches, "traces": traced_path.attempts,
                      "attention_grids": grids, "detections": n_det, **loop,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if n_det == 0:
            raise AssertionError(f"{name}: no detections")
        emit({"phase": "ovis_yolov_plus", "part": "window", "exp": name, **recs[name],
              "pass": True})
        del pred, model
        free_card(torch)
    return recs, calls


def ovis_plus_train_part(torch):
    """(c) Each exp's YOLOVTrainer step (fix_bn, frozen backbone, SimOTA,
    yolov_loss, grouped SGD, EMA) on a seeded 0 + 16 frame window at 576
    px: q = k = 8000, the attention's backward the plain recompute's VJP
    (JAX's rule). 1 warm-up and 2 timed steps (CUDA events), peak memory,
    the attention's forward launches and backward calls a step (2 and 2:
    agg and agg_iou). Returns {exp: record}."""
    import numpy as np

    from tscd_torch.ops.kernels import fused_attention as fa
    recs = {}
    for name in OVIS_PLUS_EXPS:
        exp = yolov_exp(name)
        free_card(torch)
        st = yolov_step_state(torch, exp, card(torch), 4, 5)
        window = [t.to(card(torch)) for t in yolov_train_window(torch, exp, 45, near=False)]
        b0, n0 = fa.fused_dual_attention.backward_calls, fa.fused_dual_attention.launches
        losses = {}
        ms, wall, peak = timed_steps(
            torch, lambda: losses.update(yolov_step(torch, st, exp, window)), 2, warmup=1)
        calls = ((fa.fused_dual_attention.launches - n0) / 3,
                 (fa.fused_dual_attention.backward_calls - b0) / 3)
        F = exp.lframe + exp.gframe
        rec = {"config": OVIS_PLUS_CONFIG, "exp": name, "frames": F,
               "attention_q": F * exp.num_proposals, "step_ms": ms,
               "frames_per_s": F * len(ms) / wall, "peak_mem_gb": peak,
               "attention_calls_a_step": {"forward": calls[0], "backward": calls[1]},
               "losses": {k: float(v) for k, v in losses.items()}}
        ok = calls == (2.0, 2.0) and all(np.isfinite(v) for v in rec["losses"].values())
        emit({"phase": "ovis_yolov_plus", "part": "train", **rec, "pass": ok})
        if not ok:
            raise AssertionError(f"{name} step: attention calls {calls}, losses {rec['losses']}")
        recs[name] = rec
        del st, window
        free_card(torch)
    return recs


def ovis_yolov_plus_phase(torch, counters):
    """OVIS YOLOV++ on the card, through the streaming attention: (a) card
    against CPU at the selftest size with P raised past the split route;
    (b) ovis_v++_base_decoupleReg and ovis_v++_large_decoupleReg eval
    windows; (c) their training steps; (d) the NMS at the refined
    postprocess's (32, 12500) on the base window's own inputs: one launch
    at 32 frames checked element by element against the plain version on
    the card, run in 2-frame chunks (its (B, K, K) intermediates at 32
    frames exceed the card), and timed at 32 and at 2. Returns {"rows",
    "launches"}."""
    from tscd_torch.ops.kernels import library
    from tscd_torch.ops.kernels import nms as kn
    t0 = time.time()
    ovis_plus_small_part(torch)
    wins, calls = ovis_plus_windows_part(torch, counters)
    steps = ovis_plus_train_part(torch)
    lat, clock = latencies(torch, library.load()), sm_clock_mhz()
    exp = yolov_exp("ovis_v++_base_decoupleReg")
    F, K = exp.gframe_val, exp.num_proposals * exp.num_classes
    boxes_s, valid_s, thr = next(c for c in calls if tuple(c[0].shape[:2]) == (F, K))
    two = (boxes_s[:2].contiguous(), valid_s[:2].contiguous())
    got = kn.nms_sorted(boxes_s, valid_s, thr)
    want = torch.cat([kn.nms_sorted_plain(boxes_s[i:i + 2].contiguous(),
                                          valid_s[i:i + 2].contiguous(), thr)
                      for i in range(0, F, 2)])
    diff = int((got != want).sum())
    emit({"phase": "kernels", "check": f"nms ovis_v++ refined postprocess ({F}, {K}), the "
          "plain version in 2-frame chunks", "max_abs_err": diff, "compared": want.numel(),
          "kept": int(want.sum()), "tolerance": "elementwise equal",
          "pass": diff == 0 and want.shape == got.shape})
    if diff or want.shape != got.shape:
        raise AssertionError(f"nms at ({F}, {K}): {diff} boxes differ from the plain version")
    rows = {"nms_ovis_v++_refined": dict(
        max_abs_err=diff, **timed(torch, lambda: kn.nms_sorted(boxes_s, valid_s, thr), 20, "nms_"),
        plain_ms_2_frames=cuda_ms(torch, lambda: kn.nms_sorted_plain(*two, thr), 2, 1),
        ms_2_frames=timed(torch, lambda: kn.nms_sorted(*two, thr), 20, "nms_")["ms"],
        **nms_bounds(F, K, lat, clock), bound_by="operations", bound_model=NMS_BOUND,
        library_ms=None, kept=int(kn.nms_sorted(boxes_s, valid_s, thr).sum()),
        valid=int(valid_s.sum()))}
    rows["nms_ovis_v++_refined"]["plain_ms"] = rows["nms_ovis_v++_refined"]["plain_ms_2_frames"]
    n_traced = 2
    launches = {"fused_dual_attention_stream_16000":
                    wins["ovis_v++_large_decoupleReg"]["launches"]["fused_dual_attention_stream"],
                "fused_dual_attention_stream_16000_d32":
                    wins["ovis_v++_base_decoupleReg"]["launches"]["fused_dual_attention_stream"],
                "fused_dual_attention_stream_8000_d32":
                    int(steps["ovis_v++_base_decoupleReg"]["attention_calls_a_step"]["forward"]),
                "nms_ovis_v++_refined": wins["ovis_v++_base_decoupleReg"]["launches"]["nms"]}
    emit({"phase": "ovis_yolov_plus", "seconds": time.time() - t0,
          "windows_ms": {n: w["window_ms"] for n, w in wins.items()},
          "steps_ms": {n: r["step_ms"] for n, r in steps.items()},
          "peak_mem_gb": {**{f"{n} window": w["peak_mem_gb"] for n, w in wins.items()},
                          **{f"{n} step": r["peak_mem_gb"] for n, r in steps.items()}},
          "launches_in_traced_windows": {"windows": n_traced, **launches},
          "nms_row": {k: v for k, v in rows["nms_ovis_v++_refined"].items() if "ms" in k}})
    return {"rows": rows, "launches": launches}


ONLINE_CONFIG = ("yolov_l online: YOLOVOnline (depth 1.0, width 1.0), 30 classes, 4 heads, P = "
                 "30 (minimal_limit), a bank of 31 frames x 30 (the MSA at q = k = 960), one "
                 "frame at 576 px a step, fp32, seeded weights")
ONLINE_SMALL_FRAMES = 96       # > 3 x the bank's 31 frames: both rings wrap
ONLINE_FRAMES = 64
ONLINE_K = 4


def moving_frames(rng, n, H, W):
    """n uint8 frames of a seeded scene shifted a pixel a frame, plus
    noise: neighbouring frames' proposals overlap, so the local merge
    works on real rows."""
    import numpy as np
    base = rng.uniform(0, 255, (H, W + n, 3))
    return np.stack([base[:, f:f + W] + rng.normal(0, 4, (H, W, 3))
                     for f in range(n)]).clip(0, 255).astype(np.uint8)


def bank_errors(torch, got, want):
    """Each bank field's distance: floats 1e-4 of the largest (relative
    to max(1, |largest|)), the rest exactly (1 where they differ)."""
    out = {}
    for name, g, w in zip(want._fields, got, want):
        g = g.cpu()
        if w.is_floating_point():
            out[name] = float((g.double() - w.double()).abs().max()) / max(
                1.0, float(w.abs().max()))
        else:
            out[name] = float(not torch.equal(g, w))
    return out


def online_small_part(torch):
    """(a) The online path at the selftest size (yolov_selftest: depth
    0.33, width 0.125, P = 8, 64 px) with the demo's bank of 31 frames (q
    = k = 256: the streaming route), from one seeded state: ONLINE_SMALL_
    FRAMES moving frames through the card's OnlineStream (CUDA graph
    replays after the first step) and the CPU's (eager), frame by frame:
    the detections as sets (boxes 1e-4 of the frame's largest coordinate,
    scores 1e-4, classes exactly), use_refined and every bank field (1e-4
    of the largest; pointers, counts and masks exactly)."""
    import numpy as np

    from tscd_torch.core.online import OnlineStream
    from tscd_torch.core.predict import detection_rows
    from tscd_torch.models.tscd import random_init_
    exp = yolov_exp("yolov_selftest")
    sd = random_init_(exp.get_online_model(device="cpu"), exp.seed).state_dict()
    frames = moving_frames(np.random.default_rng(90), ONLINE_SMALL_FRAMES, *exp.test_size)
    def stream(dev):
        model = exp.get_online_model(device=dev)
        model.load_state_dict(sd)
        return OnlineStream(model, bank_frames=31)
    cpu, gpu = stream("cpu"), stream(card(torch))
    worst, n_det, bank_worst = 0.0, 0, {}
    for f, x in enumerate(frames):
        (want, use_want), (got, use_got) = cpu.step(x), gpu.step(x)
        if bool(use_got) != bool(use_want) or bool(use_want) != (f >= 2):
            raise AssertionError(f"frame {f}: use_refined {bool(use_got)} on the card, "
                                 f"{bool(use_want)} on the CPU")
        w, n = match_rows([detection_rows(got)], [detection_rows(want)], 1e-4, 1e-4,
                          box_share=1e-4)
        worst, n_det = max(worst, w), n_det + n
        errs = bank_errors(torch, gpu.bank, cpu.bank)
        bad = {k: v for k, v in errs.items() if v > 1e-4}
        if bad:
            raise AssertionError(f"frame {f}: bank fields {bad} on the card from the CPU's")
        bank_worst = {k: max(v, bank_worst.get(k, 0.0)) for k, v in errs.items()}
    q = exp.minimal_limit * 32
    rec = {"config": "yolov_selftest online: 64 px, P = 8, bank 31 frames", "frames":
           len(frames), "attention_q": q, "graphs": len(gpu._graphs), "detections": n_det,
           "detections_max_abs_err": worst, "bank_max_err_of_largest": bank_worst,
           "ring_wraps": {"main": len(frames) // 31, "local": (len(frames) - 2) // 31},
           "tolerance": {"detections": "boxes 1e-4 of the frame's largest coordinate, "
                                       "scores atol 1e-4, all rtol 1e-4, classes exactly",
                         "bank": "floats 1e-4 of the largest, the rest exact"}, "pass": True}
    emit({"phase": "yolov_online", "part": "small", **rec})


def online_latency_part(torch, counters):
    """(b) yolov_l online at 576 px, a bank of 31 x 30, seeded weights:
    4 warm-up steps (the first eager, then captured; the bank past the
    two-frame gate), then ONLINE_FRAMES seeded uint8 frames from pinned
    host memory, one at a time: per-frame latency, frame in -> detections
    on the host (bench_latency's serial mode: each step's rows read back
    before the next frame; p50, p99); pipelined ms a frame (frame i + 1
    dispatched before frame i's rows are read) with the card's busy share
    (CUDA events around each step over the loop's wall time); 4 steps
    traced (each frame's stem, streaming attention and 3 NMS walks: the
    pre-NMS and both postprocess calls, from the device trace; none
    counted by a wrapper); then ONLINE_K-frame windows through
    window_step: ms a window (CUDA events), frames/s, and equality with
    ONLINE_K single steps from the same bank (detections as sets as in
    (a), the bank 1e-4 of its largest). Returns the record."""
    import numpy as np

    from tscd_torch.core.online import OnlineStream
    from tscd_torch.core.predict import detection_rows
    from tscd_torch.models.tscd import random_init_
    exp = yolov_exp("yolov_l")
    dev = card(torch)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    model = random_init_(exp.get_online_model(device=dev), exp.seed)
    rng = np.random.default_rng(91)
    frames = [torch.from_numpy(f).pin_memory()
              for f in moving_frames(rng, ONLINE_FRAMES + 8, *exp.test_size)]
    stream = OnlineStream(model, bank_frames=31)
    for x in frames[:4]:
        stream.step(x)
    torch.cuda.synchronize()
    lat, n_det = [], 0
    for x in frames[4:4 + ONLINE_FRAMES]:
        t0 = time.perf_counter()
        dets, _ = stream.step(x)
        rows = detection_rows(dets)
        lat.append((time.perf_counter() - t0) * 1e3)
        n_det += len(rows[0])
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(ONLINE_FRAMES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prev = None
    for x, (a, b) in zip(frames[4:4 + ONLINE_FRAMES], evs):
        a.record()
        dets, _ = stream.step(x)
        b.record()
        if prev is not None:
            detection_rows(prev)
        prev = dets
    detection_rows(prev)
    wall = time.perf_counter() - t0
    spans = [a.elapsed_time(b) for a, b in evs]
    n = 4
    want = dict.fromkeys(TRACE_NAMES, 0)
    want.update(focus_stem=n, fused_dual_attention_stream=n, nms=3 * n)
    _, launches, _ = traced_path(torch, counters, lambda: [stream.step(x) for x in frames[:n]],
                                 n, 0, False, attempts=3, want=want)
    # K-frame windows against single steps from the same (empty) bank
    singles = OnlineStream(model, bank_frames=31)
    windows = OnlineStream(model, bank_frames=31, batch=ONLINE_K)
    worst, compared = 0.0, 0
    for w in range(2):
        xs = frames[ONLINE_K * w:ONLINE_K * (w + 1)]
        one = [detection_rows(singles.step(x)[0])[0] for x in xs]
        dets, use = windows.window_step(torch.stack(xs))
        err, k = match_rows([detection_rows(dets)], [one], 1e-4, 1e-4, box_share=1e-4)
        worst, compared = max(worst, err), compared + k
    bank_err = bank_errors(torch, windows.bank, type(singles.bank)(*(t.cpu() for t in singles.bank)))
    if any(v > 1e-4 for v in bank_err.values()):
        raise AssertionError(f"window_step's bank {bank_err} from {ONLINE_K} single steps'")
    xs = torch.stack(frames[:ONLINE_K])
    win_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ONLINE_FRAMES // ONLINE_K):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        windows.window_step(xs)
        b.record()
        win_ms.append((a, b))
    torch.cuda.synchronize()
    win_wall = time.perf_counter() - t0
    rec = {"config": ONLINE_CONFIG, "frames": ONLINE_FRAMES, "detections": n_det,
           "latency_ms": lat, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "fps_serial": 1e3 / float(np.mean(lat)),
           "pipelined_ms_a_frame": wall / ONLINE_FRAMES * 1e3,
           "fps_pipelined": ONLINE_FRAMES / wall, "step_ms": spans,
           "device_busy_share": sum(spans) / 1e3 / wall,
           "launches_in_4_traced_frames": launches, "traces": traced_path.attempts,
           f"window_K{ONLINE_K}": {
               "window_ms": [a.elapsed_time(b) for a, b in win_ms],
               "frames_per_s": ONLINE_K * len(win_ms) / win_wall,
               "equal_to_single_steps": {"detections_compared": compared,
                                         "detections_max_abs_err": worst,
                                         "bank_max_err_of_largest": bank_err}},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if n_det == 0:
        raise AssertionError("yolov_l online: no detections")
    emit({"phase": "yolov_online", "part": "latency", **rec, "pass": True})
    del stream, singles, windows, model
    free_card(torch)
    return rec


def yolov_online_phase(torch, counters):
    """The online YOLOV path on the card: (a) card graph replays against
    the CPU's eager stream at the selftest size; (b) yolov_l online at
    576 px: per-frame latency, pipelined ms, busy share, launches a frame,
    K-frame windows. Returns {"rows": {}, "launches"}: the streaming
    attention row's launches in the 4 traced frames."""
    t0 = time.time()
    online_small_part(torch)
    rec = online_latency_part(torch, counters)
    emit({"phase": "yolov_online", "seconds": time.time() - t0, "p50_ms": rec["p50_ms"],
          "p99_ms": rec["p99_ms"], "pipelined_ms_a_frame": rec["pipelined_ms_a_frame"]})
    return {"rows": {}, "launches": {
        "fused_dual_attention_stream":
            rec["launches_in_4_traced_frames"]["fused_dual_attention_stream"]}}


# the demo tools at full width (tscd_torch/tools): TSCD-Large and yolov_l
# on the 32 frames of the 720p VID fixture, yolox_l on one of them
DEMO_FRAMES = os.path.join(HERE, "tscd_torch", "data", "fixtures", "vid", "Data", "VID",
                           "val", "fix0")
DEMO_SMALL_FRAMES = 8
DEMO_ONLINE_K = 3      # 32 frames: 10 full batches and a tail of 2
DEMO_CONF = 0.001     # the exps' test_conf: random weights score low
DEMO_EXPS = {"tscd_demo": "tscd_large", "vid_demo": "yolov_l",
             "yolov_demo_online": "yolov_l", "demo": "yolox_l"}


def demo_checkpoint(exp, online=False):
    """Seeded random weights of the exp's model (its online model where
    `online`), written as a JAX-layout msgpack under build/demo_phase;
    returns the path (the seconds it took on `demo_checkpoint.seconds`)."""
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.checkpoint import save_checkpoint
    t0 = time.perf_counter()
    build = exp.get_online_model if online else exp.get_model
    model = random_init_(build(device="cpu"), exp.seed if exp.seed is not None else 0)
    name = f"{exp.exp_name}{'_online' if online else ''}.msgpack"
    path = save_checkpoint({"model": model.state_dict()},
                           os.path.join(HERE, "build", "demo_phase"), name=name)
    demo_checkpoint.seconds = time.perf_counter() - t0
    return path


def demo_frames_dir(n):
    """A directory of the fixture's first n frames."""
    import shutil
    out = os.path.join(HERE, "build", "demo_phase", f"frames{n}")
    os.makedirs(out, exist_ok=True)
    for f in sorted(os.listdir(DEMO_FRAMES))[:n]:
        shutil.copyfile(os.path.join(DEMO_FRAMES, f), os.path.join(out, f))
    return out


def check_mp4(res, n):
    """The tool's .mp4 parses through the port's reader: MJPEG in an mp4v
    entry, one sample a frame, each decoding to the frame's size, the first
    equal to the encoder's bytes of the first frame drawn."""
    from tscd_torch.data.image import imdecode, imencode_jpeg
    from tscd_torch.utils.video import read_mp4
    m = read_mp4(res["path"])
    if (m["codec"], m["object_type"], len(m["samples"])) != ("mp4v", 0x6C, n):
        raise AssertionError(f"{res['path']}: {m['codec']} {m['object_type']} with "
                             f"{len(m['samples'])} samples for {n} frames")
    for s, f in zip(m["samples"], res["frames"]):
        if imdecode(s).shape != f.shape:
            raise AssertionError(f"{res['path']}: a sample of {imdecode(s).shape}, "
                                 f"frame {f.shape}")
    if m["samples"][0] != imencode_jpeg(res["frames"][0]):
        raise AssertionError(f"{res['path']}: the first sample is not the first frame's JPEG")
    return {"samples": len(m["samples"]), "fps": m["fps"], "size": [m["width"], m["height"]],
            "bytes": sum(len(s) for s in m["samples"])}


def demo_traced(torch, counters, run, kernels):
    """run() under torch.profiler, every wrapper's count at 0 before:
    (its result, each kernel's launches in the device trace, the wrappers'
    eager counts). Raises where one of `kernels` was not launched. The
    seconds of the traced run and of the counting go on
    `demo_traced.seconds`."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with traced(torch) as prof:
        res = run()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = trace_launches(prof)
    demo_traced.seconds = {"traced_run_s": t1 - t0, "count_s": time.perf_counter() - t1}
    wrapped = {name: c.launches for name, c in counters.items()}
    missing = [k for k in kernels if not launches[k]]
    if missing:
        raise AssertionError(f"kernels {missing} not launched: trace {launches}, "
                             f"wrappers {wrapped}")
    return res, {k: launches[k] for k in kernels}, wrapped


def demo_small_part(torch):
    """tscd_demo at the selftest size on 8 fixture frames, traj_linking and
    --post on: the CPU's plain versions against the card's kernels, the
    detections handed to vis matched as sets within the `small` phase's
    tolerance."""
    from tscd_torch.exp import get_exp
    from tscd_torch.tools import tscd_demo
    exp = get_exp(exp_name="selftest")
    ckpt = demo_checkpoint(exp)
    frames = demo_frames_dir(DEMO_SMALL_FRAMES)
    out = {}
    for dev in ("cpu", str(card(torch))):
        out[dev] = tscd_demo.main([
            "--exp", "selftest", "-c", ckpt, "--path", frames, "--device", dev, "--post",
            "--conf", str(DEMO_CONF), "--output_dir",
            os.path.join(HERE, "build", "demo_phase", f"small_{dev}"), "traj_linking", "True"])
    atol = rtol = 1e-4
    worst, n = match_rows([out["cpu"]["dets"]], [out[str(card(torch))]["dets"]], atol, rtol)
    emit({"phase": "demo", "part": "small", "tool": "tscd_demo", "exp": "selftest",
          "frames": DEMO_SMALL_FRAMES, "traj_linking": True, "post": True, "detections": n,
          "max_abs_err": worst, "tolerance": {"atol": atol, "rtol": rtol},
          "mp4": check_mp4(out[str(card(torch))], DEMO_SMALL_FRAMES), "pass": True})


def demo_phase(torch, counters):
    """The four demo tools on the card at full width from seeded random
    weights written as JAX-layout msgpack checkpoints: tscd_demo
    (TSCD-Large, 1 + 31, over the 32 fixture frames), vid_demo (yolov_l,
    0 + 32), yolov_demo_online (yolov_l, --online-batch 1 and 3, the 3 one
    with a tail of 2) and demo image (yolox_l, one frame), each traced: the
    stem, the attention, the solver (TSCD) and the NMS launched; the .mp4
    parsed; the online tool's detections equal to OnlineStream's on the same
    frames in the same batches. Each tool prints its ms a frame."""
    import numpy as np

    from tscd_torch.core.online import OnlineStream
    from tscd_torch.core.predict import detection_rows
    from tscd_torch.data.image import imdecode, imencode_jpeg
    from tscd_torch.data.transforms import letterbox
    from tscd_torch.exp import get_exp
    from tscd_torch.tools import demo, tscd_demo, vid_demo, yolov_demo_online
    from tscd_torch.tools.tscd_eval import load_weights
    from tscd_torch.utils.video import read_frames
    t_phase = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()
    card_name = smi[0] if smi else "not read"
    demo_small_part(torch)
    dev = str(card(torch))
    n = len(os.listdir(DEMO_FRAMES))
    out_dir = os.path.join(HERE, "build", "demo_phase")
    common = ["--path", DEMO_FRAMES, "--device", dev, "--conf", str(DEMO_CONF)]
    records = {}

    def record(tool, exp_name, res, launches, wrapped, extra=None):
        if not res["drawn"]:
            raise AssertionError(f"{tool}: no box drawn at --conf {DEMO_CONF}")
        rec = {"phase": "demo", "tool": tool, "exp": exp_name, "frames": n,
               "ms_per_frame": res["ms_per_frame"], "boxes_drawn": res["drawn"],
               "launches": launches, "wrapper_launches": wrapped,
               "mp4": check_mp4(res, len(res["frames"])), "card": card_name,
               "checkpoint_s": demo_checkpoint.seconds, **demo_traced.seconds,
               **(extra or {}), "pass": True}
        emit(rec)
        records[tool if "online_batch" not in (extra or {})
                else f"{tool}_K{extra['online_batch']}"] = rec["ms_per_frame"]

    free_card(torch)
    name = DEMO_EXPS["tscd_demo"]
    ckpt = demo_checkpoint(get_exp(exp_name=name))
    res, launches, wrapped = demo_traced(torch, counters, lambda: tscd_demo.main(
        ["--exp", name, "-c", ckpt, "--output_dir", os.path.join(out_dir, "tscd"), *common]),
        ("focus_stem", "fused_dual_attention", "hungarian", "nms"))
    record("tscd_demo", name, res, launches, wrapped)
    del res
    free_card(torch)

    name = DEMO_EXPS["vid_demo"]
    ckpt = demo_checkpoint(get_exp(exp_name=name))
    res, launches, wrapped = demo_traced(torch, counters, lambda: vid_demo.main(
        ["--exp", name, "-c", ckpt, "--output_dir", os.path.join(out_dir, "vid"), *common]),
        ("focus_stem", "fused_dual_attention_stream", "nms"))
    record("vid_demo", name, res, launches, wrapped)
    del res
    free_card(torch)

    name = DEMO_EXPS["yolov_demo_online"]
    exp = get_exp(exp_name=name)
    ckpt = demo_checkpoint(exp, online=True)
    letterboxed = [letterbox(f, exp.test_size, dtype=np.uint8)[0]
                   for f in read_frames(DEMO_FRAMES)]
    for K in (1, DEMO_ONLINE_K):
        res, launches, wrapped = demo_traced(torch, counters, lambda: yolov_demo_online.main(
            ["--exp", name, "-c", ckpt, "--online-batch", str(K), "--max-wait-ms", "1e9",
             "--output_dir", os.path.join(out_dir, f"online{K}"), *common]),
            ("focus_stem", "fused_dual_attention_stream", "nms"))
        want_batches = [K] * (n // K) + ([n % K] if n % K else [])
        if res["batches"] != want_batches:
            raise AssertionError(f"online K={K}: batches {res['batches']}, "
                                 f"want {want_batches}")
        model = exp.get_online_model(device=dev)
        load_weights(model, ckpt)
        stream = OnlineStream(model, bank_frames=31, batch=K)
        want, i = [], 0
        for b in res["batches"]:
            want += [detection_rows(d)[0] for d in stream.run_batch(letterboxed[i:i + b])]
            i += b
        worst, compared = match_rows([res["dets"]], [want], 1e-4, 1e-4, box_share=1e-4)
        record("yolov_demo_online", name, res, launches, wrapped, {
            "online_batch": K, "batches": res["batches"],
            "equal_to_online_stream": {"detections_compared": compared,
                                       "detections_max_abs_err": worst,
                                       "tolerance": "boxes 1e-4 of the frame's largest "
                                                    "coordinate, scores atol 1e-4, rtol "
                                                    "1e-4, classes exactly"}})
        del res, model, stream
        free_card(torch)

    name = DEMO_EXPS["demo"]
    exp = get_exp(exp_name=name)
    ckpt = demo_checkpoint(exp)
    frame = os.path.join(DEMO_FRAMES, sorted(os.listdir(DEMO_FRAMES))[0])
    still_out = os.path.join(out_dir, "still")
    res, launches, wrapped = demo_traced(torch, counters, lambda: demo.main(
        ["image", "-n", name, "-c", ckpt, "--path", frame, "--device", dev, "--save_result",
         "--conf", str(DEMO_CONF), "output_dir", still_out]),
        ("focus_stem", "nms"))
    (_, drawn, boxes, _, _, ms), = res
    saved = os.path.join(still_out, name, "vis_res", os.path.basename(frame))
    with open(saved, "rb") as f:
        data = f.read()
    if data != imencode_jpeg(drawn) or imdecode(data).shape != drawn.shape:
        raise AssertionError(f"{saved} is not the drawn image's JPEG")
    if not len(boxes):
        raise AssertionError(f"demo image: no box at --conf {DEMO_CONF}")
    rec = {"phase": "demo", "tool": "demo image", "exp": name, "frames": 1,
           "ms_per_frame": ms, "boxes_drawn": len(boxes), "launches": launches,
           "wrapper_launches": wrapped, "saved_bytes": len(data), "card": card_name,
           "checkpoint_s": demo_checkpoint.seconds, **demo_traced.seconds, "pass": True}
    emit(rec)
    records["demo_image"] = ms
    emit({"phase": "demo", "seconds": time.time() - t_phase, "ms_per_frame": records,
          "card": card_name})
    free_card(torch)
    return {"rows": {}, "launches": {}}


BACKBONE_LOOP = 4         # replays back to back, untraced, after HEAD_WINDOWS traced
# the full-width runs: (exp, backbone_name, dtype); the hand kernels each
# window launches (TRACE_NAMES rows; Swin and FocalNet have no Focus stem)
BACKBONE_RUNS = (("tscd_large", "Swin_Base", "fp32"), ("tscd_large", "Swin_Base", "bf16"),
                 ("tscd_large", "Focal", "fp32"), ("yolov_l", "Swin_Tiny", "fp32"))
BACKBONE_LAUNCHES = {
    ("tscd_large", "fp32"): {"fused_dual_attention": 2, "hungarian": 1, "nms": 2},
    ("tscd_large", "bf16"): {"fused_dual_attention_bf16": 2, "hungarian": 1, "nms": 2},
    ("yolov_l", "fp32"): {"fused_dual_attention_stream": 1, "nms": 2}}
BACKBONE_SMALL_TOL = {"atol": 1e-4, "rtol": 1e-4}


def backbone_small_part(torch):
    """At the selftest sizes, each model from the same seeded weights on
    the card machine's CPU (plain versions) and on the card (kernels), two
    windows with the state carried: TSCD (selftest) on Swin_Tiny and on
    Focal, YOLOV (yolov_selftest) on Swin_Tiny, detections matched as sets
    within the `small` phase's tolerance; YOLOPAFPNP6 (depth 0.33, width
    0.125, 128 px) and YOLOPAFPN_ResNet (ResNet-50, 64 px) on their
    features, 1e-4 of each map's largest."""
    import numpy as np

    from tscd_torch.exp import get_exp
    from tscd_torch.models.pafpn_p6 import YOLOPAFPNP6
    from tscd_torch.models.pafpn_variants import YOLOPAFPN_ResNet
    from tscd_torch.models.tscd import random_init_
    recs = {}
    for name, bb in (("selftest", "Swin_Tiny"), ("selftest", "Focal"),
                     ("yolov_selftest", "Swin_Tiny")):
        exp = exp_with(get_exp(exp_name=name), backbone_name=bb)
        out = {}
        for dev in ("cpu", card(torch)):
            model = random_init_(exp.get_model(device=dev), exp.seed)
            pred = exp.get_predict_fn(model)
            dets, _, _ = run_windows(torch, pred, exp, 2, 5, False, uint8=True)
            out[str(dev)] = [pred.materialize(d) for d in dets]
        worst, n = match_rows(out["cpu"], out[str(card(torch))], **BACKBONE_SMALL_TOL)
        recs[f"{name}_{bb}"] = {"windows": 2, "detections": n, "max_abs_err": worst}
    for name, make, size in (("YOLOPAFPNP6", lambda: YOLOPAFPNP6(0.33, 0.125), 128),
                             ("YOLOPAFPN_ResNet", lambda: YOLOPAFPN_ResNet(
                                 50, depth=0.33, width=0.25), 64)):
        cpu = random_init_(make(), 3).eval()
        dev = make().to(card(torch)).eval()
        dev.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(np.random.default_rng(4).uniform(0, 255, (2, size, size, 3))
                             .astype(np.float32))
        with torch.no_grad():
            want, got = cpu(x), [t.cpu() for t in dev(x.to(card(torch)))]
        share = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
        if share > 1e-4:
            raise AssertionError(f"{name}: card against CPU {share} of the largest")
        recs[name] = {"maps": [list(w.shape) for w in want], "max_err_share": share}
    emit({"phase": "backbones", "part": "small", "configs": recs,
          "tolerance": {**BACKBONE_SMALL_TOL, "features": "1e-4 of each map's largest"},
          "pass": True})


def bf16_check_window(torch, exp):
    """A window of `exp`'s frames (seeded uint8) and its time embedding on
    the card: the fp32 and bf16 runs' raw outputs on it are compared."""
    import numpy as np

    from tscd_torch.ops.position import get_timing_signal_1d
    F, (H, W) = exp.lframe_val + exp.gframe_val, exp.test_size
    rng = np.random.default_rng(41)
    return (torch.as_tensor(rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8),
                            device=card(torch)),
            torch.as_tensor(get_timing_signal_1d(np.arange(F)), device=card(torch)))


def network_maps(net, x):
    """The backbone network's dark3/dark4/dark5 maps of frames `x`, as
    fp32 numpy arrays."""
    return [net(x)[k].float().cpu().numpy() for k in ("dark3", "dark4", "dark5")]


def network_bf16_check(torch, exp, sd32, net16, x, feats32):
    """The bf16 network's maps (`net16`, on the card) of frames `x` against
    the same network at bf16 on the card machine's CPU (plain torch, held
    to JAX's bf16 Swin by tests/test_torch_port_backbones.py) from the
    fp32 weights `sd32`, and against the fp32 run's maps `feats32`: the
    card's distance from fp32 and from the CPU's bf16 each within
    BF16_SPREAD x the CPU's own distance from fp32 (max and p99.9, each
    map)."""
    from tscd_torch.models.pafpn_variants import build_pafpn_backbone
    pre = "backbone.backbone."
    t0 = time.time()
    cpu = build_pafpn_backbone(exp.backbone_name, exp.depth, exp.width,
                               dtype=torch.bfloat16).backbone
    cpu.load_state_dict({k[len(pre):]: v.cpu() for k, v in sd32.items() if k.startswith(pre)})
    with torch.no_grad():
        ref, card = network_maps(cpu.eval(), x.cpu()), network_maps(net16, x)
    cpu_s = time.time() - t0
    maps, ok = {}, True
    for name, c, r, f in zip(("dark3", "dark4", "dark5"), card, ref, feats32):
        d = {"card_vs_fp32": distance(c, f), "cpu_vs_fp32": distance(r, f),
             "card_vs_cpu": distance(c, r)}
        limit = {k: BF16_SPREAD * v for k, v in d["cpu_vs_fp32"].items()}
        ok = ok and all(0 < v for v in limit.values()) and all(
            d[pair][k] <= limit[k] for pair in ("card_vs_fp32", "card_vs_cpu") for k in limit)
        maps[name] = {"distances": d, "limit": limit, "abs_fp32": distance(f, 0.0)}
    emit({"phase": "backbones", "check": "the bf16 network's maps, card against the CPU's "
          "bf16 port and the fp32 run, frames 0 and L", "exp": exp.exp_name,
          "backbone_name": exp.backbone_name, "maps": maps,
          "tolerance": f"card_vs_fp32 and card_vs_cpu <= {BF16_SPREAD} x cpu_vs_fp32",
          "cpu_s": cpu_s, "pass": ok})
    if not ok:
        raise AssertionError(f"bf16 network maps on the card: {maps}")


def backbone_window_run(torch, counters, exp, model, family, dtype):
    """`warm_predict`, HEAD_WINDOWS carried windows as graph replays traced
    (`replays`: each window's hand kernels from the device trace, the
    wrappers counting none), then BACKBONE_LOOP back to back untraced
    (`graph_loop`): window ms and spread, frames/s, busy share, peak
    memory."""
    import numpy as np
    want = dict.fromkeys(TRACE_NAMES, 0)
    want.update({k: v * HEAD_WINDOWS for k, v in BACKBONE_LAUNCHES[(family, dtype)].items()})
    torch.cuda.reset_peak_memory_stats()
    pred, state = warm_predict(torch, model, exp)
    rec, state = replays(torch, counters, pred, exp, state, dtype == "bf16", want=want)
    loop = graph_loop(torch, pred, exp, state, n=BACKBONE_LOOP)
    ms = loop["window_ms"]
    return {**rec, "traced_busy_share": rec["device_ms_a_window"] / float(np.mean(rec["window_ms"])),
            "loop": loop, "median_window_ms": float(np.median(ms)),
            "window_ms_spread": float(np.max(ms) - np.min(ms)),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def backbone_train_part(torch, exp):
    """One stage-2 step of `exp` (4 + 12 frames, fix_bn, its frozen
    backbone and stop_backbone_grad) after a warm-up step, timed: finite
    losses and every gradient the step sees finite."""
    import numpy as np

    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.step import init_train_state, train_step
    model = random_init_(exp.get_model(device=card(torch)), exp.seed)
    opt = exp.get_optimizer(model, 8)
    grads = capture_grads(opt, model)
    st = init_train_state(model, opt, exp.ema_decay)
    window = tuple(t.to(card(torch)) for t in train_window(torch, exp, 64))
    losses = []
    ms, wall, peak = timed_steps(torch, lambda: losses.append(train_step(
        st, *window, exp.lframe, exp.gframe, ota_mode=exp.ota_mode, fix_bn=exp.fix_bn)), 1, 1)
    host = {k: float(v) for k, v in losses[-1].items()}
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    ok = all(np.isfinite(v) for v in host.values()) and finite and len(grads) > 0
    rec = {"config": f"{exp.exp_name} stage 2 on {exp.backbone_name}, {exp.lframe}+{exp.gframe} "
           f"frames {exp.input_size[0]}px, fp32, fix_bn, frozen backbone", "step_ms": ms,
           "frames_per_s": (exp.lframe + exp.gframe) / wall, "peak_mem_gb": peak,
           "losses": host, "gradients": len(grads), "gradients_finite": finite}
    if not ok:
        raise AssertionError(f"backbones step: {rec}")
    return rec


def backbones_phase(torch, counters):
    """The other backbones (`backbone_name`): backbone_small_part, then at
    full width TSCD-Large (1 + 31 frames at 576 px, P = 50) on Swin_Base at
    fp32 and at bf16 (BN folded) and on Focal at fp32, yolov_l (0 + 32) on
    Swin_Tiny, each `backbone_window_run`; then one TSCD-Large stage-2 step
    on Swin_Base. The bf16 run's raw outputs on a window of seeded frames
    are held against the fp32 run's on the same frames, and against the
    bf16 port on the card machine's CPU, as phase `bf16` holds MCSP's
    (`cpu_reference`: BF16_SPREAD x the CPU's own distance from fp32), and
    so are its Swin network's maps (`network_bf16_check`).
    Returns each kernel's launches a window of each run."""
    from tscd_torch.exp import get_exp
    from tscd_torch.models.tscd import random_init_
    t_phase = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()
    card_name = smi[0] if smi else "not read"
    backbone_small_part(torch)
    per_window = {}
    sd32 = raw32 = None
    paired = {(name, bb) for name, bb, dtype in BACKBONE_RUNS if dtype == "bf16"}
    for name, bb, dtype in BACKBONE_RUNS:
        free_card(torch)
        exp = exp_with(get_exp(exp_name=name), backbone_name=bb)
        L, G = exp.lframe_val, exp.gframe_val
        if dtype == "fp32":
            model = random_init_(exp.get_model(device=card(torch)), exp.seed)
            sd32 = model.state_dict()
            if (name, bb) in paired:
                x, te = bf16_check_window(torch, exp)
                with torch.no_grad():
                    raw32 = model(x, te, L, G)["raw_outputs"].float().cpu().numpy()
                    feats32 = network_maps(model.backbone.backbone, x[[0, L]])
        else:                      # the fp32 run's weights, BN folded
            model = bf16_model(torch, exp, sd32, card(torch))
            with torch.no_grad():
                raw16 = model(x, te, L, G)["raw_outputs"]
            if raw16.dtype != torch.bfloat16 or tuple(raw16.shape) != raw32.shape:
                raise AssertionError(f"bf16 raw outputs {raw16.dtype} {tuple(raw16.shape)}")
            cpu_reference(torch, exp, sd32, x, te, raw16.float().cpu().numpy(), raw32,
                          phase="backbones")
            network_bf16_check(torch, exp, sd32, model.backbone.backbone, x[[0, L]], feats32)
            del x, te, raw16, feats32
        rec = backbone_window_run(torch, counters, exp, model, name, dtype)
        run = f"{name}_{bb}_{dtype}"
        per_window[run] = {k: v // HEAD_WINDOWS for k, v in rec["launches"].items() if v}
        emit({"phase": "backbones", "run": run, "exp": name, "backbone_name": bb,
              "dtype": dtype, "frames": exp.lframe_val + exp.gframe_val,
              "size": list(exp.test_size), "card": card_name, **rec, "pass": True})
        del model
    del sd32, raw32
    free_card(torch)
    exp = exp_with(get_exp(exp_name="tscd_large"), backbone_name="Swin_Base")
    emit({"phase": "backbones", "part": "train", **backbone_train_part(torch, exp),
          "card": card_name, "pass": True})
    free_card(torch)
    emit({"phase": "backbones", "seconds": time.time() - t_phase,
          "launches_a_window": per_window, "card": card_name})
    return per_window


# -- the rest of the detector zoo (YOLOv7, the P6 ELAN backbones, YOLOv8,
# the DETR decoder, the layer zoo) ------------------------------------------
ZOO_ROWS = {
    "focus_stem_p6_80": ("focus_stem", "ELANNet E6 / E6E stem: 2 x 1280 x 1280 fp32 frames "
                                       "-> 80 channels"),
    "focus_stem_p6_96": ("focus_stem", "ELANNet D6 stem: 2 x 1280 x 1280 fp32 frames -> 96 "
                                       "channels"),
    "focus_stem_bf16_p6_80": ("focus_stem_bf16", "ELANNet E6 stem at bf16: 2 x 1280 x 1280 "
                                                 "uint8 frames -> 80 channels"),
    "focus_stem_bf16_p6_96": ("focus_stem_bf16", "ELANNet D6 stem at bf16: 2 x 1280 x 1280 "
                                                 "uint8 frames -> 96 channels"),
    "hungarian_detr": ("hungarian", "DETR set criterion: a decoder layer's 100 x 100 cost "
                                    "(10 valid gts, 90 columns at big = 1e4), 6 a call"),
    "nms_dense_yolov7": ("nms", "YOLOv7-L postprocess_dense: B 8, K 2048, 80 classes "
                                "shifted, IoU 0.65"),
}
ZOO_P6 = (("W6", "fp32"), ("E6", "fp32"), ("D6", "fp32"), ("E6E", "fp32"), ("W6", "bf16"),
          ("E6", "bf16"), ("D6", "bf16"))
ZOO_STEM_ROW = {("E6", "fp32"): "focus_stem_p6_80", ("E6E", "fp32"): "focus_stem_p6_80",
                ("D6", "fp32"): "focus_stem_p6_96", ("E6", "bf16"): "focus_stem_bf16_p6_80",
                ("D6", "bf16"): "focus_stem_bf16_p6_96"}
ZOO_SMALL_TOL = "1e-4 of each output's largest (losses 1e-4 relative); matchings exact"
ZOO_REPS = 3
ZOO_DETECT = (8, 640)                 # frames, px: YOLOv7 and YOLOv8
ZOO_P6_INPUT = (2, 1280)              # frames, px: the P6 backbones and neck
ZOO_LAYER_INPUT = (8, 256, 80, 80)    # the layer zoo's map, NCHW


def anchors_at(size):
    return sum((size // s) ** 2 for s in (8, 16, 32))


def zoo_counted(torch, counters, run, want):
    """`run()` with every wrapper's count set to 0 just before and read
    just after: the launches of each hand kernel, which must equal
    `want` (kernel -> launches; the others 0)."""
    for c in counters.values():
        c.launches = 0
    out = run()
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    full = {k: want.get(k, 0) for k in counters}
    if got != full:
        raise AssertionError(f"launches {got} != {full}")
    return out, got


def zoo_window(torch, fn, reps=ZOO_REPS):
    """ms of each of `reps` calls (CUDA events, after one warm-up) and the
    peak device memory of a call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return {"ms": ms, "median_ms": sorted(ms)[len(ms) // 2],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def stem_bf16_row(torch, dev, rng, F, H, W, O):
    """The bf16 stem on F x H x W x 3 uint8 frames writing O channels
    against its plain version (BF16_TOL), then timed, with its bound and
    the folded bf16 F.conv2d's time."""
    import numpy as np
    import torch.nn.functional as Fn

    from tscd_torch.ops.kernels import focus_stem as fs
    bf = torch.bfloat16
    t = lambda a, dt=torch.float32: torch.as_tensor(a, device=dev).to(dt)   # noqa: E731
    w3 = t(rng.normal(0, 1 / np.sqrt(108), (O, 12, 3, 3)))
    scale = t(rng.uniform(0.5, 1.5, O))
    shift = t(rng.normal(0, 0.5, O))
    x8 = t(rng.integers(0, 256, (F, H, W, 3), dtype=np.uint8), torch.uint8)
    err = check_close(f"focus_stem bf16 ({F}, {H}, {W}, 3) uint8 -> {O}",
                      fs.focus_stem(x8, w3, scale, shift, out_dtype=bf),
                      fs.focus_stem_plain(x8, w3, scale, shift, bf), **BF16_TOL)
    nbytes = F * H * W * 3 + 2 * F * (H // 2) * (W // 2) * O + 4 * (w3.numel() + 2 * O)
    b_ms, b_by = bound(nbytes, (2 * F * (H // 2) * (W // 2) * O * 108, H100_BF16_FLOPS))
    xb, w6 = x8.to(bf).permute(0, 3, 1, 2), fs.rearrange_weight(w3, scale).to(bf)
    return dict(max_abs_err=err, tolerance=BF16_TOL,
                **timed(torch, lambda: fs.focus_stem(x8, w3, scale, shift, out_dtype=bf), 20,
                        "focus_stem"),
                plain_ms=cuda_ms(torch, lambda: fs.focus_stem_plain(x8, w3, scale, shift, bf),
                                 10),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=cuda_ms(torch, lambda: Fn.conv2d(xb, w6, shift.to(bf), stride=2,
                                                            padding=2), 20))


def zoo_frames(torch, seed, n, size, dev):
    import numpy as np
    return torch.as_tensor(np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                                dtype=np.uint8), device=dev)


def zoo_close(name, got, want):
    """got (on the card) within 1e-4 of want's (CPU) largest absolute value."""
    g, w = got.detach().float().cpu(), want.detach().float()
    err = float((g - w).abs().max())
    ok = tuple(g.shape) == tuple(w.shape) and err <= 1e-4 * float(w.abs().max())
    if not ok:
        raise AssertionError(f"zoo {name}: card against CPU {err} of {float(w.abs().max())}")
    return err


def zoo_detr_gts(torch, Q, C, n_valid, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, C, Q).astype(np.int32)),
            torch.as_tensor(rng.uniform(0.1, 0.9, (Q, 4)).astype(np.float32)),
            torch.as_tensor(np.arange(Q) < n_valid))


def zoo_v8_labels(rng, B, size, n_max=20, C=80):
    """(B, n_max, 5) zero-padded [cls, cx, cy, w, h] pixel rows, 5 to n_max
    boxes of 16-40% of the frame a frame."""
    import numpy as np
    lab = np.zeros((B, n_max, 5), np.float32)
    for b in range(B):
        n = int(rng.integers(5, n_max + 1))
        wh = rng.uniform(0.16, 0.4, (n, 2)) * size
        c = rng.uniform(wh / 2, size - wh / 2)
        lab[b, :n] = np.concatenate([rng.integers(0, C, (n, 1)), c, wh], -1)
    return lab


def zoo_small_part(torch):
    """Each zoo model at a small config from the same seeded weights on the
    card machine's CPU (plain versions) and on the card (kernels): YOLOv7-
    tiny (64 px, decoded), ELANNet W6 and E6E + their P6 neck (64 px),
    YOLOv8 (depth 0.33, width 0.25, 64 px: decoded, then the train-mode
    yolov8_loss parts), the DETR decoder (dim 32, 4 heads, 2 layers, 16
    queries: set_criterion's losses and each layer's col4row), DeformConv2d
    and CoordConv (2 x 6 x 8 x 8) and DropBlock under one seed mask."""
    import numpy as np

    from tscd_torch.models import custom_layers as cl
    from tscd_torch.models import decoder as dec
    from tscd_torch.models import elan
    from tscd_torch.models.build import create_model
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.v8_losses import yolov8_loss
    dev, recs = card(torch), {}

    def pair(make, seed):
        cpu = random_init_(make("cpu"), seed).eval()
        gpu = make(dev).eval()
        gpu.load_state_dict(cpu.state_dict())
        return cpu, gpu

    x = zoo_frames(torch, 70, 2, 64, "cpu")
    cpu, gpu = pair(lambda d: create_model("yolov7", num_classes=80, arch="tiny", device=d), 71)
    with torch.no_grad():
        recs["yolov7_tiny"] = zoo_close("yolov7_tiny", gpu(x.to(dev))["decoded"],
                                        cpu(x)["decoded"])
    for arch in ("W6", "E6E"):
        ch = elan.backbone_channels(arch)[-4:]
        make = lambda d: torch.nn.Sequential(  # noqa: E731
            elan.ELANNet(arch, (2, 3, 4, 5)), elan.ELANFPNP6(arch, ch)).to(d)
        cpu, gpu = pair(make, 72)
        with torch.no_grad():
            want = cpu[1](cpu[0](x))
            got = gpu[1](gpu[0](x.to(dev)))
        recs[f"elan_{arch}_p6"] = max(zoo_close(f"{arch} map {k}", g, w)
                                      for k, (g, w) in enumerate(zip(got, want)))
    cpu, gpu = pair(lambda d: create_model("yolov8", num_classes=80, depth=0.33, width=0.25,
                                           device=d), 73)
    lab = torch.as_tensor(zoo_v8_labels(np.random.default_rng(74), 2, 64))
    with torch.no_grad():
        recs["yolov8"] = zoo_close("yolov8", gpu(x.to(dev))["decoded"], cpu(x)["decoded"])
        lc = yolov8_loss(cpu(x, train=True, decode=False), lab)
        lg = yolov8_loss(gpu(x.to(dev), train=True, decode=False), lab.to(dev))
    for k in lc:
        if not abs(float(lg[k]) - float(lc[k])) <= 1e-4 * abs(float(lc[k])):
            raise AssertionError(f"zoo yolov8 {k}: card {float(lg[k])} CPU {float(lc[k])}")
    recs["yolov8_losses"] = {k: float(v) for k, v in lg.items()}
    torch.manual_seed(75)
    cpu, gpu = pair(lambda d: dec.TransformerDecoder(5, 32, 32, 4, 2, 16).to(d), 75)
    mem = torch.as_tensor(np.random.default_rng(76).normal(size=(40, 32)).astype(np.float32))
    gts = zoo_detr_gts(torch, 16, 5, 3, 77)
    cols = {}
    for name, m, d in (("cpu", cpu, "cpu"), ("card", gpu, dev)):
        with torch.no_grad():
            out = m(mem.to(d))
            cols[name] = [dec.hungarian_match(out["pred_logits"][i], out["pred_boxes"][i],
                                              *(t.to(d) for t in gts)).cpu()
                          for i in range(2)]
            cols[name + "_losses"] = {k: float(v) for k, v in dec.set_criterion(
                out, *(t.to(d) for t in gts), 5).items()}
    if not all(torch.equal(a, b) for a, b in zip(cols["cpu"], cols["card"])):
        raise AssertionError(f"zoo detr col4row: card {cols['card']} CPU {cols['cpu']}")
    for k, v in cols["cpu_losses"].items():
        if not abs(cols["card_losses"][k] - v) <= 1e-4 * abs(v):
            raise AssertionError(f"zoo detr {k}: card {cols['card_losses'][k]} CPU {v}")
    recs["detr"] = cols["card_losses"]
    xs = torch.as_tensor(np.random.default_rng(78).normal(size=(2, 6, 8, 8)).astype(np.float32))
    for name, make in (("deform_conv", lambda d: cl.DeformConv2d(6, 5).to(d)),
                       ("coord_conv", lambda d: cl.CoordConv(6, 5).to(d))):
        cpu, gpu = pair(make, 79)
        with torch.no_grad():
            recs[name] = zoo_close(name, gpu(xs.to(dev)), cpu(xs))
    db = cl.DropBlock(3, 0.8)
    seed = torch.rand(xs.shape, generator=torch.Generator().manual_seed(80)) < db.gamma(8, 8)
    recs["dropblock"] = zoo_close("dropblock", db.drop(xs.to(dev), seed.to(dev)),
                                  db.drop(xs, seed))
    emit({"phase": "zoo", "part": "small", "results": recs, "tolerance": ZOO_SMALL_TOL,
          "pass": True})


def zoo_yolov7(torch, counters, card_name):
    """YOLOv7-L (80 classes) on 8 x 640 x 640 frames, forward and
    postprocess_dense (IoU 0.65, conf 0: random weights score at the 1e-4
    prior, so a real threshold would leave the NMS no valid box; at 0 it
    walks 2048 a frame), fp32 then bf16 (the fp32 weights cast): each run
    counted (the NMS pair once, no stem: L's stem is convs), then timed;
    the bf16 decoded outputs against the fp32 ones. YOLOv7-tiny and -X
    forwards, fp32, timed. Returns (NMS launches, the fp32 neck's stride-32
    map of frame 0, for the DETR memory)."""
    from tscd_torch.models.build import create_model
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops.postprocess import postprocess_dense
    dev = card(torch)
    B, size = ZOO_DETECT
    x = zoo_frames(torch, 81, B, size, dev)
    nms = 0
    model = random_init_(create_model("yolov7", num_classes=80, arch="L", device=dev), 82)
    sd32 = model.state_dict()
    with torch.no_grad():
        memory = model.fpn(model.backbone(x[:1]))[-1][0].flatten(1).t().contiguous()
    dec32 = None
    for dtype in ("fp32", "bf16"):
        if dtype == "bf16":
            del model
            free_card(torch)
            model = create_model("yolov7", num_classes=80, arch="L", dtype=torch.bfloat16,
                                 device=dev)
            model.load_state_dict(sd32)

        def run():
            with torch.no_grad():
                out = model(x)
                return out["decoded"], postprocess_dense(out["decoded"], 80, 0.0, 0.65)
        (decoded, dets), got = zoo_counted(torch, counters, run, {"nms": 1})
        nms += got["nms"]
        rec = {"run": f"yolov7_L_{dtype}", "frames": B, "size": size,
               "decoded": list(decoded.shape), "finite": bool(torch.isfinite(decoded).all()),
               "kept": int(dets.mask.sum()), "launches": got, **zoo_window(torch, run)}
        if dtype == "fp32":
            dec32 = decoded
        else:
            d = (decoded - dec32).abs()
            rec["bf16_vs_fp32"] = {"boxes_max": float(d[..., :4].max()),
                                   "scores_max": float(d[..., 4:].max()),
                                   "scores_mean": float(d[..., 4:].mean())}
        if not rec["finite"] or rec["decoded"] != [B, anchors_at(size), 85]:
            raise AssertionError(f"zoo {rec['run']}: {rec}")
        emit({"phase": "zoo", **rec, "card": card_name})
    del model, dec32
    free_card(torch)
    for arch in ("tiny", "X"):
        model = random_init_(create_model("yolov7", num_classes=80, arch=arch, device=dev), 83)

        def fwd():
            with torch.no_grad():
                return model(x)["decoded"]
        out = fwd()
        emit({"phase": "zoo", "run": f"yolov7_{arch}_fp32", "frames": B, "size": size,
              "finite": bool(torch.isfinite(out).all()), **zoo_window(torch, fwd),
              "card": card_name})
        del model, out
        free_card(torch)
    return nms, memory


def zoo_p6(torch, counters, card_name):
    """ELANNet(arch, return_idx 2-5) + ELANFPNP6 on 2 x 1280 x 1280 frames
    (uint8; cast to fp32 at fp32, read by the bf16 stem as they are), each
    run of ZOO_P6 counted (one stem launch) and timed; the stem's output on
    the same frames against focus_stem_plain, and its device time. Returns
    {ZOO_STEM_ROW row: stem launches} and each run's stem launches."""
    from tscd_torch.models import elan
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops.kernels import focus_stem as fs
    dev = card(torch)
    B, size = ZOO_P6_INPUT
    x = zoo_frames(torch, 84, B, size, dev)
    launches, per_run, sd32 = {}, {}, {}
    for arch, dtype in ZOO_P6:
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        ch = elan.backbone_channels(arch)[-4:]
        net = elan.ELANNet(arch, (2, 3, 4, 5), dtype=dt).to(dev).eval()
        neck = elan.ELANFPNP6(arch, ch, dtype=dt).to(dev).eval()
        if dtype == "fp32":
            random_init_(net, 85)
            random_init_(neck, 86)
            sd32[arch] = (net.state_dict(), neck.state_dict())
        else:
            net.load_state_dict(sd32[arch][0])
            neck.load_state_dict(sd32[arch][1])

        def run():
            with torch.no_grad():
                return neck(net(x))
        maps, got = zoo_counted(torch, counters, run, {"focus_stem": 1})
        per_run[f"{arch}_{dtype}"] = got["focus_stem"]
        row = ZOO_STEM_ROW.get((arch, dtype))
        if row:
            launches[row] = launches.get(row, 0) + got["focus_stem"]
        conv, bn = net.stem.conv.conv, net.stem.conv.bn
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * scale
        xin = x if dtype == "bf16" else x.float()
        with torch.no_grad():
            got_stem = net.stem(xin)
            want_stem = fs.focus_stem_plain(xin, conv.weight, scale, shift, dt)
        tol = BF16_TOL if dtype == "bf16" else {"atol": 1e-3, "rtol": 1e-4}
        err = check_close(f"zoo {arch} {dtype} stem ({B}, {size}, {size}, 3) -> "
                          f"{conv.weight.shape[0]}",
                          got_stem, want_stem, **tol)
        with torch.no_grad():
            stem_t = timed(torch, lambda: net.stem(xin), 10, "focus_stem")
        finite = all(bool(torch.isfinite(m).all()) for m in maps)
        rec = {"run": f"elan_{arch}_p6_{dtype}", "frames": B, "size": size,
               "maps": [list(m.shape) for m in maps], "finite": finite, "launches": got,
               "stem_channels": conv.weight.shape[0], "stem_max_abs_err": err,
               "stem_ms": stem_t["ms"], "stem_call_ms": stem_t["call_ms"],
               **zoo_window(torch, run)}
        if not finite:
            raise AssertionError(f"zoo {rec['run']}: {rec}")
        emit({"phase": "zoo", **rec, "card": card_name})
        del net, neck, maps, got_stem, want_stem
        free_card(torch)
    return launches, per_run


def zoo_yolov8(torch, counters, card_name):
    """YOLOv8-L (80 classes, depth 1, width 1) on 8 x 640 x 640 frames,
    forward and decode at fp32 and bf16 (the fp32 weights cast), each
    counted (no hand kernel) and timed; then one yolov8_loss forward and
    backward in train mode on seeded labels (5-20 boxes a frame), timed:
    the losses and every gradient finite."""
    import numpy as np

    from tscd_torch.models.build import create_model
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.v8_losses import yolov8_loss
    dev = card(torch)
    B, size = ZOO_DETECT
    x = zoo_frames(torch, 87, B, size, dev)
    model = random_init_(create_model("yolov8", num_classes=80, device=dev), 88)
    sd32 = model.state_dict()
    for dtype in ("fp32", "bf16"):
        if dtype == "bf16":
            m = create_model("yolov8", num_classes=80, dtype=torch.bfloat16, device=dev)
            m.load_state_dict(sd32)
        else:
            m = model

        def run():
            with torch.no_grad():
                return m(x)["decoded"]
        decoded, got = zoo_counted(torch, counters, run, {})
        finite = bool(torch.isfinite(decoded).all())
        if not finite or list(decoded.shape) != [B, anchors_at(size), 84]:
            raise AssertionError(f"zoo yolov8 {dtype}: {list(decoded.shape)} finite {finite}")
        emit({"phase": "zoo", "run": f"yolov8_L_{dtype}", "frames": B, "size": size,
              "decoded": list(decoded.shape), "finite": finite, "launches": got,
              **zoo_window(torch, run), "card": card_name})
        del decoded
    del m
    free_card(torch)
    labels = torch.as_tensor(zoo_v8_labels(np.random.default_rng(89), B, size), device=dev)
    model.train()
    losses = {}

    def step():
        model.zero_grad(set_to_none=True)
        parts = yolov8_loss(model(x, train=True, decode=False), labels)
        parts["total_loss"].backward()
        losses.update({k: float(v.detach()) for k, v in parts.items()})
    _, got = zoo_counted(torch, counters, step, {})
    timing = zoo_window(torch, step, reps=2)
    grads = [p.grad for p in model.parameters()]
    finite = (all(np.isfinite(v) for v in losses.values())
              and all(g is not None and bool(torch.isfinite(g).all()) for g in grads))
    emit({"phase": "zoo", "run": "yolov8_L_loss_train_step", "frames": B, "size": size,
          "labels": int((labels.sum(-1) > 0).sum()), "losses": losses,
          "gradients": len(grads), "finite": finite, "launches": got, **timing,
          "card": card_name})
    if not finite or losses["num_fg"] <= 0:
        raise AssertionError(f"zoo yolov8 loss: {losses}, gradients finite {finite}")
    model.eval()
    del model
    free_card(torch)


def zoo_detr(torch, counters, memory, card_name):
    """The DETR decoder at DETR's sizes (dim 256, 8 heads, 6 layers, 100
    queries, FFN 2048, 80 classes) on `memory` (YOLOv7-L's stride-32 neck
    map of one 640 frame: 400 x 1024): set_criterion with 10 valid gts of
    100, forward and backward, counted (6 solver launches, no host read
    between them) and timed; each launch's col4row against the plain
    solver on the same (masked) cost. Returns (solver launches, a layer's
    cost)."""
    from tscd_torch.models import decoder as dec
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.ops import hungarian as ops_hu
    from tscd_torch.ops.kernels import hungarian as hu
    dev = card(torch)
    torch.manual_seed(90)
    model = random_init_(dec.TransformerDecoder(80, memory.shape[1]), 91).to(dev).train()
    gt_cls, gt_boxes, gt_valid = (t.to(dev) for t in zoo_detr_gts(torch, 100, 80, 10, 92))
    solved, solve = [], ops_hu.linear_sum_assignment

    def recording(cost):
        col = solve(cost)
        solved.append((cost, col))
        return col

    def step():
        model.zero_grad(set_to_none=True)
        parts = dec.set_criterion(model(memory), gt_cls, gt_boxes, gt_valid, 80)
        parts["total_loss"].backward()
        return parts

    ops_hu.linear_sum_assignment = recording
    try:
        parts, got = zoo_counted(torch, counters, step, {"hungarian": 6})
    finally:
        ops_hu.linear_sum_assignment = solve
    losses = {k: float(v.detach()) for k, v in parts.items()}
    diffs = [int((col.cpu().long() - hu.linear_sum_assignment_plain(cost.cpu()).long())
                 .abs().max()) for cost, col in solved]
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    finite = all(abs(v) < float("inf") for v in losses.values()) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    rec = {"run": "detr_set_criterion", "config": "dim 256, 8 heads, 6 layers, 100 queries, "
           "FFN 2048, memory 400 x 1024 (YOLOv7-L stride 32, one 640 frame), 10 gts of 100",
           "losses": losses, "col4row_vs_plain_max_abs": diffs, "gradients": len(grads),
           "finite": finite, "launches": got, **zoo_window(torch, step)}
    emit({"phase": "zoo", **rec, "card": card_name})
    if not finite or len(diffs) != 6 or any(diffs):
        raise AssertionError(f"zoo detr: {rec}")
    cost = solved[-1][0][0]
    del model, solved
    free_card(torch)
    return got["hungarian"], cost


def zoo_layers(torch, counters, card_name):
    """DeformConv2d(256 -> 256) with seeded (non-zero) offsets and
    CoordConv(256 -> 256) on an (8, 256, 80, 80) map, DropBlock(7, 0.9) in
    train mode: counted (no hand kernel) and timed."""
    import numpy as np

    from tscd_torch.models import custom_layers as cl
    from tscd_torch.models.tscd import random_init_
    dev = card(torch)
    x = torch.as_tensor(np.random.default_rng(93).normal(size=ZOO_LAYER_INPUT)
                        .astype(np.float32), device=dev)
    C = ZOO_LAYER_INPUT[1]
    gen = torch.Generator(device=dev).manual_seed(94)
    for name, m in (("deform_conv", random_init_(cl.DeformConv2d(C, C), 95).to(dev)),
                    ("coord_conv", random_init_(cl.CoordConv(C, C), 96).to(dev)),
                    ("dropblock", cl.DropBlock(7, 0.9))):
        def run():
            with torch.no_grad():
                return m(x, True, gen) if name == "dropblock" else m(x)
        y, got = zoo_counted(torch, counters, run, {})
        rec = {"run": name, "input": list(x.shape), "output": list(y.shape),
               "finite": bool(torch.isfinite(y).all()), "launches": got,
               **zoo_window(torch, run)}
        if name == "dropblock":
            rec["dropped_share"] = float((y == 0).float().mean())
        emit({"phase": "zoo", **rec, "card": card_name})
        if not rec["finite"]:
            raise AssertionError(f"zoo {name}: {rec}")
        del y
    free_card(torch)


def zoo_phase(torch, counters):
    """The rest of the detector zoo: zoo_small_part (card against the card
    machine's CPU at small configs), then at full width YOLOv7-L (fp32,
    bf16) and -tiny and -X, the P6 ELAN backbones and neck (W6, E6, D6,
    E6E fp32; W6, E6, D6 bf16) at 1280 px, YOLOv8-L (fp32, bf16, a
    train-mode loss step), the DETR criterion at DETR's sizes and the layer
    zoo; then the kernels at the new shapes (the stem at 80 and 96
    channels, fp32 and bf16; the solver on the criterion's cost; the NMS at
    YOLOv7-L's postprocess). Returns {"rows", "launches", "per_run"}."""
    import numpy as np

    from tscd_torch.ops.kernels import library
    t_phase = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()
    card_name = smi[0] if smi else "not read"
    zoo_small_part(torch)
    nms, memory = zoo_yolov7(torch, counters, card_name)
    stem_launches, stem_runs = zoo_p6(torch, counters, card_name)
    zoo_yolov8(torch, counters, card_name)
    solver, cost = zoo_detr(torch, counters, memory, card_name)
    zoo_layers(torch, counters, card_name)
    dev = card(torch)
    lat, clock = latencies(torch, library.load()), sm_clock_mhz()
    rng = np.random.default_rng(97)
    B, size = ZOO_P6_INPUT
    rows = {"focus_stem_p6_80": stem_row(torch, dev, rng, B, size, size, 80),
            "focus_stem_p6_96": stem_row(torch, dev, rng, B, size, size, 96),
            "focus_stem_bf16_p6_80": stem_bf16_row(torch, dev, rng, B, size, size, 80),
            "focus_stem_bf16_p6_96": stem_bf16_row(torch, dev, rng, B, size, size, 96),
            "nms_dense_yolov7": dense_nms_row(torch, dev, rng, 0.65, lat, clock, C=80)}
    from tscd_torch.ops.kernels import hungarian as hu
    err = check_hungarian("hungarian DETR criterion cost (1, 100, 100)", cost[None])
    rows["hungarian_detr"] = dict(
        max_abs_err=err, **hungarian_cost_row(torch, cost[None], lat, clock),
        plain_ms=cuda_ms(torch, lambda: hu.linear_sum_assignment_plain(cost[None]), 1, 1),
        bound_by="operations", bound_model=HUNGARIAN_BOUND, library_ms=None)
    launches = {**stem_launches, "hungarian_detr": solver, "nms_dense_yolov7": nms}
    emit({"phase": "zoo", "seconds": time.time() - t_phase, "card": card_name,
          "stem_launches": stem_runs, "launches": launches,
          "rows": {n: {k: v for k, v in r.items() if "ms" in k} for n, r in rows.items()}})
    return {"rows": rows, "launches": launches, "per_run": {
        "focus_stem": stem_runs, "hungarian": {"detr_set_criterion": solver},
        "nms": {"yolov7_L_fp32_bf16": nms}}}


# the phases `--phase` runs alone: each takes (torch, counters); `train`
# runs the trainer and the four parts of the rest of JAX's trainer
PHASES = ("full", "bf16", "eval", "files", "train", "train_bf16", "train_bn",
          "train_backbone_grad", "train_window_batch", "train_bf16_chain", "heads", "still",
          "ovis", "yolov", "ovis_yolov_plus", "yolov_online", "demo", "backbones", "zoo",
          "trace_lead_in")
PHASE_PARTS = {"train": ("train", "train_bf16", "train_bn", "train_backbone_grad",
                         "train_window_batch")}


def below_bound(rows):
    """Each time in the kernels line's rows (and in the records nested in
    them) that is less than its own `bound_ms`: a reading the card cannot
    give, so a lost or miscounted record."""
    out = []

    def walk(path, rec):
        if not isinstance(rec, dict):
            return
        if "ms" in rec and "bound_ms" in rec and rec["ms"] < rec["bound_ms"]:
            out.append(f"{path}: ms {rec['ms']} < bound_ms {rec['bound_ms']}")
        for k, v in rec.items():
            walk(f"{path}.{k}", v)

    for name, row in rows.items():
        walk(name, row)
    return out


def kernel_counters():
    """Every hand kernel's wrapper, whose `.launches` counts its launches."""
    from tscd_torch.ops.kernels import focus_stem as fs
    from tscd_torch.ops.kernels import fused_attention as fa
    from tscd_torch.ops.kernels import hungarian as hu
    from tscd_torch.ops.kernels import nms as kn
    return {"focus_stem": fs.focus_stem,
            "fused_dual_attention": fa.fused_dual_attention,
            "hungarian": hu.linear_sum_assignment,
            "nms": kn.nms_sorted}


def phase_main(torch, name):
    """`--phase NAME`: the kernels built, TF32 off, then that phase alone,
    each of its lines tagged with this checkout's path."""
    global emit
    from tscd_torch.ops.kernels import library
    library.load()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = emit
    emit = lambda obj: plain({"tree": HERE, **obj})   # noqa: E731
    for part in PHASE_PARTS.get(name, (name,)):
        globals()[f"{part}_phase"](torch, kernel_counters())
    emit({"phase": "trace", "traces_losing_lead_in_records": len(LEAD_IN_LOST),
          "lead_in_records_lost": LEAD_IN_LOST})


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

    if sys.argv[1:] == ["--nms-stage"]:
        from tscd_torch.ops.kernels import library
        library.load()
        nms_stage_main(torch)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--phase" and sys.argv[2] in PHASES:
        phase_main(torch, sys.argv[2])
        return 0
    if sys.argv[1:]:
        print(f"unknown arguments {sys.argv[1:]}: none, --nms-stage, or --phase "
              f"one of {PHASES}", file=sys.stderr)
        return 2

    from tscd_torch.ops.kernels import library
    counters = kernel_counters()

    t0 = time.time()
    library.load()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    emit({"phase": "setup", "build_s": time.time() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    rows = kernel_phase(torch, dev)
    rows.update(head_kernel_rows(torch, dev))
    rows.update(attention_stream_phase(torch, dev))
    rows["fused_dual_attention"]["backward"], attention_bwd_bf16 = attention_backward_phase(
        torch, dev)
    rows["focus_stem"]["backward"] = stem_backward_phase(torch, dev)
    small_phase(torch)
    # each row's launches in the 3 traced windows of its model's phase
    launches, carried, sorted_in, stage = full_phase(torch, counters)
    carried_phase(torch, rows["hungarian"], carried)
    nms_window_phase(torch, rows["nms"], sorted_in, stage)
    launches_bf16 = bf16_phase(torch, counters)
    for name in ("focus_stem_bf16", "fused_dual_attention_bf16"):
        launches[name] = launches_bf16[name]
    rows["fused_dual_attention_bf16"]["backward"] = attention_bwd_bf16
    eval_phase(torch, counters)
    file_launches = files_phase(torch, counters)
    train_small_phase(torch)
    per_step = train_phase(torch, counters)
    traced_bf16 = train_bf16_phase(torch, counters)
    train_bn_phase(torch, counters)
    traced_backbone = train_backbone_grad_phase(torch, counters)
    train_window_batch_phase(torch, counters)
    heads = heads_phase(torch, counters)
    rows["nms_prenms"] = heads["nms_prenms"]
    launches.update(heads["launches"])
    for recipe in (still_phase(torch, counters), ovis_phase(torch, counters),
                   yolov_phase(torch, counters), ovis_yolov_plus_phase(torch, counters),
                   yolov_online_phase(torch, counters), demo_phase(torch, counters)):
        rows.update(recipe["rows"])
        launches.update(recipe["launches"])
    for run, per_window in backbones_phase(torch, counters).items():
        for row, n in per_window.items():
            rows[row].setdefault("launches_a_window_backbones", {})[run] = n
    zoo = zoo_phase(torch, counters)
    rows.update(zoo["rows"])
    launches.update(zoo["launches"])
    for row, per_run in zoo["per_run"].items():
        rows[row]["launches_zoo"] = per_run
    rows["fused_dual_attention"]["backward"]["launches_per_train_step"] = {
        "calls": per_step["fused_dual_attention_backward_calls"],
        "kernels": per_step["fused_dual_attention_backward_kernels"]}
    rows["fused_dual_attention_bf16"]["backward"]["launches_per_train_step"] = {
        k: traced_bf16["attention_backward"][k] for k in ("calls", "kernels")}
    rows["focus_stem"]["backward"]["launches_per_train_step"] = {
        "stop_backbone_grad=False": {k: traced_backbone["stem_backward"][k]
                                     for k in ("calls", "kernels")}}
    for name in KERNELS:
        rows[name]["launches_per_train_step"] = per_step[name]
        rows[name]["launches_per_bf16_train_step"] = traced_bf16["launches"][name]
        rows[name]["launches_file_eval"] = file_launches[name]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    shaped = {**HEAD_ROWS, **RECIPE_ROWS, **YOLOV_ROWS, **OVIS_PLUS_ROWS, **ZOO_ROWS}
    sources = {**KERNELS, **{n: KERNELS[base] for n, (base, _) in shaped.items()}}
    for name, (_, shape) in shaped.items():
        rows[name]["shape"] = shape
    below = below_bound(rows)
    if below:
        raise AssertionError(f"times under their bound: {below}")
    emit({"phase": "trace", "traces_losing_lead_in_records": len(LEAD_IN_LOST),
          "lead_in_records_lost": LEAD_IN_LOST})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **rows[name]}
        for name, (src, rep) in sources.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
