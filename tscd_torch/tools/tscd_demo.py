"""TSCD video demo of the port (counterpart of tools/tscd_demo.py).

    python -m tscd_torch.tools.tscd_demo --exp tscd_large -c ckpt.msgpack \\
        --path frames_dir [--post] [--device cpu] [key value ...]

Reads a directory of JPEG frames (`utils.video.read_frames`; a video file
or a camera raises: the port has no video decoder), letterboxes them to the
exp's test size, runs windows of lframe_val local + gframe_val global
frames through the port's predict path (`core/predict.py`) on the card
unless `--device` says otherwise, with the JAX tool's chunking: consecutive
local frames (stride L - 1 with the exp's `traj_linking`, then tubelet
rescoring over the video), global frames drawn by `random.Random(42)` from
the frames outside the window, the matcher state carried from window to
window. `--post` runs REPP. Each frame is drawn (`utils.visualize.vis`,
boxes at or above `--conf`) and written to `<output_dir>/tscd_out.mp4` as
Motion JPEG in MP4 (`utils.video.VideoWriter`; the JAX tool writes MPEG-4
Part 2 there, which the card's machine cannot encode). `-c` takes what
tscd_eval's does (a JAX `.msgpack`, or a `.pth`). `--int8` and
`--int8-calib` raise: int8 is not ported.
"""

import argparse
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np


def make_parser(prog="TSCD demo (PyTorch port)", default_exp="tscd_large"):
    parser = argparse.ArgumentParser(prog)
    src = parser.add_mutually_exclusive_group()
    src.add_argument("-f", "--exp_file", type=str, default=None,
                     help="exp file defining Exp (a tscd_torch.exp exp)")
    src.add_argument("--exp", type=str, default=None,
                     help=f"built-in exp ({default_exp} unless -f is given)")
    parser.add_argument("-c", "--ckpt", type=str, required=True)
    parser.add_argument("--path", type=str, required=True,
                        help="directory of JPEG frames")
    parser.add_argument("--conf", type=float, default=0.25)
    parser.add_argument("--nms", type=float, default=None,
                        help="final-NMS IoU threshold (exp.nmsthre; video default 0.5)")
    parser.add_argument("--output_dir", type=str, default="./demo_out")
    parser.add_argument("--post", action="store_true", help="REPP tubelet post-processing")
    parser.add_argument("--save_result", action="store_true", default=True,
                        help="the JAX tool's flag: the video is always written")
    parser.add_argument("--int8", action="store_true", help="not ported (raises)")
    parser.add_argument("--int8-calib", type=int, default=0, metavar="K",
                        help="not ported (raises)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the card (cuda) unless given")
    parser.add_argument("opts", nargs="*")
    return parser


def prepare(args, default_exp: str):
    """(exp, frames, letterboxed uint8 frames (N, H, W, 3), ratios, the
    predict function of the exp's model with the checkpoint's weights) for
    a demo's arguments: the exp of -f / --exp (else `default_exp`) with the
    overrides and --nms applied."""
    from tscd_torch.data.transforms import letterbox
    from tscd_torch.device import resolve_device
    from tscd_torch.exp import get_exp
    from tscd_torch.tools.tscd_eval import load_weights
    from tscd_torch.utils.video import read_frames

    if args.int8 or args.int8_calib:
        raise NotImplementedError("--int8 / --int8-calib: int8 serving is not ported "
                                  "(ROADMAP queue 1 item 9)")
    exp = get_exp(args.exp_file, args.exp or (None if args.exp_file else default_exp))
    exp.merge(args.opts)
    if args.nms is not None:
        exp.nmsthre = args.nms
    H, W = exp.test_size
    frames = list(read_frames(args.path))
    if not frames:
        raise FileNotFoundError(f"no frames found at {args.path}")
    print(f"{len(frames)} frames")
    processed, ratios = [], []
    for f in frames:
        p, r = letterbox(f, (H, W), dtype=np.uint8)
        processed.append(p)
        ratios.append(r)
    model = exp.get_model(device=resolve_device(args.device))
    load_weights(model, args.ckpt)
    return exp, frames, np.stack(processed), ratios, exp.get_predict_fn(model)


def draw_and_write(args, exp, frames, ratios, all_dets, class_names) -> Dict:
    """Draws each frame's detections at or above --conf (in place, as the
    JAX tool does) and writes the frames to <output_dir>/tscd_out.mp4.
    Returns the path, the frames and the number of boxes drawn."""
    from tscd_torch.utils.video import VideoWriter
    from tscd_torch.utils.visualize import vis

    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "tscd_out.mp4")
    names = class_names[:exp.num_classes]
    drawn = 0
    out_frames = []
    with VideoWriter(path, 25, (frames[0].shape[1], frames[0].shape[0])) as writer:
        for fi, f in enumerate(frames):
            d = all_dets[fi]
            if d is not None and len(d):
                boxes = d[:, :4] / ratios[fi]
                scores = d[:, 4] * d[:, 5]
                drawn += int((scores >= args.conf).sum())
                out = vis(f, boxes, scores, d[:, 6], args.conf, names)
            else:
                out = f
            writer.write(out)
            out_frames.append(out)
    print(f"wrote {path} ({drawn} boxes drawn)")
    return {"path": path, "frames": out_frames, "drawn": drawn}


def run_windows(exp, frames, processed, predict, traj: bool) -> List[Optional[np.ndarray]]:
    """The JAX tool's chunking (tools/tscd_demo.py:159-181): the local
    frames of window i follow those of window i - 1 (stride L, or L - 1
    with traj_linking), padded with the last frame; G global frames drawn
    by random.Random(42) from the frames outside the window. Returns each
    frame's detection rows (None where no window had it as a local frame)."""
    from tscd_torch.ops.position import get_timing_signal_1d

    L, G = exp.lframe_val, exp.gframe_val
    rng = random.Random(42)
    stride = max(L - 1, 1) if traj else max(L, 1)
    all_dets: List[Optional[np.ndarray]] = [None] * len(frames)
    state = None
    for ci, lo in enumerate(range(0, len(frames), stride)):
        local_idx = list(range(lo, min(lo + L, len(frames))))
        while len(local_idx) < L:
            local_idx.append(local_idx[-1])
        pool = [i for i in range(len(frames)) if i not in local_idx] or local_idx
        global_idx = [rng.choice(pool) for _ in range(G)]
        idxs = local_idx + global_idx
        te = get_timing_signal_1d(np.asarray(idxs, np.float32), 256)
        dets, state = predict(processed[idxs], te, ci != 0, state)
        for k, fi in enumerate(local_idx[:L]):
            if fi < len(frames) and all_dets[fi] is None:
                all_dets[fi] = dets[k]
    return all_dets


def run(args) -> Dict:
    """The demo for parsed `args`: {"dets": each frame's rows as handed to
    vis, "path", "frames", "drawn", "ms_per_frame"}."""
    from tscd_torch.data.vid import VID_CLASSES

    exp, frames, processed, ratios, predict = prepare(args, "tscd_large")
    traj = bool(getattr(exp, "traj_linking", False))
    t0 = time.time()
    all_dets = run_windows(exp, frames, processed, predict, traj)
    dt = time.time() - t0
    ms = 1000 * dt / len(frames)
    print(f"inference: {ms:.1f} ms/frame ({len(frames) / dt:.1f} fps)")
    if traj:
        from tscd_torch.postprocess.linking import post_linking
        filled = [d if d is not None else np.zeros((0, 7), np.float32) for d in all_dets]
        all_dets = post_linking(filled)
        print("traj_linking: tubelet-averaged rescoring applied")
    if args.post:
        from tscd_torch.postprocess.repp import REPP
        all_dets = REPP(min_tubelet_score=args.conf * 0.5,
                        min_pred_score=0.01).process_video_dets(all_dets)
    out = draw_and_write(args, exp, frames, ratios, all_dets, VID_CLASSES)
    return {"dets": all_dets, "ms_per_frame": ms, **out}


def main(argv=None):
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
