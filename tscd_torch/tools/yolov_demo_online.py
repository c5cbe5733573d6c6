"""Streaming online YOLOV demo of the port (counterpart of
tools/yolov_demo_online.py).

    python -m tscd_torch.tools.yolov_demo_online --exp yolov_l \\
        -c ckpt.msgpack --path frames_dir [--online-batch K] [--device cpu]

Each frame, letterboxed to the exp's test size, goes through
`core.online.OnlineStream` (YOLOVOnline with a bank of --bank_frames
frames, P = minimal_limit): one frame a step, or with --online-batch K
frames gathered by `utils.batcher.FrameBatcher` (flushed when K wait or
the oldest has waited --max-wait-ms) and run by `OnlineStream.run_batch`:
a full batch as one K-frame window step, a partial one frame by frame, as
the JAX tool's rule keeps the bank. The refined detections from the third
frame on (the still detector's before) are drawn at or above --conf and
written to `<output_dir>/online_out.mp4` (Motion JPEG in MP4). `-c` is
read as tscd_eval reads it and must hold the online head's weights (JAX's
`head/trans`): where the JAX tool leaves weights a checkpoint lacks at their
random initial values, the port raises.
"""

import argparse
import os
import time
from typing import Dict

import numpy as np


def make_parser():
    p = argparse.ArgumentParser("YOLOV online demo (PyTorch port)")
    src = p.add_mutually_exclusive_group()
    src.add_argument("-f", "--exp_file", type=str, default=None)
    src.add_argument("--exp", type=str, default=None, help="built-in exp (yolov_l)")
    p.add_argument("-c", "--ckpt", type=str, required=True)
    p.add_argument("--path", type=str, required=True, help="directory of JPEG frames")
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--bank_frames", type=int, default=31)
    p.add_argument("--online-batch", type=int, default=1, metavar="K",
                   help="up to K frames a step (one K-frame window step)")
    p.add_argument("--max-wait-ms", type=float, default=25.0,
                   help="with --online-batch: flush a partial batch once its oldest "
                        "frame has waited this long")
    p.add_argument("--output_dir", type=str, default="./demo_out")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card (cuda) unless given")
    p.add_argument("opts", nargs="*")
    return p


def run(args) -> Dict:
    """The demo for parsed `args`: {"dets": each frame's detection rows as
    handed to vis, "batches" (the size of each batch run), "path",
    "frames", "drawn", "ms_per_frame"}."""
    from tscd_torch.core.online import OnlineStream
    from tscd_torch.core.predict import detection_rows
    from tscd_torch.data.transforms import letterbox
    from tscd_torch.data.vid import VID_CLASSES
    from tscd_torch.device import resolve_device
    from tscd_torch.exp import get_exp
    from tscd_torch.tools.tscd_eval import load_weights
    from tscd_torch.utils.batcher import FrameBatcher
    from tscd_torch.utils.video import VideoWriter, read_frames
    from tscd_torch.utils.visualize import vis

    exp = get_exp(args.exp_file, args.exp or (None if args.exp_file else "yolov_l"))
    exp.merge(args.opts)
    H, W = exp.test_size
    model = exp.get_online_model(device=resolve_device(args.device))
    load_weights(model, args.ckpt)
    K = max(1, args.online_batch)
    stream = OnlineStream(model, bank_frames=args.bank_frames, batch=K)
    names = VID_CLASSES[:exp.num_classes]
    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "online_out.mp4")
    res = {"dets": [], "frames": [], "drawn": 0, "path": path, "batches": []}
    writer = None

    def emit(frame, rows, r):
        nonlocal writer
        boxes = rows[:, :4] / r
        scores = rows[:, 4] * rows[:, 5]
        res["drawn"] += int((scores >= args.conf).sum())
        out = vis(frame, boxes, scores, rows[:, 6], args.conf, names)
        if writer is None:
            writer = VideoWriter(path, 25, (out.shape[1], out.shape[0]))
        writer.write(out)
        res["dets"].append(rows)
        res["frames"].append(out)

    def run_batch(items):
        res["batches"].append(len(items))
        for (frame, _, r), d in zip(items, stream.run_batch([p for _, p, _ in items])):
            emit(frame, detection_rows(d)[0], r)

    t0 = time.time()
    batcher = FrameBatcher(K, args.max_wait_ms)
    for frame in read_frames(args.path):
        padded, r = letterbox(frame, (H, W), dtype=np.uint8)
        full = batcher.push((frame, padded, r))
        if full is None:
            full = batcher.poll()
        if full:
            run_batch(full)
    tail = batcher.flush()
    if tail:
        run_batch(tail)
    if writer is not None:
        writer.release()
    dt = time.time() - t0
    n = len(res["frames"])
    res["ms_per_frame"] = 1000 * dt / max(n, 1)
    print(f"{n} frames, {n / max(dt, 1e-9):.1f} fps (incl. IO)")
    print(f"wrote {path} ({res['drawn']} boxes drawn)")
    return res


def main(argv=None):
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
