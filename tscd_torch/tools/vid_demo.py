"""YOLOV / YOLOV++ video demo of the port (counterpart of
tools/vid_demo.py).

    python -m tscd_torch.tools.vid_demo --exp yolov_l -c ckpt.msgpack \\
        --path frames_dir [--post] [--device cpu] [key value ...]

tscd_demo's flags, frames and output (`<output_dir>/tscd_out.mp4`, Motion
JPEG in MP4), with the YOLOV exp and the JAX tool's chunking
(tools/vid_demo.py:168-201): an exp with lframe_val 0 (YOLOV's gmode) runs
consecutive chunks of G frames, the last padded with its last frame, and
keeps every frame's detections; one with local frames runs len // L windows
of L consecutive local frames and G global frames drawn by
random.Random(42) from the others. `--post` runs REPP. `--int8` and
`--int8-calib K` are tscd_demo's.
"""

import random
import time
from typing import Dict, List, Optional

import numpy as np

from .tscd_demo import draw_and_write, make_parser as _make_parser, prepare


def make_parser():
    return _make_parser("YOLOV demo (PyTorch port)", "yolov_l")


def run_windows(exp, frames, processed, predict) -> List[Optional[np.ndarray]]:
    """Each frame's detection rows through the JAX tool's chunking."""
    from tscd_torch.ops.position import get_timing_signal_1d

    L, G = exp.lframe_val, exp.gframe_val
    all_dets: List[Optional[np.ndarray]] = [None] * len(frames)
    state = None
    if L == 0:
        for ci in range((len(frames) + G - 1) // G):
            idxs = list(range(ci * G, min((ci + 1) * G, len(frames))))
            padded_idx = idxs + [idxs[-1]] * (G - len(idxs))
            te = get_timing_signal_1d(np.asarray(padded_idx, np.float32), 256)
            dets, state = predict(processed[padded_idx], te, ci != 0, state)
            for k, fi in enumerate(idxs):
                if all_dets[fi] is None:
                    all_dets[fi] = dets[k]
        return all_dets
    rng = random.Random(42)
    for ci in range(max(len(frames) // L, 1)):
        local_idx = list(range(ci * L, min(ci * L + L, len(frames))))
        while len(local_idx) < L:
            local_idx.append(local_idx[-1])
        pool = [i for i in range(len(frames)) if i not in local_idx] or local_idx
        idxs = local_idx + [rng.choice(pool) for _ in range(G)]
        te = get_timing_signal_1d(np.asarray(idxs, np.float32), 256)
        dets, state = predict(processed[idxs], te, ci != 0, state)
        for k, fi in enumerate(local_idx[:L]):
            if fi < len(frames) and all_dets[fi] is None:
                all_dets[fi] = dets[k]
    return all_dets


def run(args) -> Dict:
    """The demo for parsed `args`: {"dets", "path", "frames", "drawn",
    "ms_per_frame"}, as tscd_demo.run."""
    from tscd_torch.data.vid import VID_CLASSES

    exp, frames, processed, ratios, predict, mode = prepare(args, "yolov_l")
    t0 = time.time()
    with mode:
        all_dets = run_windows(exp, frames, processed, predict)
    dt = time.time() - t0
    ms = 1000 * dt / len(frames)
    print(f"inference: {ms:.1f} ms/frame ({len(frames) / dt:.1f} fps)")
    print(f"frames with predictions: {sum(d is not None for d in all_dets)}/{len(frames)}")
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
