"""YOLOV / YOLOV++ video evaluation CLI of the port (counterpart of
tools/vid_eval.py; reference tools/vid_eval.py): `tscd_eval` with the
YOLOV-L exp by default.

    python -m tscd_torch.tools.vid_eval --exp yolov_l -c ckpt.pth \\
        --output result.json

Runs the exp's val windows (YOLOV-L's: 0 local + 32 global frames at 576
px) through the model on the card (or the device given) and prints mAP
and AP50; with lframe 0 every frame of a window is evaluated. `-c`, `--dataset`,
`--lframe`, `--gframe`, `--tnum`, `--device`, `--output` and the exp
overrides (`key value` pairs, after every flag) are tscd_eval's, and so
are `--int8` (JAX's w8a8 serving mode, dynamic scales) and `--int8-calib
K` (static scales calibrated on the first K val windows).
"""

from . import tscd_eval


def make_parser():
    return tscd_eval.make_parser(
        "YOLOV eval (PyTorch port)",
        "yolov_l (default), yolov_s, v++_base, v++_base_decoupleReg, v++_large, "
        "v_plus_base, ... or yolov_selftest")


def main(argv=None):
    return tscd_eval.run(make_parser().parse_args(argv), "yolov_l")


if __name__ == "__main__":
    main()
