"""YOLOV / YOLOV++ training CLI of the port (counterpart of
tools/vid_train.py; reference tools/vid_train.py): `tscd_train` with the
YOLOV-L exp by default.

    python -m tscd_torch.tools.vid_train --exp yolov_l -c stage1.pth
    python -m tscd_torch.tools.vid_train --exp yolov_selftest --device cpu

Trains on the card (or the device given) in fp32 through the exp's
`YOLOVTrainer`: the stage-2 trainer's loader (HSV jitter and flip at
every epoch), `window_batch`, `fix_bn`, the frozen backbone, SGD groups,
EMA and checkpoints, with the YOLOV losses over the refined frames. `-c`,
`--resume`, `-e`, `--device` and the exp overrides are tscd_train's.
"""

from . import tscd_train


def main(argv=None):
    parser = tscd_train.make_parser(
        "YOLOV train (PyTorch port)",
        "yolov_l (default), yolov_s, v++_base, ... or yolov_selftest")
    return tscd_train.run(parser.parse_args(argv), "yolov_l")


if __name__ == "__main__":
    main()
