"""Still-image YOLOX training CLI of the port (counterpart of tools/train.py;
reference tools/train.py:104): stage 1 of the OVIS recipe.

    python -m tscd_torch.tools.train --exp ovis_yolox_l [-c init.pth]
    python -m tscd_torch.tools.train -f <exp file> --device cpu -b 4

Trains on the card (or the device given) in fp32 as the exp sets it:
mosaic and mixup, the no-aug tail with the L1 loss, `grad_accum`,
multiscale. `-c` loads initial weights, shape tolerant (a port `.pth` or a
JAX `.msgpack`); `--resume` continues from
`<output_dir>/<exp_name>/latest_ckpt.pth` (or `-c`, which may be a JAX
trainer's `latest_ckpt.msgpack`), momentum included. `--mesh-data`,
`--mesh-model` and `--fsdp` set JAX's mesh knobs, which the port does not
run yet (they raise). Exp overrides (`key value` pairs) go after every
flag.
"""

import argparse


def make_parser():
    parser = argparse.ArgumentParser("YOLOX train (PyTorch port)")
    src = parser.add_mutually_exclusive_group()
    src.add_argument("-f", "--exp_file", type=str, default=None,
                     help="exp file defining Exp (a tscd_torch.exp.YOLOXExp)")
    src.add_argument("--exp", "-n", "--name", dest="exp", type=str, default=None,
                     help="built-in exp, e.g. yolox_l (default), ovis_yolox_l, yoloxl_ovis")
    parser.add_argument("-expn", "--experiment-name", type=str, default=None)
    parser.add_argument("-b", "--batch-size", type=int, default=None)
    parser.add_argument("-c", "--ckpt", type=str, default=None,
                        help="initial weights, or the checkpoint to resume")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--mesh-data", type=int, default=None)
    parser.add_argument("--mesh-model", type=int, default=None)
    parser.add_argument("--fsdp", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the card (cuda) unless given")
    parser.add_argument("opts", nargs="*", help="exp overrides: key value ...")
    return parser


def main(argv=None):
    from tscd_torch.exp import get_exp
    args = make_parser().parse_args(argv)
    exp = get_exp(args.exp_file, args.exp or (None if args.exp_file else "yolox_l"))
    exp.merge(args.opts)
    if args.batch_size:
        exp.batch_size = args.batch_size
    if args.mesh_data is not None:
        exp.mesh_data = args.mesh_data
    if args.mesh_model is not None:
        exp.mesh_model = args.mesh_model
    if args.fsdp:
        exp.fsdp = True
    if args.experiment_name:
        exp.exp_name = args.experiment_name
    return exp.get_trainer(args, device=args.device).train()


if __name__ == "__main__":
    main()
