"""TSCD stage-2 training CLI of the port (counterpart of
tools/tscd_train.py; reference tools/tscd_train.py:102).

    python -m tscd_torch.tools.tscd_train -f <exp file> [-c init.pth]
    python -m tscd_torch.tools.tscd_train --exp selftest --device cpu

Trains on the card (or the device given) in fp32, as the exp sets it:
`window_batch` windows a step and `grad_accum`, `fix_bn` (else train-mode
BatchNorm), `stop_backbone_grad` and `remat_backbone` (e.g. the overrides
`window_batch 2 fix_bn False`). `-c` loads initial weights, shape
tolerant (a port or reference `.pth`, or a JAX `.msgpack`): the OVIS
recipe's stage 2 starts from stage 1's YOLOX checkpoint (`tools/train.py`)
so, taking the tensors JAX's shape-tolerant loader takes; `--resume`
continues from `<output_dir>/<exp_name>/latest_ckpt.pth` (or `-c`, which
may be a JAX trainer's `latest_ckpt.msgpack`), momentum included; `-e N`
starts at epoch N. Exp overrides (`key value` pairs) go after
every flag.
"""

import argparse


def make_parser():
    parser = argparse.ArgumentParser("TSCD train (PyTorch port)")
    src = parser.add_mutually_exclusive_group()
    src.add_argument("-f", "--exp_file", type=str, default=None,
                     help="exp file defining Exp (a tscd_torch.exp.TSCDExp)")
    src.add_argument("--exp", type=str, default=None,
                     help="built-in exp: tscd_large (default), tscd_base, "
                     "ovis_tscd_large, ovis_tscd_base or selftest")
    parser.add_argument("-expn", "--experiment-name", type=str, default=None)
    parser.add_argument("-c", "--ckpt", type=str, default=None,
                        help="initial weights, or the checkpoint to resume")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("-e", "--start_epoch", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the card (cuda) unless given")
    parser.add_argument("opts", nargs="*", help="exp overrides: key value ...")
    return parser


def main(argv=None):
    from tscd_torch.exp import get_exp
    args = make_parser().parse_args(argv)
    exp = get_exp(args.exp_file, args.exp or (None if args.exp_file else "tscd_large"))
    exp.merge(args.opts)
    if args.experiment_name:
        exp.exp_name = args.experiment_name
    return exp.get_trainer(args, device=args.device).train()


if __name__ == "__main__":
    main()
