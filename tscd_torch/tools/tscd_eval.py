"""TSCD video evaluation CLI of the port (counterpart of tools/tscd_eval.py;
reference tools/tscd_eval.py:125).

    python -m tscd_torch.tools.tscd_eval --exp selftest -c ckpt.pth \\
        --device cpu --output result.json

Runs the exp's val windows through the model on the card (or the device
given) and prints mAP and AP50. `-c` takes the port's own state_dict
`.pth`, a reference checkpoint (`{"model": state_dict, ...}`) or a JAX
`.msgpack` (variables, or a JAX training checkpoint's EMA weights); keys
of reference modules the port has no counterpart for are skipped, a
missing key raises. `--tnum N` evaluates the first N val windows only; -1 all.
`--dataset ovis` reads the exp's OVIS json (`dataset_name`), as JAX's
flag does.
Exp overrides (`key value` pairs) go after every flag.
"""

import argparse
import json
import random

import numpy as np


def make_parser():
    parser = argparse.ArgumentParser("TSCD eval (PyTorch port)")
    src = parser.add_mutually_exclusive_group()
    src.add_argument("-f", "--exp_file", type=str, default=None,
                     help="exp file defining Exp (a tscd_torch.exp.TSCDExp)")
    src.add_argument("--exp", type=str, default=None,
                     help="built-in exp: tscd_large (default), tscd_base, "
                     "ovis_tscd_large, ovis_tscd_base or selftest")
    parser.add_argument("-c", "--ckpt", type=str, required=True)
    parser.add_argument("--dataset", type=str, default=None, choices=["vid", "ovis"])
    parser.add_argument("--lframe", type=int, default=None)
    parser.add_argument("--gframe", type=int, default=None)
    parser.add_argument("--tnum", type=int, default=-1)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the card (cuda) unless given")
    parser.add_argument("--output", type=str, default=None,
                        help="json dump of the result dict")
    parser.add_argument("opts", nargs="*")
    return parser


def main(argv=None):
    from tscd_torch.core.predict import make_predict_fn
    from tscd_torch.device import resolve_device
    from tscd_torch.exp import get_exp
    from tscd_torch.train.checkpoint import load_checkpoint
    from tscd_torch.utils.convert import load_reference_pth

    args = make_parser().parse_args(argv)
    exp = get_exp(args.exp_file, args.exp or (None if args.exp_file else "tscd_large"))
    exp.merge(args.opts)
    if args.dataset:
        exp.dataset_name = args.dataset
    if args.lframe is not None:
        exp.lframe_val = args.lframe
    if args.gframe is not None:
        exp.gframe_val = args.gframe
    exp.tnum = args.tnum

    # the val windows' global frames come from the `random` module; seeded
    # from the exp as the JAX CLI's trainer does (utils/seeding.py)
    if exp.seed is not None:
        random.seed(int(exp.seed))
        np.random.seed(int(exp.seed) & 0xFFFFFFFF)
    device = resolve_device(args.device)
    model = exp.get_model(device=device)
    sd = (load_checkpoint(args.ckpt, model)["model"] if args.ckpt.endswith(".msgpack")
          else load_reference_pth(args.ckpt))
    res = model.load_state_dict(sd, strict=False)
    if res.missing_keys:
        raise KeyError(f"{args.ckpt} lacks {len(res.missing_keys)} keys of the "
                       f"model, e.g. {res.missing_keys[:5]}")
    if res.unexpected_keys:
        print(f"skipped {len(res.unexpected_keys)} checkpoint keys the port "
              f"has no module for")

    loader = exp.get_eval_loader(pin_memory=device.type == "cuda")
    evaluator = exp.get_evaluator(loader)
    predict = make_predict_fn(model, exp.lframe_val, exp.gframe_val,
                              exp.nmsthre, exp.test_conf)
    result = evaluator.evaluate(predict)
    print(result.get("mAP"), result.get("AP50"))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.output}")
    return result


if __name__ == "__main__":
    main()
