"""Still-image COCO evaluation CLI of the port (counterpart of
tools/eval.py).

    python -m tscd_torch.tools.eval --exp ovis_yolox_l -c ckpt.pth
    python -m tscd_torch.tools.eval -f <exp file> -c x.msgpack --device cpu

Evaluates the exp's val set on the card (or the device given) and prints
mAP and AP50. `-c` takes a port checkpoint or state_dict `.pth` (its
"model" entry, the EMA weights, where it has one) or a JAX `.msgpack`
(variables, or a JAX training checkpoint's EMA weights); a key the
checkpoint lacks raises. `--int8` serves the model in JAX's w8a8 int8
mode with dynamic activation scales (`models.blocks.int8_eval`, the hand
int8 conv on a card). Exp overrides (`key value` pairs) go after every
flag.
"""

import argparse
import json


def make_parser():
    parser = argparse.ArgumentParser("YOLOX eval (PyTorch port)")
    src = parser.add_mutually_exclusive_group()
    src.add_argument("-f", "--exp_file", type=str, default=None,
                     help="exp file defining Exp (a tscd_torch.exp.YOLOXExp)")
    src.add_argument("--exp", "-n", "--name", dest="exp", type=str, default=None,
                     help="built-in exp, e.g. yolox_l (default), ovis_yolox_l")
    parser.add_argument("-c", "--ckpt", type=str, required=True)
    parser.add_argument("-b", "--batch-size", type=int, default=8)
    parser.add_argument("--conf", type=float, default=None)
    parser.add_argument("--nms", type=float, default=None)
    parser.add_argument("--tsize", type=int, default=None)
    parser.add_argument("--int8", action="store_true",
                        help="w8a8 int8 serving mode (dynamic activation scales; "
                        "models/blocks.py int8_eval)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the card (cuda) unless given")
    parser.add_argument("--output", type=str, default=None,
                        help="json dump of the result dict")
    parser.add_argument("opts", nargs="*")
    return parser


def main(argv=None):
    from tscd_torch.core.trainer import make_predict_fn
    from tscd_torch.device import resolve_device
    from tscd_torch.exp import get_exp
    from tscd_torch.tools.tscd_eval import int8_serving
    from tscd_torch.train.checkpoint import load_checkpoint

    args = make_parser().parse_args(argv)
    exp = get_exp(args.exp_file, args.exp or (None if args.exp_file else "yolox_l"))
    exp.merge(args.opts)
    if args.conf is not None:
        exp.test_conf = args.conf
    if args.nms is not None:
        exp.nmsthre = args.nms
    if args.tsize is not None:
        exp.test_size = (args.tsize, args.tsize)
    model = exp.get_model(device=resolve_device(args.device))
    ckpt = load_checkpoint(args.ckpt, model)
    res = model.load_state_dict(ckpt.get("model", ckpt), strict=False)
    if res.missing_keys:
        raise KeyError(f"{args.ckpt} lacks {len(res.missing_keys)} keys of the model, "
                       f"e.g. {res.missing_keys[:5]}")
    evaluator = exp.get_evaluator()
    evaluator.batch_size = args.batch_size
    with int8_serving(args, model):
        result = evaluator.evaluate(make_predict_fn(model, exp.num_classes, exp.test_conf,
                                                    exp.nmsthre))
    print(result.get("mAP"), result.get("AP50"))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
