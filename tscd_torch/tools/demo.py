"""Still-image YOLOX demo of the port (counterpart of tools/demo.py).

    python -m tscd_torch.tools.demo image -n yolox-s -c ckpt.msgpack \\
        --path img.jpg|dir [--save_result] [--device cpu]

Letterboxes each JPEG to the exp's test size (--tsize for a square one),
runs the port's YOLOX and its still-image postprocess (`postprocess_dense`:
--conf, --nms, 100 boxes) on the card unless --device says otherwise,
prints each image's detections and time, draws them (`utils.visualize.vis`
with COCO's names) and, with --save_result, writes
`<output_dir>/<exp_name>/vis_res/<file name>` as JPEG (`data.image.imwrite`).
Without -c the weights are random. `video` and `webcam` raise: they need
cv2.VideoCapture. `--int8` serves the model in JAX's w8a8 int8 mode with
dynamic activation scales (`models.blocks.int8_eval`).
"""

import argparse
import os
import time

import numpy as np

IMAGE_EXT = [".jpg", ".jpeg", ".webp", ".bmp", ".png"]

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush")


def make_parser():
    parser = argparse.ArgumentParser("YOLOX demo (PyTorch port)")
    parser.add_argument("demo", default="image", help="image (video and webcam raise)")
    parser.add_argument("-n", "--name", type=str, default=None)
    parser.add_argument("-f", "--exp_file", type=str, default=None)
    parser.add_argument("-c", "--ckpt", type=str, default=None)
    parser.add_argument("--path", type=str, default="./assets/dog.jpg")
    parser.add_argument("--conf", type=float, default=0.3)
    parser.add_argument("--nms", type=float, default=0.45)
    parser.add_argument("--tsize", type=int, default=None)
    parser.add_argument("--save_result", action="store_true")
    parser.add_argument("--int8", action="store_true",
                        help="w8a8 int8 serving mode (dynamic activation scales; "
                        "models/blocks.py int8_eval)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the card (cuda) unless given")
    parser.add_argument("opts", nargs="*")
    return parser


def get_image_list(path):
    image_names = []
    for maindir, _, file_name_list in os.walk(path):
        for filename in file_name_list:
            if os.path.splitext(filename)[1].lower() in IMAGE_EXT:
                image_names.append(os.path.join(maindir, filename))
    return image_names


class Predictor:
    """The exp's YOLOX on `device` with the checkpoint's weights (random
    without one); `inference(img)` -> (boxes in the image's pixels, scores,
    class ids, seconds)."""

    def __init__(self, exp, ckpt_path=None, conf=0.3, nms=0.45, device=None):
        import torch

        from tscd_torch.data.transforms import letterbox
        from tscd_torch.device import resolve_device
        from tscd_torch.ops.postprocess import postprocess_dense
        from tscd_torch.tools.tscd_eval import load_weights

        self.exp = exp
        self.letterbox = letterbox
        self.model = exp.get_model(device=resolve_device(device))
        if ckpt_path:
            load_weights(self.model, ckpt_path)
        model, C = self.model, exp.num_classes

        @torch.no_grad()
        def fwd(x):
            out = model(x.to(model.device), False, True)
            return postprocess_dense(out["decoded"], C, conf, nms, 100)

        self.fwd = fwd

    def inference(self, img):
        import torch
        padded, r = self.letterbox(img, self.exp.test_size, dtype=np.uint8)
        t0 = time.time()
        d = self.fwd(torch.as_tensor(padded[None]))
        d = [t.cpu().numpy() for t in d]
        infer_time = time.time() - t0
        boxes, obj, score, cls_id, mask = (t[0] for t in d)
        return boxes[mask] / r, (obj * score)[mask], cls_id[mask], infer_time


def run(args):
    """The demo for parsed `args`: a list of (file, drawn image, boxes,
    scores, class ids, ms) per image."""
    from tscd_torch.data.image import imread, imwrite
    from tscd_torch.exp import get_exp
    from tscd_torch.tools.tscd_eval import int8_serving
    from tscd_torch.utils.visualize import vis

    if args.demo in ("video", "webcam"):
        raise NotImplementedError(f"demo {args.demo!r} needs cv2.VideoCapture's decoders, "
                                  "which the port does not have; run `image` on frames")
    if args.demo != "image":
        raise ValueError(f"demo {args.demo!r}: image, video or webcam")
    exp = get_exp(args.exp_file, None if args.exp_file else (args.name or "yolox_s"))
    exp.merge(args.opts)
    if args.tsize:
        exp.test_size = (args.tsize, args.tsize)
    predictor = Predictor(exp, args.ckpt, args.conf, args.nms, args.device)
    mode = int8_serving(args, predictor.model)
    save_dir = os.path.join(exp.output_dir, exp.exp_name, "vis_res")
    files = [args.path] if os.path.isfile(args.path) else get_image_list(args.path)
    results = []
    with mode:
        for f in files:
            img = imread(f)
            boxes, scores, cls_ids, dt = predictor.inference(img)
            print(f"{f}: {len(boxes)} dets in {dt * 1000:.1f} ms")
            out = vis(img, boxes, scores, cls_ids, args.conf, COCO_CLASSES)
            if args.save_result:
                os.makedirs(save_dir, exist_ok=True)
                imwrite(os.path.join(save_dir, os.path.basename(f)), out)
            results.append((f, out, boxes, scores, cls_ids, dt * 1000))
    return results


def main(argv=None):
    # intermixed: the exp overrides may follow the flags after `demo`
    return run(make_parser().parse_intermixed_args(argv))


if __name__ == "__main__":
    main()
