"""int8 (w8a8) serving accuracy at production channel widths, on the port
(counterpart of tools/measure_int8_accuracy_width.py).

    python -m tscd_torch.tools.measure_int8_accuracy_width [--epochs 150]
        [--width 1.0] [--depth 1.0] [--size 320] [--imgs 64]
        [--workdir DIR] [--device cpu]

The JAX tool's protocol, on the card unless --device says otherwise:

  1. a synthetic 4-class COCO ({square, tall rectangle} x {gray 118, gray
     142} on a textured background: the classes hinge on a 24-level
     intensity margin, which per-tensor activation quantization blurs
     first) at 320 px, written as JPEG (quality 95) by the port's encoder,
     the bytes cv2.imwrite gives;
  2. YOLOX (depth and width 1.0 by default) trained through the port's
     still-image Trainer;
  3. the same EMA weights evaluated fp, int8 dynamic and int8 static
     (calibrated on 4 of the images, SmoothQuant-equalized), with the
     default C_in gates.

Prints one JSON line, the JAX tool's: the model, each precision's mAP and
AP50, and the two drops.
"""

import argparse
import json
import os
import sys
import tempfile


def make_dataset(root, n_imgs=64, size=320, n_classes=4):
    """The JAX tool's dataset, image for image and byte for byte: each
    rectangle is filled from (x0, y0) to (x0 + w, y0 + h), both corners
    included, as cv2.rectangle(..., -1) fills it."""
    import numpy as np

    from tscd_torch.data.image import imwrite

    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(root, "train2017"), exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_imgs):
        img = rng.integers(60, 100, (size, size, 3)).astype(np.uint8)
        n_obj = int(rng.integers(1, 4))
        for _ in range(n_obj):
            cls = int(rng.integers(0, n_classes))
            tall = cls % 2
            gray = 118 if cls < 2 else 142
            w = int(rng.integers(40, 80))
            h = int(w * (2.0 if tall else 1.0))
            x0 = int(rng.integers(0, size - w))
            y0 = int(rng.integers(0, size - h))
            img[y0:y0 + h + 1, x0:x0 + w + 1] = gray
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": cls + 1,
                "bbox": [x0, y0, w, h], "area": w * h, "iscrowd": 0})
            ann_id += 1
        fn = f"{i:012d}.jpg"
        imwrite(os.path.join(root, "train2017", fn), img)
        images.append({"id": i, "file_name": fn, "width": size, "height": size})
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": c + 1, "name": f"cat{c}"} for c in range(n_classes)]}
    for name in ("instances_train2017.json", "instances_val2017.json"):
        with open(os.path.join(root, "annotations", name), "w") as f:
            json.dump(coco, f)
    return root


def make_exp(root, work, epochs, depth, width, size):
    """The JAX tool's exp file, as a port YOLOXExp."""
    from tscd_torch.exp.yolox_base import YOLOXExp

    exp = YOLOXExp()
    exp.depth, exp.width = depth, width
    exp.num_classes = 4
    exp.input_size = exp.test_size = (size, size)
    exp.batch_size = 8
    exp.max_epoch = epochs
    exp.no_aug_epochs = epochs * 2 // 3
    exp.eval_interval = 100000
    exp.basic_lr_per_img = 0.10 / 64
    exp.warmup_epochs = 5
    exp.data_dir = root
    exp.train_name = exp.val_name = "train2017"
    exp.output_dir = os.path.join(work, "out")
    exp.exp_name = "int8_width"
    exp.enable_mixup = False
    exp.mosaic_prob = 0.0
    exp.flip_prob = 0.0
    exp.seed = 0
    return exp


def main(argv=None):
    ap = argparse.ArgumentParser("measure_int8_accuracy_width (PyTorch port)")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--depth", type=float, default=1.0)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--imgs", type=int, default=64)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; the card (cuda) unless given")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tscd_torch.core.trainer import make_predict_fn
    from tscd_torch.data.image import imread
    from tscd_torch.models.blocks import int8_eval, quantize_int8
    from tscd_torch.utils.model_utils import prepare_int8, set_int8_scales

    work = args.workdir or tempfile.mkdtemp(prefix="int8_width_")
    root = make_dataset(os.path.join(work, "coco"), n_imgs=args.imgs, size=args.size)
    exp = make_exp(root, work, args.epochs, args.depth, args.width, args.size)
    trainer = exp.get_trainer(None, device=args.device)
    # the weights are never reloaded: skip the per-epoch checkpoint writes
    trainer.save_ckpt = lambda *a, **k: None
    state = trainer.train()
    model = exp.get_model(device=trainer.device)
    model.load_state_dict(state.ema.state_dict())
    model.eval()
    evaluator = exp.get_evaluator()

    def ap_of():
        res = evaluator.evaluate(make_predict_fn(model, exp.num_classes, exp.test_conf,
                                                 exp.nmsthre))
        return {"mAP": round(float(res["mAP"]), 4), "AP50": round(float(res["AP50"]), 4)}

    res = {"model": f"yolox d{args.depth} w{args.width} @{args.size}px (default C_in gates)"}
    res["fp"] = ap_of()
    prepare_int8(model)
    with int8_eval():
        res["int8_dynamic"] = ap_of()
    # static: calibrate on 4 in-distribution images (RGB, as the JAX tool
    # feeds them) through the PTQ observer (fp forward + per-C_in maxima)
    calib = np.stack([imread(os.path.join(root, "train2017", f"{i:012d}.jpg"))[:, :, ::-1]
                      .astype(np.float32) for i in range(4)])
    scales = quantize_int8(model, torch.from_numpy(calib).to(trainer.device), False, True)
    set_int8_scales(model, scales)
    with int8_eval(static=True):
        res["int8_static"] = ap_of()
    res["drop_dynamic"] = round(res["fp"]["mAP"] - res["int8_dynamic"]["mAP"], 4)
    res["drop_static"] = round(res["fp"]["mAP"] - res["int8_static"]["mAP"], 4)
    if trainer.device.type == "cuda":
        res["device"] = torch.cuda.get_device_name(trainer.device)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(main() and 0)
