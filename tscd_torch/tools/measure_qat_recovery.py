"""QAT efficacy on the port (counterpart of tools/measure_qat_recovery.py):
does fine-tuning under `int8_eval(qat=True)` (the STE conv on the hand int8
kernels) recover the accuracy that int8 serving loses, where an
equal-budget fp fine-tune does not?

    python -m tscd_torch.tools.measure_qat_recovery [--alpha 64] [--n-out 4]
        [--ft-epochs 150] [--epochs 200] [--work DIR] [--device cpu]

The JAX tool's protocol, on the card unless --device says otherwise:

  1. a quantization-sensitive synthetic COCO (4 classes told apart only
     by grey levels 24 apart, 104 to 176, on a noisy grey-80 canvas, 12-20
     px boxes, 32 images at 96 x 128), written as JPEG by the port's
     encoder (quality 95; the JAX tool's cv2 writes quality 100);
  2. a tiny YOLOX (depth 0.33, width 0.125) trained on it for `--epochs`
     through the port's still-image Trainer (cached in the work dir);
  3. outlier channels injected into every Bottleneck's conv1 -> conv2
     pair: conv1's BN scale and bias x alpha on n_out channels, conv2's
     kernel slice / alpha (the fp function unchanged up to rounding,
     conv2's input activations alpha x hotter there);
  4. fp, int8 dynamic and int8 static (calibrated on 8 training images)
     mAP before; then two fine-tunes of the same budget (Adam 1e-5, NaN
     gradients zeroed, the global norm clipped at 1, fix_bn): fp (the
     control) and under int8_eval(qat=True); fp and int8 dynamic mAP
     after each, and the injected outliers' BN scale ratio after QAT.

The C_in gates are lowered to 16 so that the tiny model quantizes.
Prints one JSON dict of all measurements.
"""

import argparse
import json
import os
import random
import sys
import time


def make_hard_coco(root, n_imgs=32, size=(96, 128), n_cls=4, seed=3):
    """The JAX tool's task: per-class grey fill levels 24 apart on a noisy
    grey-80 canvas, 12-20 px boxes, 3 a image."""
    import numpy as np

    from tscd_torch.data.image import imwrite
    rng = np.random.default_rng(seed)
    h, w = size
    os.makedirs(os.path.join(root, "train2017"), exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_imgs):
        fn = f"{i:012d}.jpg"
        img = np.clip(rng.normal(80, 4, (h, w, 3)), 0, 255).astype(np.uint8)
        for _ in range(3):
            c = int(rng.integers(n_cls))
            bw = int(rng.integers(12, 21))
            bh = int(rng.integers(10, 17))
            x0 = int(rng.integers(2, w - bw - 2))
            y0 = int(rng.integers(2, h - bh - 2))
            img[y0:y0 + bh, x0:x0 + bw] = 104 + 24 * c
            annotations.append({"id": ann_id, "image_id": i, "category_id": c + 1,
                                "bbox": [x0, y0, bw, bh], "area": bw * bh, "iscrowd": 0})
            ann_id += 1
        imwrite(os.path.join(root, "train2017", fn), img)
        images.append({"id": i, "file_name": fn, "width": w, "height": h})
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": c + 1, "name": f"cat{c}"} for c in range(n_cls)]}
    for name in ("instances_train2017.json", "instances_val2017.json"):
        with open(os.path.join(root, "annotations", name), "w") as f:
            json.dump(coco, f)
    return root


def make_exp(root, work, epochs):
    """The JAX tool's exp file, as a port YOLOXExp."""
    from tscd_torch.exp.yolox_base import YOLOXExp
    exp = YOLOXExp()
    exp.depth, exp.width = 0.33, 0.125
    exp.num_classes = 4
    exp.input_size = exp.test_size = (96, 128)
    exp.batch_size = 8
    exp.max_epoch = epochs
    exp.no_aug_epochs = epochs
    exp.eval_interval = 1000
    exp.basic_lr_per_img = 0.2 / 64
    exp.warmup_epochs = 5
    exp.data_dir = root
    exp.train_name = exp.val_name = "train2017"
    exp.output_dir = os.path.join(work, "out")
    exp.exp_name = "qat_eff"
    exp.enable_mixup = False
    exp.mosaic_prob = 0.0
    exp.flip_prob = 0.0
    exp.seed = 0
    return exp


def inject_outliers(state, model, alpha, n_out, min_c=16):
    """Outlier-channel surgery on every Bottleneck whose conv2 is 3 x 3 with
    C_in >= min_c: conv1's BN scale and bias x alpha on the first n_out
    channels, conv2's kernel slice / alpha. Returns the new state_dict and
    the Bottlenecks' names."""
    from tscd_torch.models.blocks import Bottleneck
    new = {k: v.clone() for k, v in state.items()}
    injected = []
    for name, m in model.named_modules():
        if not isinstance(m, Bottleneck):
            continue
        conv2 = m.conv2.conv
        C = conv2.in_channels
        if conv2.kernel_size[0] != 3 or C < min_c or n_out >= C:
            continue
        if m.conv1.bn is None or m.conv1.bn.weight.shape[0] != C:
            continue
        new[f"{name}.conv1.bn.weight"][:n_out] *= alpha
        new[f"{name}.conv1.bn.bias"][:n_out] *= alpha
        new[f"{name}.conv2.conv.weight"][:, :n_out] /= alpha
        injected.append(name)
    return new, injected


def finetune(exp, model, state, n_epochs, device, qat=False, lr=1e-5):
    """`n_epochs` of the fix_bn fine-tune from `state`: Adam (lr), NaN
    gradients zeroed and the global norm clipped at 1 (optax's zero_nans,
    clip_by_global_norm, adam), every parameter trained, BN on its
    running statistics; under int8_eval(qat=True) with `qat`. Returns the
    new state_dict and the last loss."""
    import numpy as np
    import torch

    from tscd_torch.models.blocks import int8_eval
    from tscd_torch.train.losses import yolox_loss
    model.load_state_dict(state)
    model.train()
    params = [p for p in model.parameters()]
    opt = torch.optim.Adam(params, lr=lr)
    seed = exp.seed or 0
    loader = exp.get_data_loader(no_aug=True, rng=random.Random(seed),
                                 np_rng=np.random.RandomState(seed))
    it = iter(loader)
    last = None
    try:
        for _ in range(n_epochs * loader.steps_per_epoch):
            b = next(it)
            imgs = torch.as_tensor(b["imgs"]).to(device)
            labels = torch.as_tensor(b["labels"]).to(device)
            opt.zero_grad(set_to_none=True)
            with int8_eval(enable=qat, qat=qat):
                out = model(imgs, train=False, decode=False)
            losses = yolox_loss(out["outputs"], labels, out["hw"], (8, 16, 32), use_l1=True)
            losses["total_loss"].backward()
            grads = [p.grad for p in params if p.grad is not None]
            for g in grads:
                torch.nan_to_num_(g, nan=0.0, posinf=float("inf"), neginf=float("-inf"))
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in grads]))
            scale = torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm)
            for g in grads:
                g.mul_(scale)
            opt.step()
            last = losses["total_loss"].detach()
    finally:
        it.close()
    model.eval()
    return {k: v.clone() for k, v in model.state_dict().items()}, float(last)


def run(alpha=64.0, n_out=4, ft_epochs=150, epochs=200, work=None, device=None, verbose=True):
    import numpy as np
    import torch

    import tscd_torch.models.blocks as blocks
    from tscd_torch.core.trainer import make_predict_fn
    from tscd_torch.models.blocks import int8_eval, quantize_int8
    from tscd_torch.utils.model_utils import prepare_int8, set_int8_scales

    work = work or os.path.join("build", "qat_work")
    os.makedirs(work, exist_ok=True)
    say = print if verbose else (lambda *a, **k: None)
    root = make_hard_coco(os.path.join(work, "coco"))
    exp = make_exp(root, work, epochs)
    trainer = exp.get_trainer(None, device=device)
    trainer.save_ckpt = lambda *a, **k: None
    dev = trainer.device
    base_ckpt = os.path.join(work, f"base_{epochs}.pth")
    model = exp.get_model(device=dev)
    if os.path.exists(base_ckpt):
        model.load_state_dict(torch.load(base_ckpt)["model"])
        say("loaded cached base weights")
    else:
        t0 = time.time()
        st = trainer.train()
        model.load_state_dict(st.ema.state_dict())
        torch.save({"model": model.state_dict()}, base_ckpt)
        say(f"base train {time.time() - t0:.0f}s")
    model.eval()
    base = {k: v.clone() for k, v in model.state_dict().items()}
    evaluator = exp.get_evaluator()

    def ap(state, mode=None):
        model.load_state_dict(state)
        model.eval()
        predict = make_predict_fn(model, exp.num_classes, exp.test_conf, exp.nmsthre)
        if mode is None:
            r = evaluator.evaluate(predict, log=lambda *a: None)
        else:
            if not mode.get("static"):
                prepare_int8(model)
            with int8_eval(**mode):
                r = evaluator.evaluate(predict, log=lambda *a: None)
        return {"mAP": round(float(r["mAP"]), 4), "AP50": round(float(r["AP50"]), 4)}

    old_gates = (blocks.INT8_MIN_CIN, blocks.INT8_MIN_CIN_STATIC)
    blocks.INT8_MIN_CIN = blocks.INT8_MIN_CIN_STATIC = 16
    try:
        res = {"fp_base": ap(base)}
        say("fp base:", res["fp_base"])
        inj, injected = inject_outliers(base, model, alpha, n_out)
        say(f"injected {len(injected)} bottlenecks (alpha={alpha}, n={n_out})")
        res["fp_injected"] = ap(inj)
        res["int8_dyn_pre"] = ap(inj, {})
        # static, SmoothQuant-equalized: calibrated on 8 training images
        seed = exp.seed or 0
        loader = exp.get_data_loader(no_aug=True, rng=random.Random(seed),
                                     np_rng=np.random.RandomState(seed))
        it = iter(loader)
        calib = torch.as_tensor(next(it)["imgs"][:8]).to(dev)
        it.close()
        model.load_state_dict(inj)
        prepare_int8(model)
        set_int8_scales(model, quantize_int8(model, calib, False, True))
        res["int8_static_pre"] = ap(inj, {"static": True})
        say("pre:", res)

        # the control: the same budget in fp, so that any int8 recovery is QAT's
        t0 = time.time()
        ctl, res["ft_final_loss_ctl"] = finetune(exp, model, inj, ft_epochs, dev)
        res["ft_s_ctl"] = time.time() - t0
        res["fp_post_ctl"] = ap(ctl)
        res["int8_dyn_post_ctl"] = ap(ctl, {})
        t0 = time.time()
        qat, res["ft_final_loss_qat"] = finetune(exp, model, inj, ft_epochs, dev, qat=True)
        res["ft_s_qat"] = time.time() - t0
        g = qat[f"{injected[0]}.conv1.bn.weight"].abs().cpu().numpy()
        res["outlier_ratio_post"] = float(g[:n_out].min() / np.median(g[n_out:]))
        res["fp_post_qat"] = ap(qat)
        res["int8_dyn_post_qat"] = ap(qat, {})
        res["injected_bottlenecks"] = len(injected)
        if dev.type == "cuda":
            res["device"] = torch.cuda.get_device_name(dev)
        return res
    finally:
        blocks.INT8_MIN_CIN, blocks.INT8_MIN_CIN_STATIC = old_gates


def main(argv=None):
    ap = argparse.ArgumentParser("measure_qat_recovery (PyTorch port)")
    ap.add_argument("--alpha", type=float, default=64.0)
    ap.add_argument("--n-out", type=int, default=4)
    ap.add_argument("--ft-epochs", type=int, default=150)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--work", default=None, help="work dir (default build/qat_work)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; the card (cuda) unless given")
    args = ap.parse_args(argv)
    res = run(alpha=args.alpha, n_out=args.n_out, ft_epochs=args.ft_epochs,
              epochs=args.epochs, work=args.work, device=args.device)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(main() and 0)
