"""Makes the port's fixtures under tscd_torch/data/fixtures:

  - vid/: one ImageNet-VID-layout video of 32 frames at 1280 x 720 (JPEG
    quality 90, 4:2:0, written by cv2.imwrite), a seeded smooth synthetic
    scene with three moving objects, their XML annotations, the val list
    val_seq.npy, and frame_sha256.json: for each of these frames and the 16
    frames of YOLOX_outputs/validate_ref/vid, the sha256 of cv2.imread's
    pixels, of their cv2.resize letterbox to 576 px, of JAX's HSV jitter
    of that with fixed gains, and of the jittered frame's 576 x 576 window
    (114 padding) cast to float32 and resized to each multiscale size in
    MULTISCALE as JAX's trainer does, which chip_smoke.py checks the port's
    image ops against where there is no cv2;
  - jax_selftest_ckpt.msgpack: what the JAX package's TSCDTrainer saves
    after one epoch (epoch 0 of 2) of the selftest configuration (depth
    0.33, width 0.125, P = 6, 2 + 2 frames at 128 px, fix_bn) on
    YOLOX_outputs/validate_ref/vid, from seed 0, which chip_smoke.py
    resumes on the card.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_fixture.py

needs cv2 and jax, and rewrites both (`--frames-only`: vid/ alone); they
are the same for the same seeds, cv2 build and jax version."""

import hashlib
import json
import os
import sys

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tscd_torch", "data", "fixtures", "vid")
OLD = os.path.join(REPO, "YOLOX_outputs", "validate_ref", "vid")
VIDEO = "fix0"
FRAMES, H, W, QUALITY, SEED = 32, 720, 1280, 90, 11
# (wnid, size (h, w), start centre (y, x), velocity a frame (y, x), BGR)
OBJECTS = [("n02691156", (180, 300), (200, 260), (3.0, 14.0), (40, 60, 200)),
           ("n02958343", (140, 220), (500, 900), (-2.0, -9.0), (200, 120, 40)),
           ("n02084071", (220, 160), (380, 600), (4.0, 3.0), (60, 190, 90))]


HSV_GAINS = [3, 20, -20]
MULTISCALE = [(448, 448), (704, 704)]      # 576 -+ 2 x 64


def hsv_jitter(img: np.ndarray, gains) -> np.ndarray:
    """The JAX package's jitter (tscd_tpu/data/transforms.py:augment_hsv)
    with the gains given."""
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + gains[0]) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + gains[1], 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + gains[2], 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)


def sha256(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def frame(t: int, rng: np.random.Generator):
    """Frame t: a slowly shifting colour gradient, three soft-edged moving
    ellipses, low noise. Returns the image and its [wnid, x1, y1, x2, y2]."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([110 + 60 * np.sin(x / 170 + t / 9) + 30 * np.cos(y / 90),
                    120 + 50 * np.cos(y / 140 - t / 11) + 20 * np.sin(x / 60),
                    100 + 70 * np.sin((x + y) / 230 + t / 7)], -1)
    boxes = []
    for wnid, (oh, ow), (cy, cx), (vy, vx), bgr in OBJECTS:
        cy, cx = cy + vy * t, cx + vx * t
        d = ((y - cy) / (oh / 2)) ** 2 + ((x - cx) / (ow / 2)) ** 2
        alpha = np.clip((1.0 - d) * 6.0, 0.0, 1.0)[..., None]
        shade = 1.0 + 0.25 * np.sin((x - cx) / 25)[..., None]
        img = img * (1 - alpha) + np.asarray(bgr, np.float32) * shade * alpha
        x1, y1 = max(0, int(cx - ow / 2)), max(0, int(cy - oh / 2))
        x2, y2 = min(W, int(cx + ow / 2)), min(H, int(cy + oh / 2))
        boxes.append((wnid, x1, y1, x2, y2))
    img += rng.normal(0, 1.0, img.shape)
    return np.clip(img + 0.5, 0, 255).astype(np.uint8), boxes


def xml(boxes) -> str:
    objs = "".join(
        f"  <object><name>{n}</name>\n    <bndbox><xmin>{a}</xmin><ymin>{b}</ymin>"
        f"<xmax>{c}</xmax><ymax>{d}</ymax></bndbox>\n  </object>\n"
        for n, a, b, c, d in boxes)
    return (f"<annotation>\n  <size><width>{W}</width><height>{H}</height></size>\n"
            f"{objs}</annotation>\n")


def jax_checkpoint() -> str:
    """One epoch of JAX's stage-2 trainer on the selftest configuration,
    then its save_ckpt(0) (start_epoch 1), copied into the fixtures."""
    import shutil
    import tempfile
    import time

    from tscd_tpu.exp.tscd_base import Exp

    exp = Exp()
    exp.depth, exp.width, exp.heads = 0.33, 0.125, 4
    exp.defualt_p = exp.minimal_limit = exp.maximal_limit = 6
    exp.lframe, exp.gframe, exp.lframe_val, exp.gframe_val = 2, 2, 1, 3
    exp.input_size = exp.test_size = (128, 128)
    exp.data_dir = OLD
    exp.train_seq_path = exp.val_seq_path = os.path.join(OLD, "val_seq.npy")
    exp.max_epoch, exp.no_aug_epochs, exp.seed = 2, 1, 0
    exp.exp_name = "jax_selftest"
    with tempfile.TemporaryDirectory() as out:
        exp.output_dir = out
        trainer = exp.get_trainer()
        trainer.train_loader = exp.get_data_loader(batch_windows=1)
        trainer._init_state(next(iter(trainer.train_loader)))
        trainer._build_train_step()
        iters = len(trainer.train_loader)
        for n, batch in enumerate(trainer.train_loader):
            trainer._one_iter(batch, 0, n, iters, time.time())
        trainer.save_ckpt(0)
        dst = os.path.join(os.path.dirname(OUT), "jax_selftest_ckpt.msgpack")
        shutil.copyfile(os.path.join(out, exp.exp_name, "latest_ckpt.msgpack"), dst)
    return dst


def main() -> int:
    rng = np.random.default_rng(SEED)
    rels = []
    for t in range(FRAMES):
        img, boxes = frame(t, rng)
        rel = f"Data/VID/val/{VIDEO}/{t:06d}.JPEG"
        for path, write in ((rel, None), (rel.replace("Data", "Annotations")
                                          .replace("JPEG", "xml"), xml(boxes))):
            os.makedirs(os.path.dirname(os.path.join(OUT, path)), exist_ok=True)
            if write is None:
                cv2.imwrite(os.path.join(OUT, path), img,
                            [cv2.IMWRITE_JPEG_QUALITY, QUALITY,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
            else:
                with open(os.path.join(OUT, path), "w") as f:
                    f.write(write)
        rels.append(rel)
    seq = np.empty(1, object)
    seq[0] = rels
    np.save(os.path.join(OUT, "val_seq.npy"), seq, allow_pickle=True)
    hashes = {}
    for root, rel_paths in ((OUT, rels), (OLD, [p for v in np.load(
            os.path.join(OLD, "val_seq.npy"), allow_pickle=True).tolist() for p in v])):
        for rel in rel_paths:
            img = cv2.imread(os.path.join(root, rel))
            h, w = img.shape[:2]
            r = min(576 / h, 576 / w)
            boxed = cv2.resize(img, (int(w * r), int(h * r)), interpolation=cv2.INTER_LINEAR)
            jittered = hsv_jitter(boxed, HSV_GAINS)
            window = np.full((576, 576, 3), 114, np.float32)
            window[:jittered.shape[0], :jittered.shape[1]] = jittered
            hashes[os.path.relpath(os.path.join(root, rel), REPO)] = {
                "shape": list(img.shape), "sha256": sha256(img),
                "letterbox_576_sha256": sha256(boxed),
                "hsv_jitter_sha256": sha256(jittered),
                "multiscale_sha256": {f"{h}x{w}": sha256(cv2.resize(
                    window, (w, h), interpolation=cv2.INTER_LINEAR)) for h, w in MULTISCALE}}
    with open(os.path.join(OUT, "frame_sha256.json"), "w") as f:
        json.dump({"cv2": cv2.__version__, "hsv_gains": HSV_GAINS, "frames": hashes}, f,
                  indent=1)
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(OUT) for n in ns)
    print(f"{len(hashes)} frames hashed; fixture {total / 2 ** 20:.2f} MiB")
    if "--frames-only" in sys.argv:
        return 0
    ckpt = jax_checkpoint()
    print(f"{ckpt}: {os.path.getsize(ckpt) / 2 ** 20:.2f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
