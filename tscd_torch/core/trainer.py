"""Still-image YOLOX trainer of the port (counterpart of
tscd_tpu/core/trainer.py; reference yolox/core/trainer.py:36), on one card
in fp32: mosaic, perspective and mixup batches from a background loader;
each step a train-mode-BN forward, yolox_loss, backward, grouped SGD and
EMA (`train.step.yolox_train_step`, `grad_accum` chunks); for the last
`no_aug_epochs` mosaic and mixup off and the L1 term on; with
`enable_multiscale` a size re-drawn every 10 iterations from
random.Random(updates so far), JAX's rule; a checkpoint every
`ckpt_interval` epochs (momentum kept), eval of the EMA weights every
`eval_interval`, keeping the best AP50. Resumes from a port `.pth` or a
JAX `.msgpack` checkpoint (`train.checkpoint.load_checkpoint`).

The augmentation draws come from `random.Random(seed)` and
`np.random.RandomState(seed)`, the generators JAX's seeded globals are, in
JAX's order; the loader renders each batch's images on a pool of threads.
"""

import datetime
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.vid import multiscale_resize
from ..device import resolve_device
from ..models.tscd import random_init_
from ..ops.postprocess import postprocess_dense
from ..train.checkpoint import load_checkpoint, load_tolerant, save_checkpoint
from ..train.step import TrainState, init_train_state, yolox_train_step


def make_predict_fn(model, num_classes: int, conf_thre: float, nms_thre: float,
                    out_k: int = 100):
    """predict(imgs (B, H, W, 3) numpy) -> per image its (K, 7) numpy rows
    [x1, y1, x2, y2, obj, score, cls] (JAX's Trainer.make_predict_fn): the
    forward in eval mode and postprocess_dense on `model`'s device."""
    dev = model.device

    @torch.no_grad()
    def predict(imgs):
        x = torch.as_tensor(np.ascontiguousarray(imgs)).to(dev, non_blocking=True)
        d = postprocess_dense(model(x, decode=True)["decoded"], num_classes, conf_thre,
                              nms_thre, out_k)
        rows = torch.cat([d.boxes, d.obj[..., None], d.score[..., None],
                          d.cls_id[..., None].float()], -1).cpu().numpy()
        mask = d.mask.cpu().numpy()
        return [rows[b][mask[b]] for b in range(len(rows))]
    return predict


class Trainer:
    """`train()` runs the exp's epochs from the start (or a resumed
    checkpoint's epoch) and returns the TrainState; `evaluate()` scores the
    EMA weights with the exp's COCOEvaluator."""

    def __init__(self, exp, args=None, device=None):
        exp.check_train_knobs()
        self.exp = exp
        self.args = args
        seed = exp.seed
        if seed is not None:          # JAX's seed_everything (utils/seeding.py)
            random.seed(int(seed))
            np.random.seed(int(seed) & 0xFFFFFFFF)
            torch.manual_seed(int(seed))
        self.rng = random.Random(None if seed is None else int(seed))
        self.np_rng = np.random.RandomState(None if seed is None else int(seed) & 0xFFFFFFFF)
        self.device = resolve_device(device)
        self.file_name = os.path.join(exp.output_dir, exp.exp_name)
        self.best_ap = 0.0
        self.start_epoch = 0
        self.model = exp.get_model(device=self.device)
        self.state: Optional[TrainState] = None
        self.meter: Dict[str, List[float]] = {}
        self.iters_per_epoch = 0
        self._eval_model = None
        self._ms_size = None

    def _init_state(self):
        """Seeded weights, then a resumed or fine-tune checkpoint, the
        optimizer and the EMA."""
        exp, model, args = self.exp, self.model, self.args
        random_init_(model, exp.seed or 0)
        ckpt_path = getattr(args, "ckpt", None)
        opt_ckpt = None
        if getattr(args, "resume", False):
            path = ckpt_path or os.path.join(self.file_name, "latest_ckpt.pth")
            restored = load_checkpoint(path, model)
            self.start_epoch = int(restored.get("start_epoch", 0))
            model.load_state_dict(load_tolerant(model.state_dict(), restored["model"]))
            opt_ckpt = restored.get("optimizer")       # momentum survives a resume
            print(f"resumed from {path} at epoch {self.start_epoch}")
        elif ckpt_path:
            restored = load_checkpoint(ckpt_path, model)
            model.load_state_dict(load_tolerant(model.state_dict(),
                                                restored.get("model", restored)))
            print(f"loaded weights from {ckpt_path}")
        opt = exp.get_optimizer(model, self.iters_per_epoch)
        if opt_ckpt is None or not opt.load_state_dict(opt_ckpt):
            opt.count = self.start_epoch * self.iters_per_epoch
        self.state = init_train_state(model, opt, exp.ema_decay)

    def _loader(self, no_aug: bool):
        return self.exp.get_data_loader(no_aug=no_aug, rng=self.rng, np_rng=self.np_rng,
                                        img_dtype=np.uint8)

    def multiscale_size(self, n: int):
        if n % 10 == 0 or self._ms_size is None:
            self._ms_size = self.exp.random_input_size(random.Random(self.state.step))
        return self._ms_size

    def train(self) -> TrainState:
        exp = self.exp
        loader = self._loader(False)
        self.iters_per_epoch = loader.steps_per_epoch
        self._init_state()
        it, no_aug_it = iter(loader), None
        print(f"training {exp.exp_name}: {exp.max_epoch} epochs x {self.iters_per_epoch} "
              f"steps of {exp.batch_size} images from epoch {self.start_epoch}")
        try:
            for epoch in range(self.start_epoch, exp.max_epoch):
                no_aug = epoch >= exp.max_epoch - exp.no_aug_epochs
                if no_aug and no_aug_it is None:
                    it.close()
                    it = no_aug_it = iter(self._loader(True))
                    print("--> no mosaic aug, L1 loss on")
                t_epoch = time.time()
                data_t0 = time.time()
                for n in range(self.iters_per_epoch):
                    self._one_iter(next(it), epoch, n, no_aug, data_t0)
                    data_t0 = time.time()
                ci = exp.ckpt_interval or 1
                if (epoch + 1) % ci == 0 or epoch + 1 == exp.max_epoch:
                    self.save_ckpt(epoch)
                if (epoch + 1) % exp.eval_interval == 0:
                    ap = self.evaluate()
                    if ap > self.best_ap:
                        self.best_ap = ap
                        self.save_ckpt(epoch, is_best=True)
                print(f"epoch {epoch + 1}/{exp.max_epoch} done in {time.time() - t_epoch:.0f}s")
        finally:
            it.close()
        return self.state

    def _upload(self, imgs, labels):
        dev = self.device
        imgs, labels = torch.as_tensor(imgs), torch.as_tensor(labels)
        if dev.type == "cuda":
            imgs, labels = imgs.pin_memory(), labels.pin_memory()
        return imgs.to(dev, non_blocking=True), labels.to(dev, non_blocking=True)

    def step(self, images, labels, use_l1: bool = False) -> Dict[str, torch.Tensor]:
        """One update on a batch already on the device."""
        return yolox_train_step(self.state, images, labels, use_l1=use_l1,
                                grad_accum=int(self.exp.grad_accum or 1))

    def _one_iter(self, batch, epoch: int, n: int, no_aug: bool, data_t0: float):
        imgs, labels = batch["imgs"], batch["labels"]
        if self.exp.enable_multiscale and not no_aug:
            imgs, labels = multiscale_resize(imgs, labels, self.multiscale_size(n))
        images, labels = self._upload(imgs, labels)
        data_time = time.time() - data_t0
        t0 = time.time()
        losses = self.step(images, labels, use_l1=no_aug)
        host = dict(zip(losses, torch.stack(list(losses.values())).tolist()))
        iter_time = time.time() - t0
        for k, v in dict(host, iter_time=iter_time, data_time=data_time).items():
            self.meter.setdefault(k, []).append(v)
        pi = self.exp.print_interval
        if (n + 1) % pi == 0:
            left = (self.iters_per_epoch - n - 1
                    + (self.exp.max_epoch - epoch - 1) * self.iters_per_epoch)
            eta = datetime.timedelta(seconds=int(left * np.mean(self.meter["iter_time"])))
            mem = (torch.cuda.max_memory_allocated(self.device) / 2 ** 20
                   if self.device.type == "cuda" else 0.0)
            print(f"epoch {epoch + 1} iter {n + 1}/{self.iters_per_epoch} mem {mem:.0f}MB "
                  f"iter {np.mean(self.meter['iter_time'][-pi:]):.3f}s ETA {eta} | "
                  + ", ".join(f"{k}: {host[k]:.3f}" for k in host))

    def evaluate(self) -> float:
        """AP50 of the EMA weights on the exp's val set."""
        if self.state is None:
            raise RuntimeError("no state to evaluate")
        if self._eval_model is None:
            self._eval_model = self.exp.get_model(device=self.device)
        model = self._eval_model
        model.load_state_dict(self.state.ema.state_dict())
        exp = self.exp
        res = exp.get_evaluator().evaluate(make_predict_fn(model, exp.num_classes,
                                                           exp.test_conf, exp.nmsthre))
        return float(res.get("AP50", 0.0))

    def checkpoint(self, epoch: int) -> Dict:
        st = self.state
        return {"start_epoch": epoch + 1, "step": st.step, "model": st.ema.state_dict(),
                "raw_model": st.model_state(), "optimizer": st.optimizer.state_dict()}

    def save_ckpt(self, epoch: int, is_best: bool = False) -> str:
        path = save_checkpoint(self.checkpoint(epoch), self.file_name, is_best=is_best)
        print(f"saved checkpoint {path}")
        return path
