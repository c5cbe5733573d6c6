"""Stage-2 TSCD trainer of the port (counterpart of
tscd_tpu/core/tscd_trainer.py:44-140,288-394,474-499; reference
yolox/core/tscd_trainer.py:90), on one card, fp32: `exp.window_batch`
windows a step (0 meaning one, as on one card in JAX), the LR schedule
times that count, `grad_accum`, `fix_bn` (else train-mode BatchNorm,
whose statistics the step averages over the windows),
`stop_backbone_grad` and `remat_backbone` as JAX's trainer runs them.

JAX runs a step as one jitted program; here a step is an eager forward,
backward, grouped SGD and EMA (`train.step.train_step`). The loader's
background thread collates the next window into pinned memory while the
card runs this one; the step uploads it with non_blocking copies and
reads back only the scalar losses. Every epoch is augmented (HSV jitter
and flip), as JAX's trainer builds its one loader with `no_aug` left
False (tscd_tpu/core/tscd_trainer.py:288-299); `no_aug_epochs` shapes
only the LR schedule, as there. With `enable_multiscale` the window is
resized to a size re-drawn every 10 iterations from
`random.Random(step)`, JAX's sizes (:337-360), into float32 frames with
the values of JAX's cv2.resize of its float32 window (each window of a
batch, as JAX flattens the window axis).
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
from ..train.checkpoint import load_checkpoint, load_tolerant, save_checkpoint
from ..train.step import TrainState, init_train_state, train_step

CKPT_EVERY = 2000    # updates between in-epoch checkpoints (tscd_trainer.py:346)


class TSCDTrainer:
    """`train()` runs the exp's epochs from `start_epoch` (the `args`
    flag, or a resumed checkpoint's) and returns the TrainState;
    `evaluate()` scores the EMA weights with the port's VIDEvaluator."""

    def __init__(self, exp, args=None, val_loader=None, device=None):
        exp.check_train_knobs()
        self.exp = exp
        self.args = args
        if exp.seed is not None:     # the host RNGs (utils/seeding.py)
            random.seed(int(exp.seed))
            np.random.seed(int(exp.seed) & 0xFFFFFFFF)
            torch.manual_seed(int(exp.seed))
        self.rng = np.random.default_rng(exp.seed)
        self.device = resolve_device(device)
        self.val_loader = val_loader
        self.lframe, self.gframe = exp.lframe, exp.gframe
        self.window_batch = exp.windows_per_step
        self.max_epoch = exp.max_epoch
        self.file_name = os.path.join(exp.output_dir, exp.exp_name)
        self.start_epoch = int(getattr(args, "start_epoch", None) or 0)
        self.best_ap = 0.0
        self.model = exp.get_model(device=self.device)
        self.state: Optional[TrainState] = None
        self.dataset = None
        self.meter: Dict[str, List[float]] = {}
        self._eval_model = None
        self._ms_size = None

    # -- setup ---------------------------------------------------------
    def _init_state(self, iters: int):
        """Seeded weights, then a resumed or fine-tune checkpoint (a port
        `.pth` or a JAX `.msgpack`), the optimizer and the EMA."""
        exp, model = self.exp, self.model
        random_init_(model, exp.seed or 0)
        args = self.args
        ckpt_path = getattr(args, "ckpt", None)
        opt_ckpt = None
        if getattr(args, "resume", False):
            path = ckpt_path or os.path.join(self.file_name, "latest_ckpt.pth")
            restored = load_checkpoint(path, model)
            self.start_epoch = int(restored.get("start_epoch", 0))
            model.load_state_dict(load_tolerant(model.state_dict(), restored["model"]))
            opt_ckpt = restored.get("optimizer")     # momentum survives a resume
            print(f"resumed from {path} at epoch {self.start_epoch}")
        elif ckpt_path:
            # fine-tune load: shape-tolerant (the 2-stage recipe)
            restored = load_checkpoint(ckpt_path, model)
            model.load_state_dict(load_tolerant(model.state_dict(),
                                                restored.get("model", restored)))
            print(f"loaded fine-tune weights from {ckpt_path}")
        opt = exp.get_optimizer(model, iters, window_batch=self.window_batch)
        if opt_ckpt is None or not opt.load_state_dict(opt_ckpt):
            opt.count = self.start_epoch * iters
        self.state = init_train_state(model, opt, exp.ema_decay)

    def _loader(self, epoch: int):
        """The epoch's loader: augmented at every epoch, as JAX's;
        `window_batch` windows a batch."""
        return self.exp.get_data_loader(pin_memory=self.device.type == "cuda",
                                        rng=self.rng, dataset=self.dataset,
                                        batch_windows=self.window_batch)

    def multiscale_size(self, n: int):
        """The size iteration `n` of an epoch trains at, re-drawn when n is
        a multiple of 10 from random.Random(updates made so far)."""
        if n % 10 == 0 or self._ms_size is None:
            self._ms_size = self.exp.random_input_size(random.Random(self.state.step))
        return self._ms_size

    # -- train ---------------------------------------------------------
    def train(self) -> TrainState:
        exp = self.exp
        self.dataset = exp.get_train_dataset()
        iters = max(len(self.dataset.res) // self.window_batch, 1)
        self._init_state(iters)
        print(f"training {exp.exp_name}: {self.max_epoch} epochs x {iters} steps of "
              f"{self.window_batch} window(s) from epoch {self.start_epoch}")
        for epoch in range(self.start_epoch, self.max_epoch):
            t_epoch = time.time()
            data_t0 = time.time()
            for n, batch in enumerate(self._loader(epoch)):
                self._one_iter(batch, epoch, n, iters, data_t0)
                data_t0 = time.time()
            ci = exp.ckpt_interval or 1
            if (epoch + 1) % ci == 0 or epoch + 1 == self.max_epoch:
                self.save_ckpt(epoch)
            if (epoch + 1) % exp.eval_interval == 0:
                ap = self.evaluate()
                if ap > self.best_ap:
                    self.best_ap = ap
                    self.save_ckpt(epoch, is_best=True)
            print(f"epoch {epoch + 1}/{self.max_epoch} done in "
                  f"{time.time() - t_epoch:.0f}s")
        return self.state

    def _upload(self, batch):
        dev = self.device
        pin = dev.type == "cuda"
        frames = torch.as_tensor(batch["imgs"])
        labels = torch.as_tensor(batch["labels"])
        te = torch.as_tensor(batch["time_embedding"], dtype=torch.float32)
        if pin:
            labels = labels.pin_memory()
        return tuple(t.to(dev, non_blocking=True) for t in (frames, labels, te))

    def step(self, frames, labels, te) -> Dict[str, torch.Tensor]:
        """One update on a window (or a batch of windows) already on the
        device."""
        exp = self.exp
        return train_step(self.state, frames, labels, te, self.lframe,
                          self.gframe, ota_mode=exp.ota_mode, fix_bn=exp.fix_bn)

    def _one_iter(self, batch, epoch: int, n: int, iters: int, data_t0: float):
        if self.exp.enable_multiscale:
            imgs, labels = np.asarray(batch["imgs"]), np.asarray(batch["labels"])
            lead = imgs.shape[:-3]           # (F,) or (B, F): resized frame by frame
            imgs, labels = multiscale_resize(imgs.reshape((-1,) + imgs.shape[-3:]),
                                             labels.reshape((-1,) + labels.shape[-2:]),
                                             self.multiscale_size(n))
            batch = dict(batch, imgs=imgs.reshape(lead + imgs.shape[1:]),
                         labels=labels.reshape(lead + labels.shape[1:]))
        frames, labels, te = self._upload(batch)
        data_time = time.time() - data_t0
        t0 = time.time()
        losses = self.step(frames, labels, te)
        # one scalar readback, which also waits for the step
        host = dict(zip(losses, torch.stack(list(losses.values())).tolist()))
        iter_time = time.time() - t0
        for k, v in dict(host, iter_time=iter_time, data_time=data_time).items():
            self.meter.setdefault(k, []).append(v)
        if self.state.step % CKPT_EVERY == 0:
            self.save_ckpt(epoch)
        pi = self.exp.print_interval
        if (n + 1) % pi == 0:
            recent = {k: v[-pi:] for k, v in self.meter.items()}
            left = iters - n - 1 + (self.max_epoch - epoch - 1) * iters
            eta = datetime.timedelta(seconds=int(left * np.mean(self.meter["iter_time"])))
            mem = (torch.cuda.max_memory_allocated(self.device) / 2 ** 20
                   if self.device.type == "cuda" else 0.0)
            print(f"epoch {epoch + 1} iter {n + 1}/{iters} mem {mem:.0f}MB "
                  f"iter {np.mean(recent['iter_time']):.3f}s "
                  f"data {np.mean(recent['data_time']):.3f}s ETA {eta} | "
                  + ", ".join(f"{k}: {host[k]:.3f}" for k in host))

    # -- eval ------------------------------------------------------------
    def evaluate(self) -> float:
        """AP50 of the EMA weights on the exp's val windows (or the
        trainer's `val_loader`)."""
        exp = self.exp
        if self.state is None:
            raise RuntimeError("no state to evaluate")
        if self._eval_model is None:
            self._eval_model = exp.get_model(device=self.device)
        model = self._eval_model
        model.load_state_dict(self.state.ema.state_dict())
        model.eval()
        loader = self.val_loader or exp.get_eval_loader(
            pin_memory=self.device.type == "cuda")
        res = exp.get_evaluator(loader).evaluate(exp.get_predict_fn(model))
        return float(res.get("AP50", 0.0))

    # -- ckpt ------------------------------------------------------------
    def checkpoint(self, epoch: int) -> Dict:
        st = self.state
        return {"start_epoch": epoch + 1, "step": st.step,
                "model": st.ema.state_dict(),
                "raw_model": st.model_state(),
                "optimizer": st.optimizer.state_dict()}

    def save_ckpt(self, epoch: int, is_best: bool = False) -> str:
        path = save_checkpoint(self.checkpoint(epoch), self.file_name,
                               is_best=is_best)
        print(f"saved checkpoint {path}")
        return path
