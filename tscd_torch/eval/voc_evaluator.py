"""VOC evaluator, the port's copy of tscd_tpu/eval/voc_evaluator.py
(reference: yolox/evaluators/voc_evaluator.py): runs a predict_fn over a
VOCDetection dataset and scores with the VOC protocol."""

import time
from typing import Callable, Dict

import numpy as np

from ..data.voc import VOC_CLASSES, voc_eval


class VOCEvaluator:
    def __init__(self, dataset, img_size=(640, 640), confthre=0.01,
                 nmsthre=0.65, num_classes=20, batch_size: int = 8,
                 use_07_metric: bool = False):
        self.dataset = dataset
        self.img_size = tuple(img_size)
        self.confthre = confthre
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.use_07 = use_07_metric

    def evaluate(self, predict_fn: Callable, log=print) -> Dict:
        from ..data.transforms import letterbox
        dets, gts = {}, {}
        B = self.batch_size
        H, W = self.img_size
        t0 = time.time()
        n = 0
        for start in range(0, len(self.dataset), B):
            idxs = range(start, min(start + B, len(self.dataset)))
            imgs = np.full((B, H, W, 3), 114.0, np.float32)
            metas = []
            for bi, i in enumerate(idxs):
                img, res, (h0, w0), img_id = self.dataset.pull_item(i)
                # difficult GTs must be present (ignored, not FPs)
                if hasattr(self.dataset, "load_anno"):
                    res = self.dataset.load_anno(i, keep_difficult=True)
                padded, r = letterbox(img, self.img_size)
                imgs[bi] = padded
                metas.append((img_id, r, res))
            outs = predict_fn(imgs)
            n += len(metas)
            for bi, (img_id, r, res) in enumerate(metas):
                rows = np.asarray(outs[bi], np.float32).reshape(-1, 7)
                rows[:, :4] /= r
                dets[img_id] = rows
                gts[img_id] = res
        result = voc_eval(dets, gts, self.num_classes,
                          use_07_metric=self.use_07)
        log(f"VOC mAP50 = {result['mAP']:.4f} "
            f"({1000 * (time.time() - t0) / max(n, 1):.1f} ms/img)")
        return result
