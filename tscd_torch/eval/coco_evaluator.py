"""Still-image COCO evaluator (counterpart of
tscd_tpu/eval/coco_evaluator.py; reference yolox/evaluators/
coco_evaluator.py:103): the val set in fixed batches of B (the last one
padded with 114-gray images), each image letterboxed, the detections
scaled back to the image and scored by the native COCO evaluator, with
the per-class AP50 table. "Average inference time" counts the predict
calls only, as the reference does."""

import time
from typing import Callable, Dict, List

import numpy as np

from ..data.transforms import letterbox
from .fast_cocoeval import COCOeval_opt as COCOeval


def per_class_table(per_class: Dict[str, float], columns: int = 6) -> str:
    """Flat multi-column text table (reference per_class_AP_table); the
    values arrive in percent."""
    items = [f"{k:<18}{v:6.2f}" for k, v in per_class.items()]
    return "\n".join(" | ".join(items[i:i + columns]) for i in range(0, len(items), columns))


class COCOEvaluator:
    def __init__(self, dataset, img_size=(640, 640), confthre=0.01, nmsthre=0.65,
                 num_classes=80, batch_size: int = 8, per_class_ap: bool = True):
        self.dataset = dataset
        self.img_size = tuple(img_size)
        self.confthre = confthre
        self.nmsthre = nmsthre       # applied inside predict_fn; kept for reports
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.per_class_ap = per_class_ap

    def evaluate(self, predict_fn: Callable, log=print) -> Dict:
        """predict_fn(imgs (B, H, W, 3) uint8) -> per-image (K, 7) numpy
        rows [x1, y1, x2, y2, obj, score, cls]; a row with obj x score at
        or under confthre is dropped."""
        data_list: List[dict] = []
        n_samples = 0
        forward_time = 0.0
        B = self.batch_size
        H, W = self.img_size
        n = len(self.dataset)
        for start in range(0, n, B):
            imgs = np.full((B, H, W, 3), 114, np.uint8)
            metas = []
            for bi, idx in enumerate(range(start, min(start + B, n))):
                img, _, _, img_id = self.dataset.pull_item(idx)
                imgs[bi], r = letterbox(img, self.img_size, np.uint8)
                metas.append((img_id, r))
            t0 = time.perf_counter()
            dets_batch = predict_fn(imgs)
            forward_time += time.perf_counter() - t0
            n_samples += len(metas)
            for bi, (img_id, r) in enumerate(metas):
                for row in np.asarray(dets_batch[bi]):
                    x1, y1, x2, y2, obj, score, cls = row[:7]
                    s = float(obj) * float(score)
                    if s <= self.confthre:
                        continue
                    data_list.append({
                        "image_id": int(img_id),
                        "category_id": self.dataset.class_ids[int(cls)],
                        "bbox": [float(x1) / r, float(y1) / r, float(x2 - x1) / r,
                                 float(y2 - y1) / r],
                        "score": s})
        avg_ms = 1000 * forward_time / max(n_samples, 1)
        if not data_list:
            log("no predictions")
            return {"mAP": 0.0, "AP50": 0.0, "ms_per_image": avg_ms}
        gt = self.dataset.coco
        e = COCOeval(gt, gt.loadRes(data_list), "bbox")
        e.evaluate()
        e.accumulate()
        stats = e.summarize()
        log(f"mAP 0.5:0.95 = {stats[0]:.4f}  AP50 = {stats[1]:.4f}")
        log(f"Average inference time: {avg_ms:.2f} ms/img")
        result = {"mAP": float(stats[0]), "AP50": float(stats[1]), "ms_per_image": avg_ms,
                  "stats": stats.tolist()}
        if self.per_class_ap:
            pc = e.per_class_ap(iouThr=0.5)
            log(per_class_table(pc))
            result["per_class_AP50"] = pc
        return result
