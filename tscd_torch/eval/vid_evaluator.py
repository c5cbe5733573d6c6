"""Video evaluator (counterpart of tscd_tpu/eval/vid_evaluator.py;
reference vid_evaluator_v2.py:41 and ovis_evaluator_v2.py:36, which
differ only in the category table).

Iterates the loader's windows, sets `resume` from the frame index (a
video's first frame resets the matcher bank), converts the refined
detections and the ground truth to COCO dicts and scores them with the
native COCO evaluator. With a predict function that has `.dispatch` and
`.materialize`, window i + 1 is dispatched before window i is read back,
so the host's work on one window overlaps the card's on the next. The
"Average inference time" counts dispatch and materialize only, as the
reference does. `traj_linking` rescores each video's detections by their
tubelets' mean (postprocess/linking.py) before scoring, as JAX's does.
"""

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..data.vid import VID_CLASSES, frame_index
from .coco_api import COCO
from .fast_cocoeval import COCOeval_opt as COCOeval


class VIDEvaluator:
    def __init__(self, dataloader, img_size=(576, 576), confthre=0.001,
                 nmsthre=0.5, num_classes=30,
                 class_names: Optional[Sequence[str]] = None,
                 lframe=1, gframe=31, first_frame_index: int = 0,
                 traj_linking: bool = False):
        self.dataloader = dataloader
        self.img_size = img_size
        self.confthre = confthre
        self.nmsthre = nmsthre      # applied inside predict_fn; kept for reports
        self.num_classes = num_classes
        self.class_names = list(class_names or VID_CLASSES[:num_classes])
        self.lframe = lframe
        self.gframe = gframe
        self.first_frame_index = first_frame_index
        # tubelet-averaged rescoring over each video before COCO scoring
        # (postprocess/linking.py:post_linking)
        self.traj_linking = traj_linking

    def _linked(self, windows):
        """With traj_linking, holds each video's windows (a video: the
        directory of a window's first frame) and yields them with
        post_linking applied over the video's local frames."""
        if not self.traj_linking:
            yield from windows
            return
        from ..postprocess.linking import post_linking
        buf, video = [], None

        def flush():
            linked = post_linking([d for _, ds in buf for d in ds])
            k = 0
            for b, ds in buf:
                yield b, linked[k:k + len(ds)]
                k += len(ds)

        for batch, dets in windows:
            v = os.path.dirname(batch["paths"][0])
            if video is not None and v != video and buf:
                yield from flush()
                buf = []
            video = v
            buf.append((batch, dets))
        if buf:
            yield from flush()

    def _windows(self, predict_fn: Callable, timing: Dict[str, float]):
        """Yields (batch, per-local-frame detection rows) in loader order,
        adding the seconds spent in the predict calls to timing["forward"]."""
        state = None
        if not hasattr(predict_fn, "dispatch"):
            for batch in self.dataloader:
                t0 = time.perf_counter()
                dets, state = predict_fn(batch["imgs"], batch["time_embedding"],
                                         self._resume(batch), state)
                timing["forward"] += time.perf_counter() - t0
                yield batch, dets
            return
        pending = None
        for batch in self.dataloader:
            t0 = time.perf_counter()
            dev, state = predict_fn.dispatch(batch["imgs"], batch["time_embedding"],
                                             self._resume(batch), state)
            timing["forward"] += time.perf_counter() - t0
            if pending is not None:
                t0 = time.perf_counter()
                dets = predict_fn.materialize(pending[1])
                timing["forward"] += time.perf_counter() - t0
                yield pending[0], dets
            pending = (batch, dev)
        if pending is not None:
            t0 = time.perf_counter()
            dets = predict_fn.materialize(pending[1])
            timing["forward"] += time.perf_counter() - t0
            yield pending[0], dets

    def evaluate(self, predict_fn: Callable, log=print) -> Dict:
        """predict_fn(imgs (F, H, W, 3), time_emb (F, 256), resume, state)
        -> (detection rows of each local frame, new state); rows are
        (K, 7) numpy [x1, y1, x2, y2, obj, score, cls]."""
        data_list: List[dict] = []
        gt_annotations: List[dict] = []
        images: List[dict] = []
        ann_id, image_id, n_samples = 1, 0, 0
        timing = {"forward": 0.0}
        for batch, dets_frames in self._linked(self._windows(predict_fn, timing)):
            n_samples += len(dets_frames)
            for f, dets in enumerate(dets_frames):
                img_h, img_w = batch["infos"][f]
                scale = min(self.img_size[0] / img_h, self.img_size[1] / img_w)
                images.append({"id": image_id, "width": img_w, "height": img_h,
                               "file_name": batch["paths"][f]})
                for row in dets:
                    x1, y1, x2, y2, obj, score, cls = row[:7]
                    s = float(obj) * float(score)
                    if s <= 0 or s < self.confthre:
                        continue
                    data_list.append({
                        "image_id": image_id, "category_id": int(cls) + 1,
                        "bbox": [float(x1) / scale, float(y1) / scale,
                                 float(x2 - x1) / scale, float(y2 - y1) / scale],
                        "score": s})
                # labels are [cls, x1, y1, x2, y2] in letterboxed pixels
                for lab in batch["labels"][f]:
                    if lab[1:].sum() == 0:
                        continue
                    x1, y1, x2, y2 = (lab[1] / scale, lab[2] / scale,
                                      lab[3] / scale, lab[4] / scale)
                    gt_annotations.append({
                        "id": ann_id, "image_id": image_id,
                        "category_id": int(lab[0]) + 1,
                        "bbox": [float(x1), float(y1),
                                 float(x2 - x1), float(y2 - y1)],
                        "area": float((x2 - x1) * (y2 - y1)), "iscrowd": 0})
                    ann_id += 1
                image_id += 1

        if not data_list:
            log("no predictions")
            return {"mAP": 0.0, "AP50": 0.0}
        gt = COCO({"images": images,
                   "categories": [{"id": i + 1, "name": n}
                                  for i, n in enumerate(self.class_names)],
                   "annotations": gt_annotations})
        e = COCOeval(gt, gt.loadRes(data_list), "bbox")
        e.evaluate()
        e.accumulate()
        stats = e.summarize()
        avg_ms = 1000 * timing["forward"] / max(n_samples, 1)
        log(f"mAP 0.5:0.95 = {stats[0]:.4f}  AP50 = {stats[1]:.4f}")
        log(f"Average inference time: {avg_ms:.2f} ms/frame "
            f"({1000.0 / max(avg_ms, 1e-9):.1f} fps)")
        return {"mAP": float(stats[0]), "AP50": float(stats[1]),
                "per_class_AP50": e.per_class_ap(iouThr=0.5),
                "per_class_AP": e.per_class_ap(),
                "per_class_AR": e.per_class_ar(),
                "ms_per_frame": avg_ms,
                "stats": stats.tolist()}

    def _resume(self, batch) -> bool:
        """False at a video's first frame (the sequence start)."""
        return self._first_frame_idx(batch) != self.first_frame_index

    def _first_frame_idx(self, batch) -> int:
        return frame_index(batch["paths"][0])


OVIS_CLASSES = [
    "Person", "Bird", "Cat", "Dog", "Horse", "Sheep", "Cow", "Elephant",
    "Bear", "Zebra", "Giraffe", "Poultry", "Giant_panda", "Lizard",
    "Parrot", "Monkey", "Rabbit", "Tiger", "Fish", "Turtle", "Bicycle",
    "Motorcycle", "Airplane", "Boat", "Vehical"]


class OVISEvaluator(VIDEvaluator):
    def __init__(self, dataloader, img_size=(576, 576), confthre=0.001,
                 nmsthre=0.5, num_classes=25, lframe=8, gframe=24, **kw):
        super().__init__(dataloader, img_size, confthre, nmsthre,
                         num_classes, OVIS_CLASSES[:num_classes],
                         lframe, gframe, **kw)
