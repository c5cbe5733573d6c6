"""REPP post-processing CLI of the port (counterpart of tools/REPP.py;
reference tools/REPPM.py:342-429): loads a val_to_imdb pickle, links
tubelets per video, re-scores and re-coordinates them, writes COCO-format
predictions (and optionally an imdb pickle), and optionally runs the
motion-mAP breakdown. Numpy on the host (`postprocess/`).

    python -m tscd_torch.tools.repp --predictions val_imdb.pkl \\
        --out preds_coco.json [--post] [--evaluate --annotations gts.pkl]
"""

import argparse
import json
import pickle

import numpy as np

from ..postprocess.motion_eval import vid_eval_motion
from ..postprocess.repp import REPP


def make_parser():
    p = argparse.ArgumentParser("REPP (PyTorch port)")
    p.add_argument("--predictions", required=True, help="val_to_imdb pickle")
    p.add_argument("--out", default="preds_repp_coco.json")
    p.add_argument("--imdb_out", default=None, help="optional rescored imdb pickle")
    p.add_argument("--post", action="store_true",
                   help="real REPP linking (otherwise identity pass, "
                        "reference REPPM.py:312-315)")
    p.add_argument("--min_tubelet_score", type=float, default=0.3)
    p.add_argument("--min_pred_score", type=float, default=0.01)
    p.add_argument("--recoordinate_std", type=float, default=1.0)
    p.add_argument("--clf_model", default=None,
                   help="logreg pair-classifier model: the reference's "
                        "matching_model_logreg.pckl or a JSON of coef, intercept, feats")
    p.add_argument("--clf_thr", type=float, default=0.7)
    p.add_argument("--clf_mode", default="dot", choices=["max", "dot", "dot_plus", "raw"])
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--annotations", default=None,
                   help="pickle of {video: {frame: (N,5) gt rows}} for --evaluate")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    with open(args.predictions, "rb") as f:
        preds = pickle.load(f)

    repp = REPP(min_tubelet_score=args.min_tubelet_score,
                min_pred_score=args.min_pred_score,
                recoordinate_std=args.recoordinate_std,
                clf_threshold=args.clf_thr, clf_mode=args.clf_mode,
                clf_model_path=args.clf_model, post=args.post)

    coco_out = []
    imdb_out = {}
    for video, frames in preds.items():
        names = sorted(frames.keys())
        processed = repp([frames[n] for n in names])
        imdb_out[video] = dict(zip(names, processed))
        for name, dets in zip(names, processed):
            for d in dets:
                smax = float(np.max(d["scores"])) if len(d["scores"]) else 0.0
                for cls, s in enumerate(np.asarray(d["scores"], float)):
                    if s < args.min_pred_score or s != smax:
                        continue
                    coco_out.append({
                        "image_id": d.get("image_id", f"{video}/{name}"),
                        "category_id": cls + 1,
                        "bbox": [float(v) for v in d["bbox"]],
                        "score": float(s),
                    })
    with open(args.out, "w") as f:
        json.dump(coco_out, f)
    print(f"wrote {args.out}: {len(coco_out)} predictions")
    if args.imdb_out:
        with open(args.imdb_out, "wb") as f:
            pickle.dump(imdb_out, f)

    result = None
    if args.evaluate:
        if not args.annotations:
            raise ValueError("--evaluate needs --annotations")
        with open(args.annotations, "rb") as f:
            gts = pickle.load(f)
        num_classes = len(next(iter(next(iter(preds.values())).values()))[0]["scores"]) \
            if any(any(frames.values()) for frames in preds.values()) else 30
        dets_pf, gts_pf = [], []
        for video, frames in imdb_out.items():
            for name in sorted(frames.keys()):
                rows = []
                for d in frames[name]:
                    cls = int(np.argmax(d["scores"]))
                    x, y, w, h = d["bbox"]
                    rows.append([x, y, x + w, y + h, 1.0, float(d["scores"][cls]), cls])
                dets_pf.append(np.asarray(rows, np.float32).reshape(-1, 7))
                gts_pf.append(np.asarray(gts.get(video, {}).get(name, np.zeros((0, 5))),
                                         np.float32).reshape(-1, 5))
        result = vid_eval_motion(dets_pf, gts_pf, num_classes=num_classes)
        print(result)
    return {"coco": coco_out, "imdb": imdb_out, "motion": result}


if __name__ == "__main__":
    main()
