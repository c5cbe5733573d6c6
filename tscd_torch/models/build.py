"""Model factory (counterpart of tscd_tpu/models/build.py; reference
yolox/models/build.py create_yolox_model:32): a name -> the port's model,
on the card unless `device` says otherwise. Weights come from a local
checkpoint (a JAX `.msgpack` or a `.pth`, as tscd_eval reads them); nothing
is downloaded."""

from typing import Dict, Optional

_YOLOX_CFG = {
    "yolox-nano": dict(depth=0.33, width=0.25, depthwise=True),
    "yolox-tiny": dict(depth=0.33, width=0.375),
    "yolox-s": dict(depth=0.33, width=0.50),
    "yolox-m": dict(depth=0.67, width=0.75),
    "yolox-l": dict(depth=1.0, width=1.0),
    "yolox-x": dict(depth=1.33, width=1.25),
}

def create_yolox_model(name: str = "yolox-s", num_classes: int = 80,
                       ckpt_path: Optional[str] = None, device=None):
    """Returns (model, its state_dict once `ckpt_path` is loaded, else
    None)."""
    from ..tools.tscd_eval import load_weights
    from .yolox import YOLOX
    cfg = _YOLOX_CFG[name.lower().replace("_", "-")]
    model = YOLOX(num_classes=num_classes, device=device, **cfg)
    if not ckpt_path:
        return model, None
    load_weights(model, ckpt_path)
    return model, model.state_dict()


def create_model(name: str, **kw):
    """Every family of the port by name: yolox-*, tscd, yolov, yolov++ (or
    yolov-plus), yolov-online, yolov7 (`arch` tiny, L or X), yolov8
    (`depth`, `width`); keyword arguments go to the model, `device` among
    them (the card by default)."""
    name = name.lower().replace("_", "-")
    if name.startswith("yolox"):
        return create_yolox_model(name, **kw)[0]
    from .elan import YOLOv7
    from .tscd import TSCD
    from .yolov import YOLOV, YOLOVOnline, YOLOVPlus
    from .yolov8 import YOLOv8
    registry: Dict[str, type] = {
        "tscd": TSCD, "yolov": YOLOV, "yolov++": YOLOVPlus,
        "yolov-plus": YOLOVPlus, "yolov-online": YOLOVOnline,
        "yolov7": YOLOv7, "yolov8": YOLOv8,
    }
    if name not in registry:
        raise KeyError(f"unknown model {name!r}: yolox-*, {', '.join(registry)}")
    return registry[name](**kw)
