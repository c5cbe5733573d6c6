"""Model modules of the port; names and parameter names follow the
reference's torch `state_dict` (e.g. `backbone.backbone.dark2.0.conv`),
or JAX's flax names where the reference has no torch module (YOLOv8, the
DETR decoder)."""

from .custom_layers import CoordConv, DeformConv2d, DropBlock
from .decoder import TransformerDecoder, hungarian_match, set_criterion
from .elan import ELANFPN, ELANFPNP6, ELANNet, RepConv, YOLOv7
from .yolov8 import YOLOv8

__all__ = ["CoordConv", "DeformConv2d", "DropBlock", "TransformerDecoder", "hungarian_match",
           "set_criterion", "ELANFPN", "ELANFPNP6", "ELANNet", "RepConv", "YOLOv7", "YOLOv8"]
