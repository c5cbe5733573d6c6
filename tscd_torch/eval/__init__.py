"""Evaluation of the port: the COCO API and evaluators (numpy and
native), and the video evaluator."""

from .coco_api import COCO
from .cocoeval import COCOeval
from .fast_cocoeval import COCOeval_opt
from .vid_evaluator import OVIS_CLASSES, OVISEvaluator, VIDEvaluator

__all__ = ["COCO", "COCOeval", "COCOeval_opt", "OVIS_CLASSES",
           "OVISEvaluator", "VIDEvaluator"]
