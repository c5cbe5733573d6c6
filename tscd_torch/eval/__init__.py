"""Evaluation of the port: the COCO API and evaluators (numpy and
native), and the still-image and video evaluators."""

from .coco_api import COCO
from .coco_evaluator import COCOEvaluator
from .cocoeval import COCOeval
from .fast_cocoeval import COCOeval_opt
from .vid_evaluator import OVIS_CLASSES, OVISEvaluator, VIDEvaluator

__all__ = ["COCO", "COCOEvaluator", "COCOeval", "COCOeval_opt", "OVIS_CLASSES",
           "OVISEvaluator", "VIDEvaluator"]
