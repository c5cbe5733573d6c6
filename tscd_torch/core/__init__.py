"""The streaming eval step and the trainers (still-image YOLOX, stage-2
TSCD) of the port."""
