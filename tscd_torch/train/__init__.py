"""Training: SimOTA losses (YOLOX and stage-2 TSCD), LR schedules, grouped
SGD, EMA, checkpoints and the train steps."""
