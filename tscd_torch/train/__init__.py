"""Stage-2 training: SimOTA losses, LR schedules, grouped SGD, EMA,
checkpoints and the train step."""
