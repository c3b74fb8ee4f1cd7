"""Training: optimizer and schedules, EMA, checkpoints, the AR trainer."""
