"""Training (``repro/train``): AdamW with its schedules, checkpoints, and
the micro basecaller's training run."""
