"""Training (``repro/train``): AdamW with its schedules, checkpoints, the
micro basecaller's training run, the LM trainer and fault tolerance."""
