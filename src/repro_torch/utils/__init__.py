"""Small helpers shared by training and checkpointing
(``repro/utils``)."""
