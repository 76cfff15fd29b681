"""Optimizers, checkpoints and the training loop (counterpart of
``repro/train``)."""
