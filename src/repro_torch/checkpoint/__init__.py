"""Checkpoints: the counterpart of ``repro.checkpoint``."""
