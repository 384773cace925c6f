"""Fault tolerance: the counterpart of ``repro.ft``."""
