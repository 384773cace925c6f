"""Step builders: the counterpart of ``repro.train`` (serving steps)."""
