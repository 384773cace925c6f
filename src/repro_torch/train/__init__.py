"""Step builders and gradient compression: the counterpart of
``repro.train`` (``step``: training and serving steps; ``compress``)."""
