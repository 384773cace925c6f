"""The LM substrate, ported to PyTorch: the counterpart of
``repro.models`` (the dense family: ``layers``, ``transformer``)."""
