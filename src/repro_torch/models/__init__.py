"""The LM substrate, ported to PyTorch: the counterpart of
``repro.models`` (``layers``, ``moe``, ``ssm``, ``rglru``, ``context``,
``frontend`` and ``transformer``, every family of the registry)."""
