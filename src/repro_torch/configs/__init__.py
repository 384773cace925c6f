"""Architecture and shape configs: the counterpart of ``repro.configs``
(``registry.get_arch(name, smoke=)``)."""
