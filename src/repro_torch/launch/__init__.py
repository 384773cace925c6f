"""Launch-time helpers and drivers of the port: the counterpart of
``repro.launch`` (its device mesh, ``launch.mesh``, the serving driver,
``launch.serve``, and the training driver, ``launch.train``)."""
