"""Launch-time helpers and drivers of the port: the counterpart of
``repro.launch`` (its device mesh, ``launch.mesh``, and the serving
driver, ``launch.serve``)."""
