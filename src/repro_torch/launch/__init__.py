"""Launch-time helpers of the port: the counterpart of ``repro.launch``
(its device mesh, ``launch.mesh``)."""
