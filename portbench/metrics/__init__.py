"""Per-layer metric readers, one module a metric, found by the metric's
name in ``BENCHMARK.json``. Each defines ``read(record)``: the metric's
value from the traced run's record, or None when the run gave it nothing
to read (the metric is then left out of the result line)."""
