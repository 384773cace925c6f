"""The host's own time a hop, in microseconds: the mean over the traced
loop iterations that hopped of the ``pageann.hop`` span less the
``pageann.hop.sync`` inside it, the Python and launches of ``select``,
``score`` and ``merge`` (``portbench.spans``). Above ``hop_sync_us``, the
hop loop is paced by the host."""
from portbench import spans


def read(record):
    if record["trace"]["busy_s"] <= 0:
        return None
    parts = spans.hop_parts(spans.program_spans(record))
    if not parts:
        return None
    host = [h.dur - s.dur for h, s in parts]
    return 1e6 * sum(host) / len(host)
