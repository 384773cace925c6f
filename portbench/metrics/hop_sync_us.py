"""How long the host waits on the card a hop, in microseconds: the mean
``pageann.hop.sync`` span (the blocking ``nonzero`` of the active lanes,
one a loop iteration) over the traced batches (``portbench.spans``)."""
from portbench import spans


def read(record):
    if record["trace"]["busy_s"] <= 0:
        return None
    syncs = spans.named(spans.program_spans(record), "pageann.hop.sync")
    if not syncs:
        return None
    return 1e6 * sum(s.dur for s in syncs) / len(syncs)
