"""Share of the traced window in which the card ran nothing while the host
was inside a ``pageann.hop.fetch`` span, in % (``portbench.spans``): the
card waiting on the streamed tier's host reads. None without such spans."""
from portbench import spans

FETCH = "pageann.hop.fetch"


def read(record):
    if not spans.named(spans.program_spans(record), FETCH):
        return None
    return spans.idle_share(record, FETCH)
