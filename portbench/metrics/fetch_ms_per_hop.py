"""The streamed tier's time a hop, in milliseconds: the mean length of the
traced window's ``pageann.hop.fetch`` spans (one a hop of a memory-budgeted
search: the host's read of the hop's non-resident pages and the enqueue of
their copy to the card; ``portbench.spans``). None without such spans: a
fully resident index, or a program that does not emit them."""
from portbench import spans

FETCH = "pageann.hop.fetch"


def read(record):
    fetches = spans.named(spans.program_spans(record), FETCH)
    if not fetches:
        return None
    return 1e3 * sum(f.dur for f in fetches) / len(fetches)
