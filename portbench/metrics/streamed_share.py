"""Share of the traced hops' page reads that were not resident on the
card and went through the streamed tier, in %: the sum of the
``pageann.hop.fetch`` spans' ``streamed`` over the sum of their ``lanes``
(the hop's page reads). None without such spans."""
from portbench import spans

FETCH = "pageann.hop.fetch"


def read(record):
    fetches = spans.named(spans.program_spans(record), FETCH)
    lanes = sum(f.args["lanes"] for f in fetches)
    if not lanes:
        return None
    return 100.0 * sum(f.args["streamed"] for f in fetches) / lanes
