"""Share of the streamed page reads that the fetcher's staging cache
served without a read off the page file, in %: 1 - the sum of the
``pageann.hop.fetch`` spans' ``misses`` over the sum of their
``streamed``. None without such spans or streamed reads."""
from portbench import spans

FETCH = "pageann.hop.fetch"


def read(record):
    fetches = spans.named(spans.program_spans(record), FETCH)
    streamed = sum(f.args["streamed"] for f in fetches)
    if not streamed:
        return None
    return 100.0 * (1.0 - sum(f.args["misses"] for f in fetches) / streamed)
