"""Device time a query, in microseconds: the union of every kernel, copy
and fill on the card over the traced window, divided by the queries the
traced batches sent. Steadier than ``qps``, which the host paces."""


def read(record):
    n = sum(b["nq"] for b in record["traced"])
    busy = record["trace"]["busy_s"]
    return 1e6 * busy / n if n and busy > 0 else None
