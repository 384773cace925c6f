"""Hop-loop iterations a query: the mean of ``SearchResult.hops`` over
every query of the window."""


def read(record):
    n = record["queries"]
    return record["hops_sum"] / n if n else None
