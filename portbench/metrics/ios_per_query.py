"""Pages read a query (the paper's I/O count): the mean of
``SearchResult.ios`` over every query of the window."""


def read(record):
    n = record["queries"]
    return record["ios_sum"] / n if n else None
