"""Share of the traced window in which the card ran nothing while the host
was inside a ``pageann.hop`` span, in % (``portbench.spans``)."""
from portbench import spans


def read(record):
    return spans.idle_share(record, "pageann.hop")
