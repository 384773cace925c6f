"""Share of the traced window in which the card ran nothing while the host
was inside ``pageann.search`` but outside every ``pageann.hop``: the
upload, LUTs, routing, download and id translation, in %
(``portbench.spans``). ``device_idle_share`` less this and
``hop_idle_share`` is the idle time outside the program (the client
drawing queries)."""
from portbench import spans


def read(record):
    return spans.idle_share(record, "pageann.search", "pageann.hop")
