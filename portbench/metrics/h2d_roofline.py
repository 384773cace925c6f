"""The streamed tier's copies to the card against their roofline, in %:
the least time the traced window's streamed records could take over the
host-to-device link (the ``pageann.hop.fetch`` spans' ``bytes`` at
``H2D_BYTES_PER_S``) over the device time of the copies from pinned host
memory (the only ones the search makes: its queries go up from pageable
memory). None without such spans or such copies.

``H2D_BYTES_PER_S`` is one direction of PCIe Gen5 x16: half of the 128
GB/s that NVIDIA's H100 SXM data sheet gives for both directions."""
from portbench import roofline, spans, trace

FETCH = "pageann.hop.fetch"
H2D_BYTES_PER_S = 64e9
COPIES = ("Memcpy HtoD (Pinned -> Device)",)


def bound_seconds(bytes_: float) -> float:
    """The least time ``bytes_`` take to cross the link."""
    return bytes_ / H2D_BYTES_PER_S


def read(record):
    fetches = spans.named(spans.program_spans(record), FETCH)
    if not fetches:
        return None
    bytes_ = sum(f.args["bytes"] for f in fetches)
    device = trace.device_seconds(record["trace"], COPIES)
    return roofline.share_percent(bound_seconds(bytes_), device)
