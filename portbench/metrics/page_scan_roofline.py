"""The page scans' share of their roofline, in %: the least time the
traced batches' scans could take (``portbench.roofline.page_scan_counts``,
bound by bytes or operations, whichever is longer) over the device time of
the kernels named below (every page-scan variant: with on-page ADC or
members only, by id or over staged records; no cell filters, so none
is masked)."""
from portbench import roofline, trace

KERNELS = ("page_scan_adc_kernel", "page_scan_members_kernel")


def read(record):
    device = trace.device_seconds(record["trace"], KERNELS)
    g = record["geometry"]
    bound = 0.0
    for b in record["traced"]:
        reads = int(b["ios"].sum() + b["cache_hits"].sum())
        bytes_, ops_ = roofline.page_scan_counts(
            g, hops=b["hops"], reads=reads)
        bound += roofline.kernel_bound(bytes_, ops_)["seconds"]
    return roofline.share_percent(bound, device)
