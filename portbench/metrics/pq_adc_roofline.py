"""The ADC scorings' share of their roofline, in %: the least time the
traced batches' ``pq_adc`` launches could take
(``portbench.roofline.pq_adc_counts``) over the device time of the kernel
named below."""
from portbench import roofline, trace

KERNELS = ("pq_adc_kernel",)


def read(record):
    device = trace.device_seconds(record["trace"], KERNELS)
    g = record["geometry"]
    bound = 0.0
    for b in record["traced"]:
        bytes_, ops_ = roofline.pq_adc_counts(g, nq=b["nq"], hops=b["hops"])
        bound += roofline.kernel_bound(bytes_, ops_)["seconds"]
    return roofline.share_percent(bound, device)
