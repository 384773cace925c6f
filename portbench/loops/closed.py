"""The closed loop: one client sends a batch of fresh queries and sends
the next when the last one's results are back."""
from __future__ import annotations

import time

import numpy as np

from portbench import data
from portbench import trace as trace_mod


def drive(system, inputs, traffic, seconds: float, *, trace: bool) -> dict:
    """Batches until ``seconds`` have passed since the first was sent; the
    last one sent before then is waited for. With ``trace``, the first
    ``traffic.trace_batches`` batches run under ``torch.profiler``.

    Returns the window's record: every batch's index and answer, each
    batch's latency from the call to results on the host, the window's
    seconds and counts, and the traced batches' counters and profiler."""
    prof = None
    if trace:
        import torch
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    batches, lat, traced = [], [], []
    ios_sum = hops_sum = queries = 0
    harness_s = 0.0
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        span = None
        if prof is not None and i < traffic.trace_batches:
            span = torch.profiler.record_function(trace_mod.SPAN)
            span.__enter__()
        h0 = time.perf_counter()
        q = inputs.queries(traffic.batch, data.batch_seed(traffic.seed, i))
        q = q.cpu().numpy()
        t_call = time.perf_counter()
        res = system.search(q, traffic.k)
        t_done = time.perf_counter()
        if span is not None:
            span.__exit__(None, None, None)
            traced.append(dict(nq=len(q), hops=res.hops, ios=res.ios,
                               cache_hits=res.cache_hits))
            if len(traced) == traffic.trace_batches:
                prof.__exit__(None, None, None)
        harness_s += t_call - h0
        lat.append(t_done - t_call)
        batches.append((i, res.ids, res.dists))
        ios_sum += int(np.asarray(res.ios).sum())
        hops_sum += int(np.asarray(res.hops).sum())
        queries += len(q)
        i += 1
    window_s = time.perf_counter() - t0
    if prof is not None and len(traced) < traffic.trace_batches:
        prof.__exit__(None, None, None)
    return dict(batches=batches, latencies=lat, window_s=window_s,
                queries=queries, ios_sum=ios_sum, hops_sum=hops_sum,
                harness_s=harness_s, traced=traced, prof=prof)
