"""``csrc/pq_list_scan.cu``'s share of its roofline: the frozen least
time of each traced batch's ADC scan (``perfbench/roofline.py``: the
live rows' codes of the lists its queries probe, found by the
reference's own routing against the index's centroids, read once with
their ids, each query's int8 table once; ``m`` shared-memory lookups a
(query, row) pair where larger) over the device time a launch of the
scan kernels (``pq_scan_*``), one launch a batch: the last
batches of the window, one a traced launch."""

import torch

from perfbench import reference, roofline

UNIT = "%"
KERNEL = "pq_scan_"


def read(ctx):
    seconds, launches = ctx.tracer.kernel_time(KERNEL)
    batches = ctx.batches[-launches:] if launches else []
    if not launches or not batches:
        return None
    cfg = ctx.cfg
    m = cfg["pq_m"]
    m_bytes = m // 2 if cfg["pq_packed"] else m
    least = 0.0
    for ids in batches:
        q = torch.as_tensor(ctx.pool[ids], device=ctx.device)
        probes = reference.route(q, ctx.centroids, cfg["nprobe"])
        rows, pairs = roofline.probed_work(probes, ctx.live)
        least += roofline.adc_scan_s(len(ids), m, m_bytes,
                                     1 << cfg["pq_nbits"], 1, rows, pairs)
    return 100.0 * (least / len(batches)) / (seconds / launches)
