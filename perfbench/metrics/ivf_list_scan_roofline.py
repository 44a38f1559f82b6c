"""``csrc/ivf_list_scan.cu``'s share of its roofline on int8 lists: the
frozen least time of each traced batch's scan (``perfbench/roofline.py``:
the live rows of the lists its queries probe, found by the reference's
own routing against the index's centroids, read once with their ids,
the query rows once; int8 operations at their peak where larger) over
the device time a launch of the scan kernels (``ivf_scan_*``), one
launch a batch: the last batches of the window, one a traced launch."""

import torch

from perfbench import reference, roofline

UNIT = "%"
KERNEL = "ivf_scan_"


def read(ctx):
    seconds, launches = ctx.tracer.kernel_time(KERNEL)
    batches = ctx.batches[-launches:] if launches else []
    if not launches or not batches:
        return None
    cfg = ctx.cfg
    least = 0.0
    for ids in batches:
        q = torch.as_tensor(ctx.pool[ids], device=ctx.device)
        probes = reference.route(q, ctx.centroids, cfg["nprobe"])
        rows, pairs = roofline.probed_work(probes, ctx.live)
        least += roofline.flat_scan_s(len(ids), cfg["dim"], 1, "int8", rows,
                                      pairs)
    return 100.0 * (least / len(batches)) / (seconds / launches)
