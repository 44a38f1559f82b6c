"""Share of the window's probes that the dispatch dropped past a list's
``qcap``: the program's ``search_profile`` counters ``probes_dropped``
over ``probes`` (Q x nprobe a batch), read after the window, the traced
part included: a ratio does not care about the profiler's cost. The
harness has loaded the program; a program without the counters (or
none loaded) reads nothing."""

import sys

UNIT = "%"
PROFILE = "rag_foundation_tpu_torch.engine.profile"


def read(ctx):
    profile = getattr(sys.modules.get(PROFILE), "search_profile", None)
    counts = getattr(profile, "counts", None)
    if counts is None:
        return None
    got = counts()
    if not got["probes"]:
        return None
    return 100.0 * got["probes_dropped"] / got["probes"]
