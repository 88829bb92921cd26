"""Device busy milliseconds (the union of the device's intervals) per
iteration of the persistent loop (``persistent_accum.iterations``) over the
traced part of the window.  Moves ``pixel_samples_per_s``."""

from benchmark.metrics_common import traced


def read(ctx):
    tr = traced(ctx)
    if not tr or tr["summary"]["busy_s"] <= 0:
        return None
    return tr["summary"]["busy_s"] * 1e3 / tr["iterations"]
