"""Device milliseconds of the intersector's hand-written kernels (the names
in ``benchmark/kernel_names/intersect.*.txt``) per iteration over the traced
part of the window.  Moves ``pixel_samples_per_s``."""

from benchmark import manifest, profiling
from benchmark.metrics_common import traced


def read(ctx):
    tr = traced(ctx)
    if not tr:
        return None
    s = profiling.seconds_of(tr["summary"]["by_name"], manifest.kernel_names("intersect."))
    return s * 1e3 / tr["iterations"] if s > 0 else None
