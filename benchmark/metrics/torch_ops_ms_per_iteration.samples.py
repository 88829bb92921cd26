"""Device milliseconds per iteration, over the traced part of the window, of
every device operation that is not a hand-written kernel (none of the names
in ``benchmark/kernel_names/``): the torch chains of the bounce, sampling
and BSDF, the cascade glue, the sort and ``add_rows``, with their copies
and fills.  Moves ``pixel_samples_per_s``."""

from benchmark import manifest, profiling
from benchmark.metrics_common import traced


def read(ctx):
    tr = traced(ctx)
    if not tr:
        return None
    by_name = tr["summary"]["by_name"]
    s = sum(by_name.values()) - profiling.seconds_of(by_name, manifest.kernel_names())
    return s * 1e3 / tr["iterations"] if s > 0 else None
