"""Share of the window's wall per iteration in which no operation ran on the
device: 1 - (device busy time per iteration of the traced part: the union
of its kernel, copy and fill intervals) / (wall per iteration of the
window's untraced part).  In the cells that report
``pixel_samples_per_s``, which it moves."""

from benchmark.metrics_common import idle_share


def read(ctx):
    return idle_share(ctx) if ctx.get("pixel_samples") else None
