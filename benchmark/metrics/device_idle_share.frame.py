"""Share of a frame's wall per iteration in which no operation ran on the
device: 1 - (device busy time per iteration of the traced frames: the
union of their kernel, copy and fill intervals) / (wall per iteration of
the window's untraced frames).  In the cells that report
``frame_ms_p50``, which it moves."""

from benchmark.metrics_common import idle_share


def read(ctx):
    return idle_share(ctx) if ctx.get("frames") else None
