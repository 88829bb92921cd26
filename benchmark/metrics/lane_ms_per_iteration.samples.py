"""Device milliseconds per iteration, over the traced part of the window, of
the graph replays' operations in the lane-management stages of the
persistent loop (``models/pathtracer._PersistentLoop``): ``sort``,
``spawn``, ``add_rows`` and ``regenerate``.  A replay's i-th device
operation is node i of its graph's stage map
(``benchmark/program_spans.py``).  Moves ``pixel_samples_per_s``."""

from benchmark import program_spans as ps


def read(ctx):
    if not ctx.get("pixel_samples"):
        return None
    return ps.stage_ms(ctx, "lane")
