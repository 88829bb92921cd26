"""Device milliseconds per iteration, over the traced part of the window, of
the graph replays' operations in the ``shading`` stage outside its
``intersector``, ``hit_info`` and ``light_pdf`` stages: the sampling / BSDF
chain of ``bounce_step`` (ops/sampling.py, ops/bsdf.py), the environment
lookup, the MIS blend.  A replay's i-th device operation is node i of its
graph's stage map (``benchmark/program_spans.py``).  Moves
``pixel_samples_per_s``."""

from benchmark import program_spans as ps


def read(ctx):
    if not ctx.get("pixel_samples"):
        return None
    return ps.stage_ms(ctx, "shade")
