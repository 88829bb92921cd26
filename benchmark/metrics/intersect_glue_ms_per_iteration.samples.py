"""Device milliseconds per iteration, over the traced part of the window, of
the graph replays' operations in the ``intersector`` stage whose names are
in no ``benchmark/kernel_names/`` file: the cascade glue of
``ops/chunk_intersect.closest_hit_chunks`` around kernels B1 and B2.  A
replay's i-th device operation is node i of its graph's stage map
(``benchmark/program_spans.py``).  Moves ``pixel_samples_per_s``."""

from benchmark import program_spans as ps


def read(ctx):
    if not ctx.get("pixel_samples"):
        return None
    return ps.stage_ms(ctx, "intersect_glue")
