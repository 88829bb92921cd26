"""Device milliseconds per iteration, over the traced part of the window, of
the graph replays' operations in the ``light_pdf`` stage of
``bounce_step``: the all-hits light pdf of the new direction
(models/pathtracer.light_pdf).  Past 512 light slots that is B1 over the
light clusters' boxes, the per-tile worklist glue of
ops/chunk_intersect.light_pdf_sum_chunks and B3
(csrc/light_sort_kernels.cu); with up to 4 clusters it is K1
(csrc/shade_kernels.cu).  A replay's i-th device operation is node i of its
graph's stage map (``benchmark/program_spans.py``).  Moves
``pixel_samples_per_s``."""

from benchmark import program_spans as ps


def read(ctx):
    if not ctx.get("pixel_samples"):
        return None
    return ps.stage_ms(ctx, "light_pdf")
