"""Host milliseconds per render, over the untraced part of the window, of the
program's ``capture`` spans (a body's eager first block and its CUDA graph
capture, ``models/graph.CapturedBlock``); renders counted by the ``load``
spans of ``cli.render_scene_file``.  Moves ``pixel_samples_per_s``."""

from benchmark import program_spans as ps


def read(ctx):
    loads = ps.untraced_spans(ctx, "load")
    if not loads:
        return None
    return sum(s.end_ns - s.start_ns for s in ps.untraced_spans(ctx, "capture")) / 1e6 / len(loads)
