"""Host milliseconds per pass, over the untraced part of the window, of the
program's ``readback`` (each chunk's copy to the host and its accumulate)
and ``save`` (the checkpoint written) spans in
``parallel/checkpoint.render_with_checkpoints``.  Moves
``pixel_samples_per_s``."""

from benchmark import program_spans as ps


def read(ctx):
    passes = ps.untraced_spans(ctx, "pass")
    saves = ps.untraced_spans(ctx, "save")
    if not passes or not saves:
        return None
    spent = saves + ps.untraced_spans(ctx, "readback")
    return sum(s.end_ns - s.start_ns for s in spent) / 1e6 / len(passes)
