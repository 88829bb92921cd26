"""Iterations of the persistent loop (``persistent_accum.iterations``, an
exact count) per million pixel-samples over the window: the drain tail and
the lanes wasted.  Moves ``pixel_samples_per_s``."""


def read(ctx):
    if not ctx.get("pixel_samples"):
        return None
    return ctx["iterations"] / (ctx["pixel_samples"] / 1e6)
