"""Iterations of the persistent loop (``persistent_accum.iterations``) per
frame of the window.  Moves ``frame_ms_p50``."""


def read(ctx):
    if not ctx.get("frames"):
        return None
    return ctx["iterations"] / ctx["frames"]
