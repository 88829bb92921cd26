"""Arithmetic shared by the per-layer metrics' readers."""


def traced(ctx: dict):
    """The traced part of the window (``trace``), where it holds an
    iteration of the persistent loop; else None."""
    tr = ctx.get("trace")
    return tr if tr and tr.get("iterations") and "summary" in tr else None


def idle_share(ctx: dict):
    """1 - the device's busy time per iteration of the traced part of the
    window (the union of its kernel, copy and fill intervals) over the wall
    per iteration of the window's untraced part.  The profiler's own cost
    stretches the traced part's wall several times over (a record per
    kernel), so the wall is read where it does not run.  None where the
    trace holds no device operation or the window no untraced iteration."""
    tr, un = traced(ctx), ctx.get("untraced")
    if not tr or not un or not un["iterations"] or tr["summary"]["busy_s"] <= 0:
        return None
    return 1.0 - (tr["summary"]["busy_s"] / tr["iterations"]) / (un["wall_s"] / un["iterations"])
