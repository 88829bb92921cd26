"""Share of the persistent loop's lane-iterations that traced a ray, over the
untraced part of the window: the sum of the ``rays`` (live lanes entering
each bounce, an exact count read where the caller reads the call's
output) over the sum of ``iterations`` x ``lanes`` of the program's
``engine_call`` spans.  Moves ``pixel_samples_per_s``."""

from benchmark import program_spans as ps


def read(ctx):
    calls = ps.untraced_spans(ctx, "engine_call") if ctx.get("pixel_samples") else None
    calls = [c for c in calls or () if {"rays", "iterations", "lanes"} <= set(c.counts)]
    slots = sum(c.counts["iterations"] * c.counts["lanes"] for c in calls)
    return sum(c.counts["rays"] for c in calls) / slots if slots else None
