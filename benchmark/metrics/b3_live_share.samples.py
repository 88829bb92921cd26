"""Share of B3's (ray, cluster) pairs whose ray enters the cluster's box,
over the untraced part of the window: the sum of ``b3_live`` over the sum
of ``b3_pairs`` of the program's ``engine_call`` spans (``b3_pairs``: the
clusters of each tile's worklist x the tile's rays; ``b3_live``: those
pairs whose ray enters the cluster's grown box, the only ones B3
Woop-tests).  How far B3's per-ray cull cuts its work.  Nothing where the
calls count no B3 pair (no cluster light pdf, or a program that does not
count them).  Moves ``pixel_samples_per_s``."""

from benchmark import program_spans as ps


def read(ctx):
    calls = ps.untraced_spans(ctx, "engine_call") if ctx.get("pixel_samples") else None
    calls = [c for c in calls or () if {"b3_pairs", "b3_live"} <= set(c.counts)]
    pairs = sum(c.counts["b3_pairs"] for c in calls)
    return sum(c.counts["b3_live"] for c in calls) / pairs if pairs else None
