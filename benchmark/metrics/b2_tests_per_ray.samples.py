"""Woop tests per traced ray over the untraced part of the window: B2's
units (``b2_units`` of the program's ``engine_call`` spans, each 64 rays
against one chunk's 128 triangles, counted from the cascade's worklists)
x 8,192 over the calls' ``rays``.  How far the cascade culls: fewer tests
a ray is less work for B2.  Moves ``pixel_samples_per_s``."""

from benchmark import program_spans as ps
from benchmark import rooflines


def read(ctx):
    calls = ps.untraced_spans(ctx, "engine_call") if ctx.get("pixel_samples") else None
    calls = [c for c in calls or () if {"b2_units", "rays"} <= set(c.counts)]
    rays = sum(c.counts["rays"] for c in calls)
    if not rays:
        return None
    return sum(c.counts["b2_units"] for c in calls) * rooflines.B2_UNIT_PAIRS / rays
