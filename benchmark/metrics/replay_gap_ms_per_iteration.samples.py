"""Milliseconds per iteration in which the device waits inside the
program's ``engine_call`` spans, outside their ``capture`` spans (the host
read after each block, the launches between replays, the call's start):
the calls' wall per iteration in the untraced part less the device's busy
time per iteration inside the traced part's calls of the same work (the
same pixels at the same sample count: ``atrium.progressive``'s later
passes, the sweep's other 16-spp passes of the traced chunks)
(``benchmark/program_spans.py``).  Moves ``pixel_samples_per_s``."""

from benchmark import program_spans as ps


def read(ctx):
    return ps.replay_gap_ms(ctx) if ctx.get("pixel_samples") else None
