"""B1's share of its roofline inside the traced part of the window: the
least time of the (tile, chunk) tests the traced engine calls counted
(``b1_tests`` at the call's ``ray_tile``; ``benchmark/rooflines.py``) over
the device time of ``activity_kernel`` by name in the same traced part (the
cascade's launches, the coarse gate's and those over light clusters'
boxes alike).  Moves ``pixel_samples_per_s``."""

from benchmark import rooflines


def read(ctx):
    if not ctx.get("pixel_samples"):
        return None
    return rooflines.share(ctx, rooflines.B1_KERNELS, rooflines.b1_bound_s,
                           ("b1_tests", "ray_tile"))
