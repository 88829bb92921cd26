"""B2's share of its roofline inside the traced part of the window: the
least time of the units the traced engine calls counted (``b2_units``;
``benchmark/rooflines.py``) over the device time of B2's kernels by name
(``items_kernel``, ``items_final_kernel``) in the same traced part.  Moves
``pixel_samples_per_s``."""

from benchmark import rooflines


def read(ctx):
    if not ctx.get("pixel_samples"):
        return None
    return rooflines.share(ctx, rooflines.B2_KERNELS, rooflines.b2_bound_s, ("b2_units",))
