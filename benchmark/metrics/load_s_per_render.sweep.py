"""Seconds per render of the window in the program's scene load (glTF
parse, scene arrays, upload: ``RenderMetrics.load_seconds`` of
``cli.render_scene_file``, the program's own span), the part of a render
in which the device waits for the host.  Moves ``pixel_samples_per_s``."""


def read(ctx):
    loads = ctx.get("load_s")
    return sum(loads) / len(loads) if loads else None
