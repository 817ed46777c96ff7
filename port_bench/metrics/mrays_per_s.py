"""mrays_per_s (Mrays/s), layer megakernel (a work count): the
megakernel's own nominal ray count (render_loop's `total_rays`) of the
window's images over the window's wall time."""


def read(ctx):
    w = ctx["window"]
    return w.rays / w.seconds / 1e6
