"""image_roofline (%), layer device: the least time of an image's
megakernel launches (port_bench/roofline.py, as mega_roofline) over the
median `rene.loop.image` span of the traced window, the whole image from
the first chunk's seed to the film on the host: the image's share of the
card's peak, whatever kernels it runs. None where the program records no
image span."""
import numpy as np

from port_bench import roofline, spans


def read(ctx):
    work, trace = ctx["work"], ctx["trace"]
    if work is None or trace is None:
        return None
    images = spans.image_seconds(trace)
    if not images:
        return None
    return 100.0 * roofline.image_bound_s(work) / float(np.median(images))
