"""idle_ms.chunks (ms), layer chunk loop: the device's idle time per
traced image while the host is in a `rene.loop.chunk` span or one inside
it (the chunk's seed draw, the launch's enqueue, the sums, the wait for
the ray count), from the program's spans (port_bench/spans.py); None
where the program records none."""
from port_bench import spans


def read(ctx):
    return spans.idle_ms_per_image(ctx, "chunks")
