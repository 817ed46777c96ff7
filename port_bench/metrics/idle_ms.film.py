"""idle_ms.film (ms), layer chunk loop: the device's idle time per traced
image while the host is in `rene.loop.film` (`film_result`'s divide,
y-flip and `varmean` on the host), from the program's spans
(port_bench/spans.py); None where the program records none."""
from port_bench import spans


def read(ctx):
    return spans.idle_ms_per_image(ctx, "film")
