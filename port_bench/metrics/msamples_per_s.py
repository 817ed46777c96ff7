"""msamples_per_s (Msamples/s): pixel samples of every image completed in
the window over the window's wall time, which ends in a device
synchronize (host clock)."""


def read(ctx):
    w = ctx["window"]
    return w.samples / w.seconds / 1e6
