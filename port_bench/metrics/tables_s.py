"""tables_s (s), layer tables: the runner's construction in set-up
(`build_device_scene`, the pack, the BVH builds, the upload), ending in a
synchronize (host clock)."""


def read(ctx):
    return ctx["setup"]["tables_s"]
