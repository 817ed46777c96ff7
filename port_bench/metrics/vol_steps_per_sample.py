"""vol_steps_per_sample (steps/sample), layer megakernel: the volpath lane
loop's steps (each one cast: a path ray, or a march's next segment) per
lane sample, lane_steps / samples, from the counting build's step counts
of one launch over the cell's film after the window
(port_bench/vol_counts.py, which logs the march share beside them); None
where the program has no such count."""
from port_bench import vol_counts


def read(ctx):
    c = vol_counts.counts(ctx)
    if not c or not c["samples"]:
        return None
    return c["lane_steps"] / c["samples"]
