"""vol_lane_occupancy (%), layer megakernel: the share of a warp's 32 lanes
that take each step of the volpath lane loop together, 100 *
active_lanes / (32 * warp_steps), from the counting build's step counts
of one launch over the cell's film after the window
(port_bench/vol_counts.py); None where the program has no such count."""
from port_bench import vol_counts


def read(ctx):
    c = vol_counts.counts(ctx)
    if not c or not c["warp_steps"]:
        return None
    return 100.0 * c["active_lanes"] / (32.0 * c["warp_steps"])
