"""vol_queued_march_share (%), layer megakernel: the share of the volpath
lane loop's march segments that ran from the block's march queue (a warp
taking up to 32 lanes' marches at once) rather than on their own lane,
100 * queued_steps / march_steps, from the counting build's step counts
of one launch over the cell's film after the window
(port_bench/vol_counts.py); None where the program has no such count."""
from port_bench import vol_counts


def read(ctx):
    c = vol_counts.counts(ctx)
    if not c or c.get("queued_steps") is None or not c["march_steps"]:
        return None
    return 100.0 * c["queued_steps"] / c["march_steps"]
