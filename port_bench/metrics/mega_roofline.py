"""mega_roofline (%), layer megakernel: the least time of an image's
megakernel launches (port_bench/roofline.py, from the plain walk's counts
on a fixed seeded set of lanes of the cell's scene) over their device
time per traced image (torch.profiler, by kernel name)."""
from port_bench import roofline


def read(ctx):
    work = ctx["work"]
    return roofline.share(work and roofline.image_bound_s(work),
                          ctx["trace"], r"mega_(vol)?path_kernel")
