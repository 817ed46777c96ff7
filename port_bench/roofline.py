"""The least device time of an image's launches, from the plain
versions' counts (reference/render.py `count_ops`) and the copy of the
port's bound arithmetic (reference/bounds.py): the larger of the FP32
operations of the casts over 67 TFLOP/s and the bytes over 3.35 TB/s."""
from __future__ import annotations

from typing import Dict, Optional

from .reference import bounds


def image_bound_s(work: Dict) -> float:
    """Seconds the card needs at least for one image's megakernel
    launches: every launch reads the tables once (the atlas as far as its
    texels reach) and writes 10 floats a lane."""
    launches = work["launches_per_image"]
    per_launch = work["samples_per_image"] / launches
    n_bytes = launches * (work["table_bytes"]
                          + min(work["atlas_bytes"],
                                work["texel_bytes"] * per_launch)
                          + 40.0 * work["lanes_per_launch"])
    ms, _ = bounds.bound(n_bytes, work["ops"] * work["samples_per_image"])
    return ms * 1e-3


def share(bound_s: Optional[float], trace, pattern: str) -> Optional[float]:
    """`bound_s`'s share (%) of the device time per traced image of the
    kernels named by `pattern`; None where the trace holds none."""
    if bound_s is None or trace is None or not trace.images:
        return None
    device_s = trace.seconds(pattern) / trace.images
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s
