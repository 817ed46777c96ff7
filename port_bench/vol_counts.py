"""The volpath megakernel's step counts in a traced run, for the
per-layer metrics of a volpath cell.

After the window, with the program's state freed, one launch of the
counting build of the cell's volpath megakernel
(`rene_tpu_torch.kernels.mega_volpath_counts`, -DMEGA_COUNT=1, on no
render path): the whole film, CHUNK samples a lane, seed
check.COUNT_SEED, one sample slot a pixel, on tables the port builds from
the cell's scene text as a run builds them. Its counts (the active lanes
that each warp's leader sees at the lane loop's cast site, the warp
steps, the lanes' steps and march steps, the lanes) are kept in
ctx["vol_counts"] with `samples`, the launch's lane samples. None where
the run is not traced or not on the card, where the cell's scene is not
volpath, or where the program has no counting build of its variant (one
older than it); then the readers that use it give None.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Dict, Optional

CHUNK = 4           # samples a lane of the counting launch
# the program's counting build of each volpath megakernel variant
COUNTING = {"mega_volpath": "mega_volpath_count",
            "mega_volpath_mesh": "mega_volpath_mesh_count"}


def counts(ctx) -> Optional[Dict]:
    """The counting launch's counts for the run of `ctx`, made once."""
    if "vol_counts" not in ctx:
        ctx["vol_counts"] = _count(ctx)
    return ctx["vol_counts"]


def _count(ctx) -> Optional[Dict]:
    if ctx["trace"] is None or ctx["device"].type != "cuda":
        return None
    import torch
    from rene_tpu_torch import kernels
    from rene_tpu_torch.integrators.mega_path import device_tables
    from rene_tpu_torch.scene import build_device_scene, load_scene
    from rene_tpu_torch.scene import pack as P

    from . import check, harness
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="port_bench_") as d:
        path = os.path.join(d, "scene.pbrt")
        with open(path, "w") as f:
            f.write(harness.scene_text(ctx["cell"].config))
        buffers_np, config = build_device_scene(load_scene(path))
    tabs = device_tables(P.pack_tables(buffers_np, config), ctx["device"])
    name = kernels.variant(tabs)
    if COUNTING.get(name) not in getattr(kernels, "BUILDS", {}):
        return None
    out, c = kernels.mega_volpath_counts(tabs, check.COUNT_SEED, CHUNK)
    torch.cuda.synchronize(ctx["device"])
    del out, tabs
    c = {k: int(v) for k, v in c.items()}
    c["samples"] = c["lanes"] * CHUNK
    print(f"{ctx['cell'].name}: {COUNTING[name]}, one {CHUNK}-spp launch "
          f"in {time.perf_counter() - t:.3f} s (nvcc included): {c}, march "
          f"share {c['march_steps'] / max(c['lane_steps'], 1):.4f}",
          file=sys.stderr, flush=True)
    return c
