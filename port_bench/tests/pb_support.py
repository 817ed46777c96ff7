"""Shared pieces of the benchmark's CPU tests: cells of the benchmark cut
to a film the CPU renders in seconds."""
from __future__ import annotations

import time

from port_bench import harness

TINY = {"cornell": {"width": 16, "height": 12}}


def tiny_cell(workload: str, spp: int = 0) -> harness.Cell:
    """The cell of BENCHMARK.json with its scene cut to a tiny film; its
    traffic, check and limits as they are, `spp` where given."""
    cell = harness.load_cell(workload)
    cell.config["scene"]["args"] = dict(TINY[cell.config["name"]])
    if spp:
        cell.traffic["spp"] = spp
    cell.check["pixels_per_image"] = 64
    return cell


def run_tiny(cell: harness.Cell, seed: int = 2 ** 33 + 9,
             wrap_runner=None, seconds: float = 0.5) -> dict:
    """One run of `cell` on the CPU, past the harness's look for a chip."""
    return harness.run_cell(cell, seed, seconds, False, "cpu",
                            time.perf_counter(), wrap_runner,
                            log=lambda msg: None)
