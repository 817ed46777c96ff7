"""One run of one cell of the port's benchmark.

A renderer serves no arrivals: a user submits a scene and waits for the
image, then for the next pass or frame. So every cell is a closed loop of
one client: images rendered back to back, image i with a seed derived
from `--seed` and i, all of the cell's scene at the cell's samples per
pixel (its traffic file).

Set-up (`setup_s`, from the process's first line): torch and the CUDA
context; the scene's pbrt text written by the benchmark's frozen
generator (configs/<config>.json names it and its arguments) into a file
under TMPDIR; the port's parse and flatten (`scene.load_scene`,
`load_s`); the runner built as `rene_tpu_torch.render.render` builds it
(`build_device_scene`, `render._runner`, then `make_mega_batch_fn` with
`spp_hint` the traffic's spp, ending in a synchronize: `tables_s`); the
harness drives the megakernel, the runner that engine `auto` resolves
to on every scene the kernels take; nvcc for the runner's own libraries
(`render.runner_libraries`; a no-op once the checkout holds them); one
warm image.

Window: `render.render_loop(run, config, spp, seed, device)` once per
image on that runner, until `--seconds` have passed; the image in flight
finishes and counts, and the window ends when it returns (render_loop
ends in a device synchronize). With `--trace 1` torch.profiler records
the window.

After the window: the device's peak memory, the program's state freed,
then the check (check.py): the films of a sample of the window's images,
at a sample of pixels, against the benchmark's plain reference. The
result line's metrics are those of BENCHMARK.json that apply to the
cell, each read by its file under metrics/ (`--trace 0`: the end-to-end
ones, `--trace 1`: the per-layer ones).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "rene_tpu")
# environment switches of the program that would change the cell's work
PROGRAM_SWITCHES = ("RENE_MEGA_PACK", "RENE_MF_DIST")


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with the files it names: its
    configuration (the scene), its traffic (spp, engine) and its check
    (the sample it compares, its limits), and the metrics it reports."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    check: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str) -> Cell:
    """The cell `workload` of BENCHMARK.json and its files:
    configuration at the config's `file`, traffic at
    port_bench/traffic/<traffic>.json, check at
    port_bench/checks/<workload>.json (paths under the benchmark's
    folder, found by name)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        check=json.loads((BENCH_DIR / "checks" / f"{workload}.json")
                         .read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def scene_text(config: Dict) -> str:
    """The configuration's scene: pbrt text from its frozen generator,
    port_bench/scenes/<generator>.py `scene(**args)`."""
    gen = config["scene"]
    mod = importlib.import_module(f"{BENCH_DIR.name}.scenes.{gen['generator']}")
    return mod.scene(**gen.get("args", {}))


def image_seed(seed: int, i: int) -> int:
    """The seed of image i of a run of `seed` (any integer)."""
    st = np.random.SeedSequence([seed % (1 << 64), i % (1 << 64)]).generate_state(2)
    return int(st[0]) << 32 | int(st[1])


def pixel_sample(seed: int, i: int, npix: int, n: int) -> np.ndarray:
    """The n pixels (ray order) of image i that the check reads."""
    gen = np.random.default_rng([seed % (1 << 64), i, 1])
    return np.sort(gen.choice(npix, min(n, npix), replace=False))


class Program:
    """The port on the device: the scene parsed, its runner built as
    `render.render` builds it, timed by layer."""

    def __init__(self, cell: Cell, scene_path: str, device,
                 wrap_runner: Optional[Callable] = None):
        import torch
        from rene_tpu_torch import kernels, render
        from rene_tpu_torch.integrators.mega_path import make_mega_batch_fn
        from rene_tpu_torch.scene import build_device_scene, load_scene

        self.device = torch.device(device)
        self.render_loop = render.render_loop
        spp, engine = int(cell.traffic["spp"]), cell.traffic["engine"]
        self.timings = {}
        t = time.perf_counter()
        scene = load_scene(scene_path)
        self.timings["load_s"] = time.perf_counter() - t
        t = time.perf_counter()
        buffers_np, config = build_device_scene(scene)
        self.runner = render._runner(engine, buffers_np, config)
        if self.runner != "megakernel":
            raise RuntimeError(f"{cell.name}: engine {engine!r} resolves to "
                               f"the {self.runner} runner, not the "
                               f"megakernel")
        run = make_mega_batch_fn(buffers_np, config, self.device,
                                 spp_hint=spp)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["tables_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if self.device.type == "cuda":
            kernels.build(names=render.runner_libraries(buffers_np, config,
                                                        engine))
        self.timings["build_s"] = time.perf_counter() - t
        self.run = wrap_runner(run) if wrap_runner else run
        self.config = config
        self.spp = spp
        self.width = config.film.xresolution
        self.height = config.film.yresolution

    def image(self, seed: int) -> Dict:
        """One image of the cell's spp: render_loop's result."""
        return self.render_loop(self.run, self.config, self.spp, seed,
                                self.device)

    def pixels(self, out: Dict, pix: np.ndarray) -> np.ndarray:
        """(len(pix), 9) color, normal and albedo of the film at pixels
        `pix` (ray order; the film is y-flipped)."""
        rows = self.height - 1 - pix // self.width
        cols = pix % self.width
        return np.concatenate([out[k][rows, cols]
                               for k in ("color", "normal", "albedo")], 1)


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    images: int = 0
    samples: float = 0.0
    rays: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    kept: List[np.ndarray] = dataclasses.field(default_factory=list)


def run_window(prog: Program, seed: int, seconds: float, n_pixels: int,
               mark=None) -> Window:
    """Images back to back for `seconds`; each image's latency, rays and
    the check's pixels of it. `mark(i)` gives a context for image i (the
    profiler's span), or None."""
    import contextlib
    w = Window()
    npix = prog.width * prog.height
    t0 = time.perf_counter()
    while True:
        i = w.images
        pix = pixel_sample(seed, i, npix, n_pixels)
        with (mark(i) if mark else contextlib.nullcontext()):
            t_call = time.perf_counter()
            out = prog.image(image_seed(seed, i))
            t_end = time.perf_counter()
        w.latencies_s.append(t_end - t_call)
        w.rays += float(out["total_rays"])
        w.kept.append(prog.pixels(out, pix))
        w.images += 1
        w.samples += float(prog.spp) * npix
        if t_end - t0 >= seconds:
            break
    w.seconds = t_end - t0
    return w


def load_reader(name: str) -> Callable:
    """metrics/<name>.py's `read(ctx)`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN (the whole
    name: rene_tpu_torch is not rene_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, wrap_runner: Optional[Callable] = None,
             log=None) -> Dict:
    """Set-up, window and check of one run on `device`; the result line
    as a dict. `wrap_runner` wraps the program's runner (the tests'
    faults)."""
    import torch
    from . import check
    from . import trace as TR

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    cuda = device.type == "cuda"
    for k in PROGRAM_SWITCHES:
        os.environ.pop(k, None)
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    scene_dir = tempfile.mkdtemp(prefix="port_bench_")
    try:
        scene_path = os.path.join(scene_dir, "scene.pbrt")
        with open(scene_path, "w") as f:
            f.write(scene_text(cell.config))
        prog = Program(cell, scene_path, device, wrap_runner)
        t = time.perf_counter()
        prog.image(image_seed(seed, -1))          # the warm image
        setup = dict(prog.timings, warm_s=time.perf_counter() - t,
                     setup_s=time.perf_counter() - t_process)
        log(f"{cell.name}: set-up {setup['setup_s']:.3f} s (load "
            f"{setup['load_s']:.3f}, tables {setup['tables_s']:.3f}, nvcc "
            f"{setup['build_s']:.3f}, warm image {setup['warm_s']:.3f}), "
            f"engine {prog.runner}")

        n_pix = int(cell.check["pixels_per_image"])
        tracer = TR.Tracer(device) if trace and cuda else None
        if tracer:
            with tracer:
                win = run_window(prog, seed, seconds, n_pix, tracer.mark)
        else:
            win = run_window(prog, seed, seconds, n_pix)
        peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        lat_ms = np.asarray(win.latencies_s) * 1e3
        log(f"{cell.name}: window {win.seconds:.3f} s, {win.images} images, "
            f"latency median {np.median(lat_ms):.3f} ms, p95 "
            f"{np.percentile(lat_ms, 95):.3f} ms over {lat_ms.size}")
        dims = (prog.width, prog.height, prog.spp)
        del prog
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        judged = check.judge(cell, scene_path, device, seed, win, dims,
                             counting=trace, log=log)
    finally:
        shutil.rmtree(scene_dir, ignore_errors=True)

    ctx = {"cell": cell, "setup": setup, "window": win, "dims": dims,
           "trace": tracer.parse() if tracer else None,
           "work": judged.get("work"), "device": device}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": judged["correct"], "attempted": win.images,
              "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if ctx["trace"] is not None:
        result["device"]["busy_s"] = ctx["trace"].busy_s()
        result["device"]["window_s"] = ctx["trace"].window_s()
        result["breakdown"] = ctx["trace"].breakdown()
    result["checks"] = judged["numbers"]
    return result


def main(argv, t_process: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA device(s), torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t_process)
    found = forbidden_modules()
    if found:
        print(f"{args.workload}: the run loaded {found}", file=sys.stderr)
        return 4
    for name, n in result["checks"].items():
        print(f"check {name}: {n['value']!r} (limit {n['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
