"""Build and binding of the port's CUDA kernels.

Three sources, the first two compiled with nvcc once per variant (the
template parameter MESH, set by -DMEGA_MESH, and the integrator, set by
-DMEGA_VOL) into a shared library with a plain C interface, at first
use, into build/rene_tpu_torch/ of the checkout (named by a hash of the
sources and flags, so an edit rebuilds), all nine nvcc runs started
together, and loaded with ctypes:

    csrc/mega_path.cu   the megakernel: the path body (K1a-K1d) and the
                        volpath body (K1e), with `pack` sample slots per
                        pixel on cluster-mode scenes (K1f)
    csrc/wave.cu        the wave engine: K2 in the four variants, with K3,
                        K4 and the Sobol probe, which do not depend on the
                        variant, taken from the path immediates build
    csrc/probes.cu      the Mosaic probes P-r3n (rowslice_probe) and P-r3w
                        (mxu_probe), one build

and seven more builds, which no render path launches, each built at
its first launch and not with the variants: the volpath megakernel, mesh
and immediates, and the volpath mesh K2 with step counts
(-DMEGA_COUNT=1, `mega_volpath_counts`, `wave_volpath_counts`; the
benchmark reads the immediates megakernel's), the path mesh K2 with its
lane loop's counts (-DMEGA_COUNT=1, `wave_path_counts`), the path mesh
megakernel
with walk counts (-DWALK_COUNT=1, `mega_path_walk_counts`) and with
texture counts (-DTEX_COUNT=1, `mega_path_tex_counts`), and the path
immediates megakernel with its phases' cycles (-DPATH_COUNT=1,
`mega_path_counts`). Every mesh build and the path immediates build also
hold the ray-cast probe (`cast_probe`: the mesh walk, or the immediates
cast, alone on given rays) and the texture-fetch probe (`tex_probe`: the
fetch alone on given images and uvs), on no render path.

Besides the scene tables of the plain versions, the kernels read two of
their own (scene/pack.py): the env-map cdfs' guide tables (`env_guide`)
and the immediates' cast rows (`imm`), which each kernel copies into
shared memory at its start.

Every build of K1 and K2, and K3, holds two instances of its kernel, the
independent sampler's and `Sampler "sobol"`'s (template parameter SOBOL,
csrc/sobol.cuh), picked at launch by the scene's sampler: no more nvcc
runs. Each instance has its own count in `launches`, the Sobol one under
its variant's name plus "_sobol".

Nothing is compiled or imported at module import: the CPU-only tests
import this module freely.

Each wrapper runs its kernel's plain PyTorch version when its tensors lie
on the CPU. On a CUDA device it checks its tensors, allocates its outputs
with torch.empty, launches on the current stream without synchronising
(the enqueue inside span `rene.launch.<name>`, trace.py), raises if the
launch was refused, and adds one to its kernel's count in `launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

from . import trace
from .ops.rng import block_edge
from .scene import accel as A
from .scene import pack as P
from .scene.device import ENV_GH, ENV_GW

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "rene_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# each library: its source and its flags. The variants of a kernel
# template are the immediates-only path (K1a; K2 on such scenes), the
# path with the acceleration tables (K1c, K1d; K2 on such scenes), and
# the same two with the volpath body (K1e); a separate build keeps the
# path variants' code as it was
VARIANTS = {"mega_path": ("mega_path.cu", "-DMEGA_MESH=0", "-DMEGA_VOL=0"),
            "mega_path_mesh": ("mega_path.cu", "-DMEGA_MESH=1",
                               "-DMEGA_VOL=0"),
            "wave_path": ("wave.cu", "-DMEGA_MESH=0", "-DMEGA_VOL=0"),
            "wave_path_mesh": ("wave.cu", "-DMEGA_MESH=1", "-DMEGA_VOL=0"),
            "mega_volpath": ("mega_path.cu", "-DMEGA_MESH=0",
                             "-DMEGA_VOL=1"),
            "mega_volpath_mesh": ("mega_path.cu", "-DMEGA_MESH=1",
                                  "-DMEGA_VOL=1"),
            "wave_volpath": ("wave.cu", "-DMEGA_MESH=0", "-DMEGA_VOL=1"),
            "wave_volpath_mesh": ("wave.cu", "-DMEGA_MESH=1",
                                  "-DMEGA_VOL=1"),
            "probes": ("probes.cu",)}
# the counting builds' libraries and kernels: the volpath mesh and
# immediates megakernels and the volpath mesh K2 with step counts, the path
# mesh megakernel with walk counts and with texture counts, the path
# immediates megakernel with its phases' cycles
COUNT, WAVE_COUNT = "mega_volpath_mesh_count", "wave_volpath_mesh_count"
IMM_COUNT = "mega_volpath_count"
PATH_WAVE_COUNT = "wave_path_mesh_count"
WALK_COUNT = "mega_path_mesh_count"
TEX_COUNT, PATH_COUNT = "mega_path_mesh_texcount", "mega_path_count"
# every library `build` knows: the variants and the counting builds
BUILDS = dict(VARIANTS, **{c: VARIANTS[v] + ("-DMEGA_COUNT=1",) for c, v in (
    (COUNT, "mega_volpath_mesh"), (IMM_COUNT, "mega_volpath"),
    (WAVE_COUNT, "wave_volpath_mesh"), (PATH_WAVE_COUNT, "wave_path_mesh"))},
    **{WALK_COUNT: VARIANTS["mega_path_mesh"] + ("-DWALK_COUNT=1",),
       TEX_COUNT: VARIANTS["mega_path_mesh"] + ("-DTEX_COUNT=1",),
       PATH_COUNT: VARIANTS["mega_path"] + ("-DPATH_COUNT=1",)})
# what the texture counts hold (csrc/texture.cuh TEXC_*), in their C
# order: fetches by slot class (P.IMG_CLASSES) and of the background,
# fetches that repeat the previous image class's image at the same uv,
# checker evaluations, env strategy draws, env_pdf_dir calls; per entry
# point the active lanes at its entry and its warp entries; the cycles
# inside the calls and the threads' cycles
TEX_ENTRIES = ("apply", "background", "env_draw", "env_pdf")
TEX_KEYS = tuple(f"fetch_{c}" for c in P.IMG_CLASSES) + (
    "fetch_bg", "fetch_repeat", "checkers", "env_draws", "env_pdfs") + tuple(
    f"{e}_{k}" for e in TEX_ENTRIES for k in ("lanes", "warps")) + (
    "tex_cycles", "lane_cycles")
# what the path counts hold (csrc/path.cuh path_counts), in their C order:
# the cycles of the closest-hit casts, the emitter-pdf casts, the BSDF
# steps (which hold the emitter-pdf casts) and the draws; the threads'
# cycles; the lane-bounces, 32 x each warp's busiest lane's bounces, the
# lanes
PATH_KEYS = ("trace_cycles", "emit_pdf_cycles", "bsdf_cycles", "draw_cycles",
             "lane_cycles", "lane_bounces", "warp_bounce_slots", "lanes")
# what their counts hold (csrc/vol_loop.cuh StepCounts), in their C order
COUNT_KEYS = ("active_lanes", "warp_steps", "lane_steps", "march_steps",
              "lanes")
# what K2's path lane loop counts hold (csrc/path_loop.cuh PathCounts), in
# their C order: the lanes active at the cast site summed over each warp's
# casts, the warp casts, the lanes' closest and shadow casts, the distant
# lights whose shadow ray a bounce did not need, the bounces, the lanes
# run, the lanes parked inside the launch, the cycles inside the casts and
# the threads' cycles
LOOP_KEYS = ("active_lanes", "warp_casts", "closest_casts", "shadow_casts",
             "shadows_skipped", "lane_bounces", "lanes", "parked", "cast_cycles",
             "lane_cycles")
# what the walk counts hold per cast kind (csrc/bvh.cuh WalkCounts), in
# their C order, and the kinds
WALK_KEYS = ("casts", "nodes", "boxes", "leaves", "tris", "insts", "blocks",
             "active_lanes", "warp_steps", "cycles", "deepest_stack")
CAST_KINDS = ("closest", "shadow")
# the ray-cast probe's rows (csrc/cast_launch.cuh): rays in, results out
RAY_W, CAST_OUT_W = 10, 4
SOBOL = "_sobol"    # suffix of a Sobol instance's name
MXU_KINDS = ("hi", "def", "vpu")   # mxu_probe's kinds, in the C order
MAX_LANES = 1 << 31   # the megakernel's lane ids and count are C ints
# the shared memory of the immediates' cast rows, which every kernel copies
# in at its start (csrc/intersect.cuh stage_imm): at most the rows of the
# immediates caps, 52 KB, which leaves four 128-thread blocks on an SM of
# the card's 228 KB (227 KB a block at most)
IMM_SMEM_MAX = (P.MAX_TRIS * P.IMM_TRI_W + P.MAX_SPHERES * P.IMM_SPH_W) * 4
SMEM_PER_BLOCK = 227 * 1024
# launches of each kernel instance; wave_genesis, wave_permute and
# sobol_probe live in the wave_path library, rowslice_probe and the
# mxu_probe kinds in the probes library
launches = dict.fromkeys(
    [v + s for v in VARIANTS if v != "probes" for s in ("", SOBOL)]
    + [COUNT, IMM_COUNT, WAVE_COUNT, PATH_WAVE_COUNT, WALK_COUNT, TEX_COUNT,
       PATH_COUNT]
    + ["wave_genesis", "wave_genesis" + SOBOL, "wave_permute",
       "sobol_probe", "rowslice_probe", "cast_probe", "tex_probe",
       "floor_probe", "empty_probe"]
    + ["mxu_probe_" + k for k in MXU_KINDS], 0)

_libs: Dict[str, ctypes.CDLL] = {}
# ptxas's register and spill report of each library built with
# build(verbose=True), and the seconds from the start of the build that
# each library's nvcc took to end
ptxas: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def ptxas_summary(report: str) -> list:
    """Per kernel function of an nvcc -Xptxas=-v report (its kernels,
    not the device functions that real calls keep): (name, registers,
    spill store bytes, spill load bytes, static shared memory bytes)."""
    spills, used, entry, props = {}, {}, None, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and props:
            spills[props] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            smem = re.search(r"(\d+) bytes smem", ln)
            used[entry] = (int(m.group(1)), int(smem.group(1)) if smem else 0)
            entry = None
    return [(n, r, *spills.get(n, (0, 0)), sm) for n, (r, sm) in used.items()]


def variant(tabs, kernel: str = "mega_path") -> str:
    """The kernel instance of `kernel` (mega_path or wave_path) that runs
    the scene `tabs`: its volpath form for a volpath scene, its mesh form
    for a scene with acceleration tables, its Sobol instance (name +
    "_sobol") under `Sampler "sobol"`. The library that holds it is
    `library(name)`."""
    if tabs["volpath"]:
        kernel = kernel.replace("path", "volpath")
    if tabs["has_accel"]:
        kernel += "_mesh"
    return kernel + SOBOL if tabs["sobol"] else kernel


def library(name: str) -> str:
    """The library (VARIANTS) that holds kernel instance `name`."""
    return name.removesuffix(SOBOL)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where library `name`'s build (BUILDS) for the sources in `csrc`
    lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + list(BUILDS[name])).encode())
    for f in sorted(Path(csrc).glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, csrc: Path = CSRC, names=None,
          reports=None) -> Dict[str, Path]:
    """Compile every variant (or the BUILDS in `names`) whose library for
    the sources in `csrc` does not exist yet, one nvcc each, all at once;
    returns {name: library}. `verbose` prints ptxas's register and
    spill report (kept in `ptxas` for the sources of the package), or
    puts it in the dict `reports` under (csrc, variant) where given."""
    sos = {name: library_path(name, csrc) for name in names or VARIANTS}
    runs = {}
    for name, so in sos.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        source, *flags = BUILDS[name]
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp,
               str(Path(csrc) / source)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        runs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    t0 = time.perf_counter()

    def wait(item):   # each nvcc's output, and when it ended
        name, (_, proc) = item
        out = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        return out
    # one span over the runs together: the waiting threads are not
    # profiled
    with (trace.span("rene.kernels.nvcc") if runs else trace.OFF), \
            ThreadPoolExecutor(max(1, len(runs))) as ex:
        errs = dict(zip(runs, (e for _, e in ex.map(wait, runs.items()))))
    for name, (tmp, proc) in runs.items():
        err = errs[name]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose and err:
            if Path(csrc) == CSRC:
                ptxas[name] = err
            if reports is None:
                print(f"{name}:\n{err}")
            else:
                reports[str(csrc), name] = err
        os.replace(tmp, sos[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return sos


def ptx(name: str, csrc: Path = CSRC) -> str:
    """The PTX of library `name` (BUILDS) for the sources in `csrc`:
    nvcc's virtual-architecture code for compute_90a, with the build's
    own defines and optimisation (the CLI's --dump-module)."""
    source, *flags = BUILDS[name]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, name + ".ptx")
        res = subprocess.run(
            [_nvcc(), "-arch=compute_90a", "-std=c++17", "-O3", "-ptx",
             *flags, "-o", out, str(Path(csrc) / source)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{name}: nvcc -ptx failed "
                               f"({res.returncode}):\n{res.stderr}")
        with open(out) as f:
            return f.read()


def load_library(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """Library `name` (BUILDS) built from the sources in `csrc` (the
    package's own by default, as `_load` does), bound and loaded."""
    return bind(ctypes.CDLL(str(build(csrc=csrc, names=[name])[name])),
                VARIANTS[name][0] if name in VARIANTS else name)


# argument types of the C entry points (csrc/launch.cuh,
# csrc/wave_launch.cuh)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SCENE_ARGTYPES = ([_P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I,
                   _P]
                  + [_P, _P, _I, _P]  # mesh, insts, n_inst, sph_tab
                  + [_P, _P, _I]  # wnodes, mesh_vt, top
                  + [_P, _I, _P, _P, _P, _P]      # mesh_uv .. env_pdf
                  + [_P, _P]   # env_guide, imm
                  + [_I] * 12   # scalars, has_tri_emitter .. sobol
                  + [_P, _I])   # media, n_media
ARGTYPES = SCENE_ARGTYPES + [_I] * 5 + [_P, _P]  # seed, num_samples, pack,
                                                # pix0, n_run; out, stream
WAVE_ARGTYPES = (SCENE_ARGTYPES + [_I] * 7   # seed, launch, k, n_run,
                                             # n_pad, base, rem
                 + [_F] * 6 + [_P, _P])      # key bounds, state, stream
GENESIS_ARGTYPES = [_P, _P, _P] + [_I] * 8 + [_P, _P]
PERMUTE_ARGTYPES = [_P, _P, _I, _P, _P]
PROBE_ARGTYPES = [_P, _I, _P, _P]
ROWSLICE_ARGTYPES = [_I, _I, _P, _I, _P, _I, _P, _P]
MXU_ARGTYPES = [_I, _P, _P, _I, _I, _I, _P, _P]
# the ray-cast probe: the scene's tables (the first 31 of SCENE_ARGTYPES),
# has_tri_emitter, has_tex, has_env; rays, n, out, stream
CAST_TABLES = 30
CAST_ARGTYPES = SCENE_ARGTYPES[:CAST_TABLES] + [_I] * 3 + [_P, _I, _P, _P]
# the texture-fetch probe: atlas, rows, n, out, stream
TEX_PROBE_ARGTYPES = [_P, _P, _I, _P, _P]
_ENTRY_POINTS = {
    "mega_path.cu": {"mega_path_launch": ARGTYPES},
    WALK_COUNT: {"mega_path_launch": ARGTYPES,
                 "walk_counts_read": [_P, _I, _P]},
    TEX_COUNT: {"mega_path_launch": ARGTYPES,
                "tex_counts_read": [_P, _I, _P]},
    PATH_COUNT: {"mega_path_launch": ARGTYPES,
                 "path_counts_read": [_P, _I, _P]},
    COUNT: {"mega_path_launch": ARGTYPES, "step_counts": [_P, _I, _P]},
    IMM_COUNT: {"mega_path_launch": ARGTYPES, "step_counts": [_P, _I, _P]},
    WAVE_COUNT: {"wave_path_launch": WAVE_ARGTYPES,
                 "step_counts": [_P, _I, _P]},
    PATH_WAVE_COUNT: {"wave_path_launch": WAVE_ARGTYPES,
                      "loop_counts_read": [_P, _I, _P]},
    "wave.cu": {"wave_path_launch": WAVE_ARGTYPES,
                "wave_genesis_launch": GENESIS_ARGTYPES,
                "wave_permute_launch": PERMUTE_ARGTYPES,
                "sobol_probe_launch": PROBE_ARGTYPES},
    "probes.cu": {"rowslice_probe_launch": ROWSLICE_ARGTYPES,
                  "mxu_probe_launch": MXU_ARGTYPES,
                  "floor_probe_launch": [_I, _I, _P, _P, _P],
                  "empty_probe_launch": [_P]}}


def bind(lib: ctypes.CDLL, source: str) -> ctypes.CDLL:
    """Set the argument and return types of the entry points of `source`
    (a source, or a counting build's name)."""
    entries = dict(_ENTRY_POINTS[source])
    if hasattr(lib, "cast_probe_launch"):   # the mesh and path builds
        entries["cast_probe_launch"] = CAST_ARGTYPES
    if hasattr(lib, "tex_probe_launch"):
        entries["tex_probe_launch"] = TEX_PROBE_ARGTYPES
    for fn, argtypes in entries.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        if name in VARIANTS and not library_path(name).exists():
            # every variant at once, at the first use of one that is not
            # built (a warmed cache builds none); the probes, which share
            # no code with the others, alone
            build(names=["probes"] if name == "probes" else None)
        _libs[name] = load_library(name)
    return _libs[name]


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def scene_args(tabs, beckmann: bool, device) -> tuple:
    """Checked C arguments of the scene, the first of mega_path_launch's
    and wave_path_launch's. Every table must lie on `device`."""
    f32, i32 = torch.float32, torch.int32
    n_tri = tabs["tris"].shape[0]
    n_light = tabs["lights"].shape[0]
    n_pix = tabs["width"] * tabs["height"]
    n_blocks = tabs["sph_box"].shape[0]
    for name, dtype, shape in (
            ("tris", f32, (None, P.TRI_W)),
            ("spheres", f32, (None, P.SPH_W)),
            ("mats", f32, (None, P.MAT_W)),
            ("emit_objects", f32, (None, P.EO_W)),
            ("emit_tris", i32, (None,)),
            ("emit_spheres", i32, (None,)),
            ("lights", f32, (None, P.LIGHT_W)),
            ("light_dots", f32, (n_light, n_tri, 4)),
            ("cam", f32, (P.CAM_W,)),
            ("mesh", f32, (None, A.MESH_W)),
            ("insts", f32, (None, A.INST_W)),
            ("sph_tab", f32, (n_blocks * A.SPH_BLOCK, A.SPHT_W)),
            ("sph_box", f32, (None, A.BOX_W)),
            ("wnodes", f32, (None, A.NODE4_W)),
            ("mesh_vt", f32, (tabs["mesh"].shape[0], A.VT_W)),
            ("mesh_uv", f32, (None, A.MESH_UV_W)),
            ("atlas", i32, (None,)),
            ("imm", f32, (n_tri * P.IMM_TRI_W
                          + tabs["spheres"].shape[0] * P.IMM_SPH_W,)),
            ("env_guide", torch.uint8, (None, P.ENV_GUIDE)),
            ("env_mcdf", f32, (None,)),
            ("env_ccdf", f32, (None, ENV_GW)),
            ("env_pdf", f32, (None, ENV_GW)),
            ("media", f32, (None, P.MED_W))):
        _check(tabs[name], name, dtype, shape, device)
    n_imm = tabs["imm"].numel() * 4
    if n_imm > IMM_SMEM_MAX:
        raise ValueError(
            f"imm: {n_tri} triangles and {tabs['spheres'].shape[0]} spheres "
            f"take {n_imm} bytes of shared memory, past the {IMM_SMEM_MAX} "
            f"of the immediates caps ({P.MAX_TRIS} triangles, "
            f"{P.MAX_SPHERES} spheres)")
    n_uv = tabs["mesh_uv"].shape[0]
    if n_uv not in (0, tabs["mesh"].shape[0]):
        raise ValueError(f"mesh_uv: {n_uv} rows for "
                         f"{tabs['mesh'].shape[0]} mesh triangles")
    if not tabs["atlas"].shape[0]:
        raise ValueError("atlas: empty")
    n_env = ENV_GH if tabs["has_env"] else 0
    if not (tabs["env_mcdf"].shape[0] == tabs["env_ccdf"].shape[0]
            == tabs["env_pdf"].shape[0] == n_env) \
            or tabs["env_guide"].shape[0] != (n_env and n_env + 1):
        raise ValueError(f"env tables: expected {n_env} rows")
    if tabs["has_accel"] != (tabs["top"] >= 0) \
            or (tabs["top"] >= 0 and not tabs["wnodes"].shape[0]):
        raise ValueError(f"top {tabs['top']}: {tabs['wnodes'].shape[0]} "
                         f"wide nodes, has_accel {tabs['has_accel']}")

    def ptr(name):
        return tabs[name].data_ptr()

    return (ptr("tris"), n_tri, ptr("spheres"), tabs["spheres"].shape[0],
            ptr("mats"), ptr("emit_objects"), tabs["emit_objects"].shape[0],
            ptr("emit_tris"), tabs["emit_tris"].shape[0],
            ptr("emit_spheres"), tabs["emit_spheres"].shape[0],
            ptr("lights"), ptr("light_dots"), n_light, ptr("cam"),
            ptr("mesh"), ptr("insts"), tabs["insts"].shape[0],
            ptr("sph_tab"), ptr("wnodes"), ptr("mesh_vt"), int(tabs["top"]),
            ptr("mesh_uv"), n_uv, ptr("atlas"), ptr("env_mcdf"),
            ptr("env_ccdf"), ptr("env_pdf"), ptr("env_guide"), ptr("imm"),
            int(tabs["has_tri_emitter"]),
            tabs["width"], n_pix, tabs["max_depth"], int(tabs["use_rr"]),
            int(beckmann), int(tabs["has_accel"]), int(tabs["block_seed"]),
            int(tabs["has_tex"]), int(tabs["has_env"]), int(runs_tex(tabs)),
            int(tabs["sobol"]),
            ptr("media"), tabs["media"].shape[0])


def runs_tex(tabs) -> bool:
    """The scene runs texture code (textured materials, a textured
    background or env-map sampling): the kernels launch their instance
    with it (template parameter TEX); the other holds none."""
    return bool(tabs["has_tex"] or tabs["has_env"]
                or tabs["bg_kind"] != P.BG_CONST)


def lane_count(tabs, pack: int) -> int:
    """The megakernel's lanes at `pack` sample slots per pixel (rng.PACKS;
    above 1 on cluster-mode tables only), checked against MAX_LANES."""
    block_edge(pack)
    n_lanes = tabs["width"] * tabs["height"] * pack
    if pack != 1 and not tabs["block_seed"]:
        raise ValueError(f"pack {pack}: only cluster-mode scenes pack")
    if n_lanes >= MAX_LANES:
        raise ValueError(f"pack {pack}: {n_lanes} lanes reach 2^31")
    return n_lanes


def pixel_range(tabs, pixels=None) -> tuple:
    """(pix0, n_run): the launch's pixels [pix0, pix0 + n_run), checked
    against the film; `pixels` None is the whole film."""
    npix = tabs["width"] * tabs["height"]
    pix0, n_run = (0, npix) if pixels is None else map(int, pixels)
    if pix0 < 0 or n_run < 0 or pix0 + n_run > npix:
        raise ValueError(f"pixels ({pix0}, {n_run}): outside the film's "
                         f"{npix}")
    return pix0, n_run


def range_lanes(tabs, pixels, pack: int, device) -> torch.Tensor:
    """The lane ids a launch over `pixels` (`pixel_range`) runs, in the
    order of its output: slot-major, slot s of pixel pix0 + j at s * n_run
    + j (csrc/mega_lane.cuh `lane_of`)."""
    pix0, n_run = pixel_range(tabs, pixels)
    i = torch.arange(n_run * pack, device=device)
    npix = tabs["width"] * tabs["height"]
    return i // max(n_run, 1) * npix + pix0 + i % max(n_run, 1)


def launch_args(tabs, seed: int, num_samples: int, beckmann: bool,
                out: torch.Tensor, pack: int = 1, pixels=None) -> tuple:
    """Checked C arguments of mega_path_launch, all but the stream: `pack`
    sample slots per pixel, one lane each (`lane_count`), over the pixels
    `pixels` (`pixel_range`; the whole film by default). Every table must
    lie on out's device."""
    lane_count(tabs, pack)
    pix0, n_run = pixel_range(tabs, pixels)
    _check(out, "out", torch.float32, (P.OUT_ROWS, n_run * pack), out.device)
    return scene_args(tabs, beckmann, out.device) + (
        int(seed), int(num_samples), int(pack), pix0, n_run, out.data_ptr())


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launched(name: str, launch, *args) -> None:
    """Enqueue `launch(*args)` (a library's entry point) inside span
    `rene.launch.<name>`, raise on its error code and count it."""
    with trace.span("rene.launch." + name):
        rc = launch(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1


def _card_stream(stream: str, what: str) -> None:
    """The wave kernels draw the "mixed" lane streams only; the "jax"
    streams (rng.wave_state) exist in the plain versions alone."""
    if stream != "mixed":
        raise ValueError(f"{what}: stream {stream!r}: the CUDA kernel draws "
                         f"the 'mixed' lane streams only")


def _cuda(device, what: str) -> bool:
    """True for a CUDA device, False for the CPU; raises otherwise."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} needs CUDA or CPU tensors, got {device}")
    return device.type == "cuda"


def mega_path(tabs, seed: int, num_samples: int,
              beckmann: bool = False, pack: int = 1,
              pixels=None) -> torch.Tensor:
    """Launch the megakernel (csrc/mega_path.cu) over every pixel of the
    film, or over the pixels `pixels` = (pix0, n_run) (a tiles-mode
    rank's, `pixel_range`), `pack` sample slots each (K1f; cluster-mode
    tables only), in the variant the scene needs (`variant`: the path or
    the volpath body); returns the (10, n_run * pack) float32 per-lane
    sums (radiance rgb, first-hit normal xyz, albedo rgb, rays), column
    s * n_run + j slot s of pixel pix0 + j (lane id `range_lanes`; over
    the whole film, lane l is pixel l % npix at slot l // npix). A lane's
    sums depend on its id alone, so a range's columns are those of the
    whole film's launch. `tabs` is integrators.mega_path.device_tables.
    Tables on the CPU run the kernel's plain version, `path_lanes_ref`
    (for volpath tables the volpath bounce, `vol_lanes_ref`), and launch
    nothing."""
    device = tabs["tris"].device
    if not _cuda(device, "mega_path"):
        from .integrators.mega_path import path_lanes_ref
        from .integrators.volpath import vol_lanes_ref
        lanes = (None if pixels is None
                 else range_lanes(tabs, pixels, pack, device))
        return (vol_lanes_ref if tabs["volpath"] else path_lanes_ref)(
            tabs, seed, num_samples, beckmann, lanes=lanes, pack=pack)
    out = torch.empty((P.OUT_ROWS, pixel_range(tabs, pixels)[1] * pack),
                      dtype=torch.float32, device=device)
    args = launch_args(tabs, seed, num_samples, beckmann, out, pack, pixels)
    name = variant(tabs)
    _launched(name, _load(library(name)).mega_path_launch, *args,
              _stream(device))
    return out


def mega_volpath_counts(tabs, seed: int, num_samples: int,
                        beckmann: bool = False, pack: int = 1):
    """The volpath megakernel's launch of `mega_path` (independent
    sampler, CUDA tables only) through the counting build of the scene's
    variant, COUNT (mesh) or IMM_COUNT (immediates): returns its (10,
    npix * pack) sums and {COUNT_KEYS: int}, the sums over the launch of
    the active lanes that each warp's leader sees at the lane loop's cast
    site and of its warp steps, of the lanes' steps and march steps, and
    the lanes. For the probe and the benchmark's traced runs; no render
    path launches it."""
    device = tabs["tris"].device
    if not _cuda(device, "mega_volpath_counts") \
            or variant(tabs) not in ("mega_volpath", "mega_volpath_mesh"):
        raise ValueError("mega_volpath_counts: volpath tables with the "
                         "independent sampler on a CUDA device only")
    out = torch.empty((P.OUT_ROWS, lane_count(tabs, pack)),
                      dtype=torch.float32, device=device)
    args = launch_args(tabs, seed, num_samples, beckmann, out, pack)
    name = COUNT if tabs["has_accel"] else IMM_COUNT
    return out, _read_counted(name, "step_counts", COUNT_KEYS,
                              lambda lib: lib.mega_path_launch(
                                  *args, _stream(device)), device)


def mega_path_walk_counts(tabs, seed: int, num_samples: int,
                          beckmann: bool = False, pack: int = 1):
    """The path mesh megakernel's launch of `mega_path` (independent
    sampler, CUDA tables only) through the counting build WALK_COUNT:
    returns its (10, npix * pack) sums and {kind: {WALK_KEYS: int}} for
    the kinds CAST_KINDS, the walks' counts summed over the launch (the
    deepest stack its maximum), and "lane_cycles", the threads' clock
    cycles. For the probe; no render path launches it."""
    device = tabs["tris"].device
    if not _cuda(device, "mega_path_walk_counts") \
            or variant(tabs) != "mega_path_mesh":
        raise ValueError("mega_path_walk_counts: path mesh tables with the "
                         "independent sampler on a CUDA device only")
    out = torch.empty((P.OUT_ROWS, lane_count(tabs, pack)),
                      dtype=torch.float32, device=device)
    args = launch_args(tabs, seed, num_samples, beckmann, out, pack)
    return out, _walk_counted(lambda lib: lib.mega_path_launch(
        *args, _stream(device)), device)


def _walk_counted(launch, device) -> dict:
    """Run launch(lib) with the counting build WALK_COUNT between two
    reads of its walk counts that zero them: the launch's counts by cast
    kind, and the threads' cycles."""
    keys = [f"{k} {w}" for k in CAST_KINDS for w in WALK_KEYS]
    c = _read_counted(WALK_COUNT, "walk_counts_read", keys + ["lane_cycles"],
                      launch, device)
    out = {k: {w: c[f"{k} {w}"] for w in WALK_KEYS} for k in CAST_KINDS}
    out["lane_cycles"] = c["lane_cycles"]
    return out


def mega_path_tex_counts(tabs, seed: int, num_samples: int,
                         beckmann: bool = False, pack: int = 1):
    """The path mesh megakernel's launch of `mega_path` (independent
    sampler, CUDA tables only) through the counting build TEX_COUNT:
    returns its (10, npix * pack) sums and {TEX_KEYS: int}, the texture
    calls' counts summed over the launch. For the probe; no render path
    launches it."""
    device = tabs["tris"].device
    if not _cuda(device, "mega_path_tex_counts") \
            or variant(tabs) != "mega_path_mesh":
        raise ValueError("mega_path_tex_counts: path mesh tables with the "
                         "independent sampler on a CUDA device only")
    out = torch.empty((P.OUT_ROWS, lane_count(tabs, pack)),
                      dtype=torch.float32, device=device)
    args = launch_args(tabs, seed, num_samples, beckmann, out, pack)
    return out, _read_counted(TEX_COUNT, "tex_counts_read", TEX_KEYS,
                              lambda lib: lib.mega_path_launch(
                                  *args, _stream(device)), device)


def mega_path_counts(tabs, seed: int, num_samples: int,
                     beckmann: bool = False):
    """The path immediates megakernel's launch of `mega_path`
    (independent sampler, CUDA tables only) through the counting build
    PATH_COUNT: returns its (10, npix) sums and {PATH_KEYS: int}, the
    lanes' cycles by phase and the lane loop's bounces summed over the
    launch. For the probe; no render path launches it."""
    device = tabs["tris"].device
    if not _cuda(device, "mega_path_counts") \
            or variant(tabs) != "mega_path":
        raise ValueError("mega_path_counts: path immediates tables with the "
                         "independent sampler on a CUDA device only")
    out = torch.empty((P.OUT_ROWS, lane_count(tabs, 1)),
                      dtype=torch.float32, device=device)
    args = launch_args(tabs, seed, num_samples, beckmann, out)
    return out, _read_counted(PATH_COUNT, "path_counts_read", PATH_KEYS,
                              lambda lib: lib.mega_path_launch(
                                  *args, _stream(device)), device)


def _read_counted(name: str, reader: str, keys, launch, device) -> dict:
    """Run launch(lib) with the counting build `name` between two calls of
    its entry point `reader` that read and zero its counts: the launch's
    counts, {keys: int}."""
    counts = torch.empty(len(keys), dtype=torch.int64, device=device)
    lib = _load(name)

    def read():
        rc = getattr(lib, reader)(counts.data_ptr(), 1, _stream(device))
        if rc != 0:
            raise RuntimeError(f"{reader} failed: cudaError {rc}")
    read()
    _launched(name, launch, lib)
    read()
    return dict(zip(keys, counts.tolist()))


def probe_library(tabs) -> str:
    """The library whose ray-cast and texture-fetch probes serve the
    scene `tabs`: its mesh build, or the path immediates build."""
    if not tabs["has_accel"]:
        return "mega_path"
    return library(variant(tabs))


def tex_probe(tabs, rows: torch.Tensor) -> torch.Tensor:
    """The texture-fetch probe (csrc/tex_launch.cuh) of the scene's path
    build: each (TEXP_W,) row of `rows` (the image's texel offset, width
    and height, u, v; ops/texture.py fetch_log records them) fetched
    through the kernels' fetch alone; returns the (n, 3) float32 rgb. CPU
    tensors run ops/texture.py `fetch_rows_ref`. Counted as tex_probe; the
    probe lies on no render path."""
    from .ops.texture import TEXP_W, fetch_rows_ref
    device = rows.device
    if not _cuda(device, "tex_probe"):
        return fetch_rows_ref(tabs["atlas"], rows)
    _check(rows, "rows", torch.float32, (None, TEXP_W), device)
    _check(tabs["atlas"], "atlas", torch.int32, (None,), device)
    out = torch.empty((rows.shape[0], 3), dtype=torch.float32, device=device)
    _launched("tex_probe", _load(probe_library(tabs)).tex_probe_launch,
              tabs["atlas"].data_ptr(), rows.data_ptr(), rows.shape[0],
              out.data_ptr(), _stream(device))
    return out


def cast_probe(tabs, rays: torch.Tensor, counting: bool = False):
    """The ray-cast probe (csrc/cast_launch.cuh) of the scene's mesh
    build, or for a scene without acceleration tables of the path
    immediates build: each (RAY_W,) row of `rays` (origin, direction,
    tmin, tmax, kind 0 closest or 1 shadow, the shadow ray's distant
    light) cast alone; returns the (n, CAST_OUT_W) float32 rows
    t, part, row, hit flag (ops.intersect.cast_ref). CPU tensors run
    `cast_ref`. `counting`: through the counting build WALK_COUNT (path
    mesh tables), and returns (rows, its walk counts) as
    `mega_path_walk_counts` does. Counted as cast_probe; the probe lies
    on no render path."""
    from .ops.intersect import cast_ref
    device = rays.device
    if not _cuda(device, "cast_probe"):
        if counting:
            raise ValueError("cast_probe: counting on a CUDA device only")
        return cast_ref(tabs, rays)
    out = torch.empty((rays.shape[0], CAST_OUT_W), dtype=torch.float32,
                      device=device)
    args = cast_args(tabs, rays, out) + (_stream(device),)
    if counting:
        if variant(tabs) != "mega_path_mesh":
            raise ValueError("cast_probe: counting takes path mesh tables")
        return out, _walk_counted(lambda lib: lib.cast_probe_launch(*args),
                                  device)
    _launched("cast_probe", _load(probe_library(tabs)).cast_probe_launch,
              *args)
    return out


def cast_args(tabs, rays: torch.Tensor, out: torch.Tensor) -> tuple:
    """Checked C arguments of cast_probe_launch, all but the stream: the
    (n, RAY_W) `rays` in, the (n, CAST_OUT_W) `out`, the tables on their
    device."""
    device = rays.device
    _check(rays, "rays", torch.float32, (None, RAY_W), device)
    _check(out, "out", torch.float32, (rays.shape[0], CAST_OUT_W), device)
    sa = scene_args(tabs, False, device)
    n_tab = CAST_TABLES   # the tables, then has_tri_emitter .. has_env
    return sa[:n_tab] + (sa[n_tab], sa[n_tab + 8], sa[n_tab + 9],
                         rays.data_ptr(), rays.shape[0], out.data_ptr())


def wave_path(tabs, state: torch.Tensor, seed: int, launch: int, k: int,
              n_run: int, kb, base: int, rem: int, beckmann: bool = False,
              stream: str = "mixed") -> torch.Tensor:
    """K2: advance every alive lane of the first `n_run` lanes of the wave
    `state` by `k` bounces in place, with the lane streams `stream` of
    launch `launch` of the wave (csrc/wave.cu, the scene's variant: the
    path or the volpath bounce, and its Sobol instance under Sobol, whose
    sample indices follow from the wave's base * spw + rem samples per
    pixel); `kb` is wave.key_bounds. CPU tensors run `wave_step_ref`;
    CUDA tensors take only the "mixed" streams. Returns `state`."""
    from .integrators import wave as WV
    device = state.device
    if not _cuda(device, "wave_path"):
        return WV.wave_step_ref(tabs, state, seed, launch, k, n_run, kb,
                                base, rem, beckmann, stream)
    _card_stream(stream, "wave_path")
    name = variant(tabs, "wave_path")
    _launched(name, _load(library(name)).wave_path_launch,
              *_wave_args(tabs, state, seed, launch, k, n_run, kb, base,
                          rem, beckmann), _stream(device))
    return state


def _wave_args(tabs, state, seed, launch, k, n_run, kb, base, rem,
               beckmann) -> tuple:
    """Checked C arguments of wave_path_launch, all but the stream."""
    from .integrators import wave as WV
    device = state.device
    _check(state, "state", torch.float32, (WV.W_NROWS, None), device)
    n_pad = state.shape[1]
    if n_pad % WV.W_TILE or not 0 <= n_run <= n_pad or len(kb) != 6:
        raise ValueError(f"wave_path: n_run {n_run}, n_pad {n_pad}, "
                         f"{len(kb)} key bounds")
    if base < 0 or rem < 0:
        raise ValueError(f"wave_path: base {base}, rem {rem}")
    return scene_args(tabs, beckmann, device) + (
        int(seed), int(launch), int(k), int(n_run), n_pad, int(base),
        int(rem), *kb, state.data_ptr())


def wave_volpath_counts(tabs, state: torch.Tensor, seed: int, launch: int,
                        k: int, n_run: int, kb, base: int, rem: int,
                        beckmann: bool = False):
    """The volpath mesh K2 launch of `wave_path` (independent sampler,
    CUDA tables only) through the counting build: returns the state and
    {COUNT_KEYS: int}, the sums over the launch of the active lanes that
    each warp's leader sees at the lane loop's cast site and of its warp
    steps, of the threads' steps and march steps, and the alive lanes
    run. For the probe; no render path launches it."""
    if not _cuda(state.device, "wave_volpath_counts") \
            or variant(tabs, "wave_path") != "wave_volpath_mesh":
        raise ValueError("wave_volpath_counts: volpath mesh tables with the "
                         "independent sampler on a CUDA device only")
    args = _wave_args(tabs, state, seed, launch, k, n_run, kb, base, rem,
                      beckmann)
    return state, _read_counted(WAVE_COUNT, "step_counts", COUNT_KEYS,
                                lambda lib: lib.wave_path_launch(
                                    *args, _stream(state.device)),
                                state.device)


def wave_path_counts(tabs, state: torch.Tensor, seed: int, launch: int,
                     k: int, n_run: int, kb, base: int, rem: int,
                     beckmann: bool = False):
    """The path mesh K2 launch of `wave_path` (either sampler, CUDA tables
    only) through the counting build: returns the state and
    {LOOP_KEYS: int}, the sums over the launch of the active lanes that
    each warp's leader sees at the lane loop's cast site and of its warp
    casts, of the lanes' closest and shadow casts, the shadow rays their
    bounces did not need, their bounces, the alive lanes run, those that
    parked, the cycles inside the casts and the threads' cycles. For the
    probe; no render path launches it."""
    if not _cuda(state.device, "wave_path_counts") or library(
            variant(tabs, "wave_path")) != "wave_path_mesh":
        raise ValueError("wave_path_counts: path mesh tables on a CUDA "
                         "device only")
    args = _wave_args(tabs, state, seed, launch, k, n_run, kb, base, rem,
                      beckmann)
    return state, _read_counted(PATH_WAVE_COUNT, "loop_counts_read",
                                LOOP_KEYS, lambda lib: lib.wave_path_launch(
                                    *args, _stream(state.device)),
                                state.device)


def wave_genesis(tabs, pxf: torch.Tensor, pyf: torch.Tensor, n_real: int,
                 seed: int, base: int, rem: int,
                 stream: str = "mixed") -> torch.Tensor:
    """K3: the (W_NROWS, n_pad) state of a fresh wave of base * spw + rem
    samples per pixel, over lanes whose pixel coordinates are `pxf` and
    `pyf`, with the lane streams `stream` (csrc/wave.cu; its Sobol
    instance under Sobol). CPU tensors run `genesis_ref`; CUDA tensors
    take only the "mixed" streams."""
    from .integrators import wave as WV
    device = pxf.device
    width, npix = tabs["width"], tabs["width"] * tabs["height"]
    if not _cuda(device, "wave_genesis"):
        return WV.genesis_ref(tabs["cam_f"], pxf, pyf, width, npix, n_real,
                              seed, base, rem, stream, tabs["sobol"])
    _card_stream(stream, "wave_genesis")
    n_pad = pxf.shape[0]
    _check(tabs["cam"], "cam", torch.float32, (P.CAM_W,), device)
    _check(pxf, "pxf", torch.float32, (None,), device)
    _check(pyf, "pyf", torch.float32, (n_pad,), device)
    if not 0 <= n_real <= n_pad:
        raise ValueError(f"wave_genesis: n_real {n_real}, n_pad {n_pad}")
    state = torch.empty((WV.W_NROWS, n_pad), dtype=torch.float32,
                        device=device)
    name = "wave_genesis" + (SOBOL if tabs["sobol"] else "")
    _launched(name, _load("wave_path").wave_genesis_launch,
              tabs["cam"].data_ptr(), pxf.data_ptr(), pyf.data_ptr(), width,
              npix, int(n_real), n_pad, int(seed), int(base), int(rem),
              int(tabs["sobol"]), state.data_ptr(), _stream(device))
    return state


def wave_permute(state: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """K4: a new state whose 128-lane slice j holds rows [0, 24) of slice
    perm[j] of `state` and its own AOV rows (csrc/wave.cu). `perm` is an
    int32 permutation of the slices. CPU tensors run `permute_ref`."""
    from .integrators import wave as WV
    device = state.device
    if not _cuda(device, "wave_permute"):
        return WV.permute_ref(state, perm)
    _check(state, "state", torch.float32, (WV.W_NROWS, None), device)
    n_pad = state.shape[1]
    if n_pad % WV.W_SLICE:
        raise ValueError(f"wave_permute: n_pad {n_pad}")
    _check(perm, "perm", torch.int32, (n_pad // WV.W_SLICE,), device)
    out = torch.empty_like(state)
    _launched("wave_permute", _load("wave_path").wave_permute_launch,
              state.data_ptr(), perm.data_ptr(), n_pad, out.data_ptr(),
              _stream(device))
    return out


def sobol_probe(x: torch.Tensor) -> torch.Tensor:
    """The Sobol probe (csrc/wave.cu sobol_probe_kernel, the counterpart
    of scripts/tpu_session_r3ac.py's Mosaic probes): the (7, n) int32
    rows of ops/sobol.py `probe_ref` for the int32 inputs `x`. A CPU
    tensor runs `probe_ref`."""
    from .ops.sobol import probe_ref
    if not _cuda(x.device, "sobol_probe"):
        return probe_ref(x)
    _check(x, "x", torch.int32, (None,), x.device)
    out = torch.empty((7, x.shape[0]), dtype=torch.int32, device=x.device)
    _launched("sobol_probe", _load("wave_path").sobol_probe_launch,
              x.data_ptr(), x.shape[0], out.data_ptr(), _stream(x.device))
    return out


def rowslice_probe(mode: int, si: int, box: torch.Tensor,
                   geom: torch.Tensor) -> torch.Tensor:
    """P-r3n (csrc/probes.cu rowslice_kernel, the counterpart of
    scripts/tpu_session_r3n.py's Mosaic probes k_p1 / k_p2 / k_p3): the
    (8, 128) float32 block of `geom` (8, 128 j) at the group index that
    probe `mode` (1, 2 or 3) reads from the (2 n, 128) `box` for group
    `si`. CPU tensors run ops/probes.py `rowslice_ref`."""
    from .ops.probes import R3N_MODES, rowslice_ref
    device = box.device
    if not _cuda(device, "rowslice_probe"):
        return rowslice_ref(mode, si, box, geom)
    if mode not in R3N_MODES:
        raise ValueError(f"rowslice_probe: mode {mode}, one of {R3N_MODES}")
    _check(box, "box", torch.float32, (None, 128), device)
    _check(geom, "geom", torch.float32, (8, None), device)
    if box.shape[0] < 2 or box.shape[0] % 2 or geom.shape[1] < 128 \
            or geom.shape[1] % 128:
        raise ValueError(f"rowslice_probe: box {tuple(box.shape)}, geom "
                         f"{tuple(geom.shape)}")
    out = torch.empty((8, 128), dtype=torch.float32, device=device)
    _launched("rowslice_probe", _load("probes").rowslice_probe_launch,
              int(mode), int(si), box.data_ptr(), box.shape[0],
              geom.data_ptr(), geom.shape[1], out.data_ptr(),
              _stream(device))
    return out


def mxu_probe(kind: str, b: torch.Tensor, r: torch.Tensor,
              reps: int) -> torch.Tensor:
    """P-r3w (csrc/probes.cu, the counterpart of
    scripts/tpu_session_r3w.py's k_mxu_hi, k_mxu_def and k_vpu), `reps`
    runs inside one launch: for "hi" and "def" the (m, n) float32 product
    b (m, 8) @ r (8, n) on the tensor cores (3xTF32 on wgmma; one bf16
    pass on mma.sync), for "vpu" the (8, 128) values of the scalar chain
    over b's first two rows (n >= 1024). Counted as mxu_probe_<kind>. CPU
    tensors run ops/probes.py `mxu_ref`."""
    from .ops.probes import mxu_ref
    device = b.device
    if not _cuda(device, "mxu_probe"):
        return mxu_ref(kind, b, r, reps)
    if kind not in MXU_KINDS or reps < 1:
        raise ValueError(f"mxu_probe: kind {kind!r} (one of {MXU_KINDS}), "
                         f"reps {reps}")
    _check(b, "b", torch.float32, (None, 8), device)
    _check(r, "r", torch.float32, (8, None), device)
    m, n = b.shape[0], r.shape[1]
    # the tiles (probes.cuh): hi 24 rows of b by 64 columns of r a
    # warpgroup (R3W_WG_ROWS), def 16 by 8 x 2 a warp (R3W_MMA_TILES)
    rows, cols = {"hi": (24, 64), "def": (16, 16)}.get(kind, (1, 1))
    if m % rows or n % cols or (kind == "vpu" and n < 1024):
        raise ValueError(f"mxu_probe: b {tuple(b.shape)}, r "
                         f"{tuple(r.shape)}")
    shape = (8, 128) if kind == "vpu" else (m, n)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    _launched("mxu_probe_" + kind, _load("probes").mxu_probe_launch,
              MXU_KINDS.index(kind), b.data_ptr(), r.data_ptr(), m, n,
              int(reps), out.data_ptr(), _stream(device))
    return out


def floor_probe(kind: int, iters: int, device) -> int:
    """SM cycles (clock64) of `iters` links (a multiple of 8) of the
    dependent chain `kind` (csrc/probes.cu floor_kernel, FLOOR_*; names in
    rene_tpu_torch/probes.py FLOOR_KINDS): one block of one warpgroup, on
    the card only. A measurement of latency for the probes' chain floors;
    no path launches it."""
    if not _cuda(device, "floor_probe"):
        raise ValueError("floor_probe: a latency of the card, CUDA only")
    if iters < 8 or iters % 8:
        raise ValueError(f"floor_probe: iters {iters}, a multiple of 8")
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.empty(128, dtype=torch.float32, device=device)
    _launched("floor_probe", _load("probes").floor_probe_launch,
              int(kind), int(iters), cycles.data_ptr(), sink.data_ptr(),
              _stream(device))
    return int(cycles.item())


def empty_probe(device) -> None:
    """One launch of an empty kernel (csrc/probes.cu empty_kernel): the
    least time a launch takes, the floor of a probe whose work is a few
    loads. CUDA only; no path launches it."""
    if not _cuda(device, "empty_probe"):
        raise ValueError("empty_probe: a launch on the card, CUDA only")
    _launched("empty_probe", _load("probes").empty_probe_launch,
              _stream(device))
