"""Build and binding of the port's CUDA kernels.

csrc/mega_path.cu is compiled with nvcc once per kernel variant (the
template parameter MESH, set by -DMEGA_MESH) into shared libraries with a
plain C interface, at first use, into build/rene_tpu_torch/ of the
checkout (named by a hash of the sources and flags, so an edit rebuilds),
all nvcc runs started together, and loaded with ctypes. Nothing is
compiled or imported at module import: the CPU-only tests import this
module freely.

Each wrapper runs its kernel's plain PyTorch version when its tensors lie
on the CPU. On a CUDA device it checks its tensors, allocates its outputs
with torch.empty, launches on the current stream without synchronising,
raises if the launch was refused, and adds one to the `launches` count of
the variant it launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

from .scene import accel as A
from .scene import pack as P

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "rene_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# the kernel's two variants, mega_path_kernel<MESH>: the immediates-only
# path (K1a) and the path with the acceleration tables (K1c, K1d), each
# with its -DMEGA_MESH flag; `launches` counts each variant's launches
VARIANTS = {"mega_path": "-DMEGA_MESH=0", "mega_path_mesh": "-DMEGA_MESH=1"}
launches = dict.fromkeys(VARIANTS, 0)

_libs: Dict[str, ctypes.CDLL] = {}


def variant(tabs) -> str:
    """The kernel variant that runs the scene `tabs`."""
    return "mega_path_mesh" if tabs["has_accel"] else "mega_path"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where variant `name`'s library for the current sources lives
    (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + [VARIANTS[name]]).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Dict[str, Path]:
    """Compile every variant whose library for these sources does not
    exist yet, one nvcc each, all at once; returns {variant: library}.
    `verbose` prints ptxas's register and spill report."""
    sos = {name: library_path(name) for name in VARIANTS}
    runs = {}
    for name, so in sos.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, VARIANTS[name], "-o", tmp,
               str(CSRC / "mega_path.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        runs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in runs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose and err:
            print(f"{name}:\n{err}")
        os.replace(tmp, sos[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return sos


# argument types of mega_path_launch (csrc/launch.cuh)
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = ([_P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P]
            + [_P, _P, _P, _I, _P, _P, _I]  # nodes .. n_sph_blocks
            + [_I] * 11         # scalars, world_root .. num_samples
            + [_P, _P])         # out, stream


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(str(build()[name]))
        lib.mega_path_launch.argtypes = ARGTYPES
        lib.mega_path_launch.restype = ctypes.c_int
        _libs[name] = lib
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


def launch_args(tabs, seed: int, num_samples: int, beckmann: bool,
                out: torch.Tensor) -> tuple:
    """Checked C arguments of mega_path_launch, all but the stream. Every
    table must lie on out's device."""
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
            ("nodes", f32, (None, A.NODE_W)),
            ("mesh", f32, (None, A.MESH_W)),
            ("insts", f32, (None, A.INST_W)),
            ("sph_tab", f32, (n_blocks * A.SPH_BLOCK, A.SPHT_W)),
            ("sph_box", f32, (None, A.BOX_W))):
        _check(tabs[name], name, dtype, shape, out.device)
    _check(out, "out", f32, (P.OUT_ROWS, n_pix), out.device)
    if (tabs["world_root"] >= 0 or tabs["insts"].shape[0]) \
            and not tabs["nodes"].shape[0]:
        raise ValueError("nodes: empty, but the scene has a mesh")

    def ptr(name):
        return tabs[name].data_ptr()

    return (ptr("tris"), n_tri, ptr("spheres"), tabs["spheres"].shape[0],
            ptr("mats"), ptr("emit_objects"), tabs["emit_objects"].shape[0],
            ptr("emit_tris"), tabs["emit_tris"].shape[0],
            ptr("emit_spheres"), tabs["emit_spheres"].shape[0],
            ptr("lights"), ptr("light_dots"), n_light, ptr("cam"),
            ptr("nodes"), ptr("mesh"), ptr("insts"), tabs["insts"].shape[0],
            ptr("sph_tab"), ptr("sph_box"), n_blocks,
            int(tabs["world_root"]), int(tabs["has_tri_emitter"]),
            tabs["width"], n_pix, tabs["max_depth"], int(tabs["use_rr"]),
            int(beckmann), int(tabs["has_accel"]), int(tabs["block_seed"]),
            int(seed), int(num_samples), out.data_ptr())


def mega_path(tabs, seed: int, num_samples: int,
              beckmann: bool = False) -> torch.Tensor:
    """Launch the path megakernel (csrc/mega_path.cu) over every pixel of
    the film, in the variant the scene needs (`variant`); returns the
    (10, N) float32 per-lane sums (radiance rgb, first-hit normal xyz,
    albedo rgb, rays). `tabs` is integrators.mega_path.device_tables.
    Tables on the CPU run the kernel's plain version, `path_lanes_ref`,
    and launch nothing."""
    device = tabs["tris"].device
    if device.type == "cpu":
        from .integrators.mega_path import path_lanes_ref
        return path_lanes_ref(tabs, seed, num_samples, beckmann)
    if device.type != "cuda":
        raise ValueError(f"mega_path needs CUDA or CPU tensors, got {device}")
    out = torch.empty((P.OUT_ROWS, tabs["width"] * tabs["height"]),
                      dtype=torch.float32, device=device)
    args = launch_args(tabs, seed, num_samples, beckmann, out)
    name = variant(tabs)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _load(name).mega_path_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1
    return out
