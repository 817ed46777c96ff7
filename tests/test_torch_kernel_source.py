"""The CUDA kernel's source, checked on the CPU.

csrc/*.cuh hold the per-lane code of csrc/mega_path.cu as plain C++ with
CUDA qualifiers. Compiled here with g++ (qualifiers mapped away, `__ldg`,
`rsqrtf` and `__uint_as_float` given their C meaning) behind the same C
entry point, it runs the kernel's arithmetic without a card and without
FMA contraction, so it must agree with the plain PyTorch version lane for
lane: by the per-pixel rule of rene_tpu_torch.checks, >= 99.5% of
pixels' radiance and of their normal/albedo sums agree, image means
within 1e-4 relative, equal ray counts. The remaining lanes differ by libm against torch's vectorized
sin/cos/log. The wrapper's argument checks run here too.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rene_tpu_torch import checks, kernels
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.scene import pack as P
from .test_torch_mega_path import _buffers
from .test_torch_mesh import buffers as mesh_buffers
from .test_torch_texture import TEXTURED, textured_buffers

torch.set_num_threads(2)


HARNESS = r"""
#include <cmath>
#include <cstring>
#include <cstdint>
#include <cstddef>
#define __device__
#define __forceinline__ inline
#define __ldg(p) (*(p))
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
static inline float __uint_as_float(uint32_t u) {
  float f; memcpy(&f, &u, 4); return f;
}
#include "path.cuh"
// the lanes run one after another
static int run_lanes(const Params& p, void*) {
  for (int lane = 0; lane < p.n_pix; ++lane) {
    if (p.has_accel) trace_lane<true>(p, lane);
    else trace_lane<false>(p, lane);
  }
  return 0;
}
#include "launch.cuh"
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel's per-lane code for the CPU")
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libhost.so"
    res = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
         "-Wno-unknown-pragmas", "-Werror", f"-I{kernels.CSRC}", "-o",
         str(so), str(d / "harness.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    lib.mega_path_launch.argtypes = kernels.ARGTYPES
    lib.mega_path_launch.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("name,beckmann", [
    ("cornell_box", False), ("materials_scene", False),
    ("materials_scene", True), ("lights_only", False)],
    ids=["cornell", "materials", "beckmann", "lights_only"])
def test_cuda_lane_code_matches_plain_version(host_lib, name, beckmann):
    bn, cfg = _buffers(name)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    seed, spp = 99, 4
    out = torch.empty((P.OUT_ROWS, 128 * 64), dtype=torch.float32)
    args = kernels.launch_args(tabs, seed, spp, beckmann, out)
    assert host_lib.mega_path_launch(*args, None) == 0
    ref = M.path_lanes_ref(tabs, seed, spp, beckmann=beckmann).numpy()
    out = out.numpy()
    a = checks.agreement(out, ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.995, a
    assert a["mean_rel"] <= 1e-4, a
    assert out[9].sum() == ref[9].sum()


@pytest.mark.parametrize("name", ["mesh_materials", "instanced",
                                  "sphere_table"])
def test_cuda_mesh_lane_code_matches_plain_version(host_lib, name):
    """The mesh variant (trace_lane<true>: BVH walk, instances, sphere
    table, 32x32-block seeds) against the plain version."""
    tabs = M.device_tables(P.pack_tables(*mesh_buffers(name)), "cpu")
    assert tabs["has_accel"]
    seed, spp = 99, 4
    out = torch.empty((P.OUT_ROWS, 128 * 64), dtype=torch.float32)
    args = kernels.launch_args(tabs, seed, spp, False, out)
    assert host_lib.mega_path_launch(*args, None) == 0
    ref = M.path_lanes_ref(tabs, seed, spp).numpy()
    out = out.numpy()
    a = checks.agreement(out, ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.995, a
    assert a["mean_rel"] <= 1e-4, a
    assert out[9].sum() == ref[9].sum()


@pytest.mark.parametrize("name", list(TEXTURED))
def test_cuda_textured_lane_code_matches_plain_version(host_lib, tmp_path,
                                                       name):
    """csrc/texture.cuh and the textured bounce (per-hit checker and image
    slots, spherical and mesh uv, the image, scale and checker
    backgrounds, env-map light sampling with and without emitters)
    against the plain version."""
    bn, cfg = textured_buffers(name, tmp_path)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    w, h = TEXTURED[name][1]
    seed, spp = 99, 4
    out = torch.empty((P.OUT_ROWS, w * h), dtype=torch.float32)
    args = kernels.launch_args(tabs, seed, spp, False, out)
    assert host_lib.mega_path_launch(*args, None) == 0
    ref = M.path_lanes_ref(tabs, seed, spp).numpy()
    out = out.numpy()
    a = checks.agreement(out, ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.995, a
    assert a["mean_rel"] <= 1e-4, a
    assert out[9].sum() == ref[9].sum()


WAVE_HARNESS = r"""
#include <cmath>
#include <cstring>
#include <cstdint>
#include <cstddef>
#define __device__
#define __forceinline__ inline
#define __ldg(p) (*(p))
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
static inline float __uint_as_float(uint32_t u) {
  float f; memcpy(&f, &u, 4); return f;
}
#include "wave.cuh"
// the lanes, and the slices, run one after another
static int run_wave(const WaveParams& p, void*) {
  for (int lane = 0; lane < p.n_run; ++lane) {
    if (p.has_accel) wave_lane<true>(p, lane);
    else wave_lane<false>(p, lane);
  }
  return 0;
}
static int run_genesis(const GenesisParams& g, void*) {
  for (int lane = 0; lane < g.n_pad; ++lane) genesis_lane(g, lane);
  return 0;
}
static int run_permute(const float* in, const int* perm, int n_pad,
                       float* out, void*) {
  for (int j = 0; j < n_pad / W_SLICE; ++j)
    for (int t = 0; t < W_SLICE; ++t)
      permute_lane(in, perm, (size_t)n_pad, j, t, out);
  return 0;
}
#include "wave_launch.cuh"
"""


@pytest.fixture(scope="module")
def wave_lib(tmp_path_factory):
    """csrc/wave.cuh's per-lane code behind csrc/wave_launch.cuh's entry
    points, compiled with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel's per-lane code for the CPU")
    d = tmp_path_factory.mktemp("host_wave")
    (d / "harness.cpp").write_text(WAVE_HARNESS)
    so = d / "libwave.so"
    res = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
         "-Wno-unknown-pragmas", "-Werror", f"-I{kernels.CSRC}", "-o",
         str(so), str(d / "harness.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return kernels.bind(ctypes.CDLL(str(so)), "wave.cu")


def _host_wave_kernels(lib):
    """kernels.wave_genesis, wave_path and wave_permute through the g++
    build, on CPU tensors."""
    from rene_tpu_torch.integrators import wave as WV

    def genesis(tabs, pxf, pyf, n_real, seed, base, rem, stream="mixed"):
        assert stream == "mixed"
        state = torch.empty((WV.W_NROWS, pxf.shape[0]))
        assert lib.wave_genesis_launch(
            tabs["cam"].data_ptr(), pxf.data_ptr(), pyf.data_ptr(),
            tabs["width"], tabs["width"] * tabs["height"], n_real,
            pxf.shape[0], seed, base, rem, state.data_ptr(), None) == 0
        return state

    def path(tabs, state, seed, launch, k, n_run, kb, beckmann=False,
             stream="mixed"):
        assert stream == "mixed"
        assert lib.wave_path_launch(
            *kernels.scene_args(tabs, beckmann, state.device), seed, launch,
            k, n_run, state.shape[1], *kb, state.data_ptr(), None) == 0
        return state

    def permute(state, perm):
        out = torch.empty_like(state)
        assert lib.wave_permute_launch(state.data_ptr(), perm.data_ptr(),
                                       state.shape[1], out.data_ptr(),
                                       None) == 0
        return out
    return genesis, path, permute


@pytest.mark.parametrize("name", ["materials_scene", "mesh_materials",
                                  "instanced", "tex_image", "env",
                                  "textured_mesh"])
def test_cuda_wave_code_matches_plain_version(wave_lib, monkeypatch, name,
                                              tmp_path):
    """The wave kernels' per-lane code (csrc/wave.cuh) against the plain
    versions in integrators/wave.py: K3 bit for bit on the lane rows and
    within 1e-6 on the camera rays (libm against torch), K4 bit for bit,
    one K2 launch lane by lane on the kernels' "mixed" lane streams
    (>= 99.5% of lanes agree on every row, the key row bit for bit),
    then whole 64x64 waves at spw 2, sorted by `gather` and by `dma`,
    through the g++ kernels against the plain runner (the per-pixel
    rule, equal ray totals). The textured scenes run the wave bounce's
    textures, textured background and env-map light sampling."""
    from rene_tpu_torch.integrators import wave as WV
    if name in TEXTURED:
        bn, cfg = textured_buffers(name, tmp_path, 64, 64)
    else:
        bn, cfg = (_buffers(name, 64) if name == "materials_scene"
                   else mesh_buffers(name, 64, 64))
    genesis, path, permute = _host_wave_kernels(wave_lib)
    plain = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2)
    tabs, n_pad, kb = plain.tabs, plain.n_pad, plain.key_bounds
    s_h = genesis(tabs, plain.pxf, plain.pyf, plain.n_real, 21, 1, 0)
    s_p, _ = plain.init_state(21, 2)
    assert torch.equal(s_h[WV.WROW_ALIVE:], s_p[WV.WROW_ALIVE:])
    torch.testing.assert_close(s_h, s_p, rtol=0, atol=1e-6)
    perm = torch.from_numpy(
        np.random.default_rng(1).permutation(n_pad // WV.W_SLICE)
        .astype(np.int32))
    assert torch.equal(permute(s_p, perm), WV.permute_ref(s_p, perm))
    o_h = path(tabs, s_p.clone(), 21, 1, 2, n_pad, kb)
    o_p = WV.wave_step_ref(tabs, s_p.clone(), 21, 1, 2, n_pad, kb)
    ok = ((o_h - o_p).abs() <= checks.RAD_ATOL
          + checks.RAD_RTOL * o_p.abs()).all(0)
    ok &= o_h[WV.WROW_KEY].view(torch.int32) == o_p[WV.WROW_KEY].view(
        torch.int32)
    assert ok.double().mean() >= 0.995, ok.double().mean()

    ref = plain(21, 2)
    for mode in ("gather", "dma"):
        monkeypatch.setattr(kernels, "wave_genesis", genesis)
        monkeypatch.setattr(kernels, "wave_path", path)
        monkeypatch.setattr(kernels, "wave_permute", permute)
        out = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2,
                              sort_mode=mode)(21, 2)
        monkeypatch.undo()
        film = [np.concatenate([np.asarray(o[k]).T for k in
                                ("radiance", "normal", "albedo")])
                for o in (out, ref)]
        a = checks.agreement(*film)
        assert a["rad_frac"] >= 0.995, (mode, a)
        assert a["aov_frac"] >= 0.995, (mode, a)
        assert a["mean_rel"] <= 1e-4, (mode, a)
        assert out["rays"] == ref["rays"], mode


def test_launch_args_check_tables():
    bn, cfg = _buffers("cornell_box")
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    out = torch.empty((P.OUT_ROWS, 128 * 64), dtype=torch.float32)
    bad = dict(tabs, tris=tabs["tris"][:, :-1].contiguous())
    with pytest.raises(ValueError, match="tris: shape"):
        kernels.launch_args(bad, 0, 1, False, out)
    bad = dict(tabs, tris=tabs["tris"].t().contiguous().t())
    with pytest.raises(ValueError, match="tris: not contiguous"):
        kernels.launch_args(bad, 0, 1, False, out)
    bad = dict(tabs, emit_tris=tabs["emit_tris"].long())
    with pytest.raises(ValueError, match="emit_tris: dtype"):
        kernels.launch_args(bad, 0, 1, False, out)
    with pytest.raises(ValueError, match="out: shape"):
        kernels.launch_args(tabs, 0, 1, False, out[:, :10].contiguous())
    # CPU tables run the plain version and count no launch
    before = dict(kernels.launches)
    torch.testing.assert_close(kernels.mega_path(tabs, 3, 1),
                               M.path_lanes_ref(tabs, 3, 1), rtol=0, atol=0)
    assert kernels.launches == before
    meta = dict(tabs, tris=tabs["tris"].to("meta"))
    with pytest.raises(ValueError, match="needs CUDA or CPU tensors"):
        kernels.mega_path(meta, 0, 1)
