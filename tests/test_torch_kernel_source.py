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

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.scene.device import build_device_scene
from rene_tpu_torch import checks, kernels, scenes
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
static inline uint32_t __float_as_uint(float f) {
  uint32_t u; memcpy(&u, &f, 4); return u;
}
#include "mega_lane.cuh"
// the lanes run one after another, the path body or, where the includer
// defines LANE_VOL true, the volpath body; the Sobol instance where the
// parameters ask for it
#ifndef LANE_VOL
#define LANE_VOL false
#endif
template <bool SOBOL>
static void run_all(const Params& p) {
  for (int lane = 0; lane < p.n_lanes; ++lane) {
    if (p.has_accel) trace_lane<true, LANE_VOL, SOBOL>(p, lane);
    else trace_lane<false, LANE_VOL, SOBOL>(p, lane);
  }
}
static int run_lanes(const Params& p, void*) {
  if (p.sobol) run_all<true>(p);
  else run_all<false>(p);
  return 0;
}
#include "launch.cuh"
// lane_start of n lane ids: (pixel, stream state, Sobol key) each
extern "C" void lane_start_all(const int* lanes, int n, int n_pix,
                               int width, int blocks, int bs, int seed,
                               uint32_t* out) {
  for (int i = 0; i < n; ++i) {
    const LaneStart s = lane_start((uint32_t)lanes[i], (uint32_t)n_pix,
                                   (uint32_t)width, blocks != 0,
                                   (uint32_t)bs, (uint32_t)seed);
    out[3 * i] = s.pix;
    out[3 * i + 1] = s.st;
    out[3 * i + 2] = s.key;
  }
}
"""


def _gxx(tmp_path_factory, name, harness) -> ctypes.CDLL:
    """`harness` compiled with g++ against csrc/ into a shared library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel's per-lane code for the CPU")
    d = tmp_path_factory.mktemp(name)
    (d / "harness.cpp").write_text(harness)
    so = d / "libhost.so"
    res = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
         "-Wno-unknown-pragmas", "-Werror", f"-I{kernels.CSRC}", "-o",
         str(so), str(d / "harness.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = _gxx(tmp_path_factory, "host_kernel", HARNESS)
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



# -- the volpath body (K1e) ----------------------------------------------------
MED_HARNESS = r"""
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
// the textures' entry points, which only a bounce calls
#pragma GCC diagnostic ignored "-Wunused-function"
#include "medium.cuh"
// lane by lane: out rows sampled, t, weight rgb, transmittance rgb along
// t_max, the phase value at cos, the scattered direction
extern "C" void med_lanes(const float* tab, int n_med, const float* med,
                          const float* t_max, const float* u, const float* wo,
                          const float* cos, int n, float* out) {
  const Media md = {tab, n_med};
  for (int i = 0; i < n; ++i) {
    const Med m = med_consts(md, med[i]);
    const MedSample s = med_sample(m, t_max[i], u[i], u[n + i]);
    const V3 tr = med_tr(m, t_max[i]);
    const V3 d = med_sample_p(m, v3(wo[i], wo[n + i], wo[2 * n + i]),
                              u[2 * n + i], u[3 * n + i]);
    const float row[12] = {s.sampled ? 1.f : 0.f, s.t, s.w[0], s.w[1],
                           s.w[2], tr.x, tr.y, tr.z, med_phase(m, cos[i]),
                           d.x, d.y, d.z};
    for (int r = 0; r < 12; ++r) out[r * n + i] = row[r];
  }
}
"""

VOL_HARNESS = "#define LANE_VOL true\n" + HARNESS


def _fog_buffers(name, directory, w, h):
    from .test_torch_volpath import buffers as vol_buffers
    if name == "fog_mesh":
        # the small mesh scene, its paths cut to maxdepth 8
        src = scenes.fog_mesh_scene(w, h, maxdepth=8, small=True)
        return build_device_scene(create_scene(parse_pbrt(src),
                                               str(directory)))
    return vol_buffers(name, directory, w, h)


def test_cuda_medium_code_matches_plain_version(tmp_path_factory):
    """csrc/medium.cuh with g++ against ops/medium.py on the same draws:
    the media of tests/test_torch_medium.py, lanes in every medium and
    an index the table does not hold (vacuum), segments from 1e-3 to 50
    and unbounded. The branch (sampled or not) agrees on >= 99.9% of the
    lanes, and there the values within 1e-5 relative (libm against
    torch); the scattered direction within 1e-4 everywhere."""
    from rene_tpu_torch.ops import medium as MD
    from rene_tpu_torch.ops import rng
    from .test_torch_medium import _media_buffers
    lib = _gxx(tmp_path_factory, "host_medium", MED_HARNESS)
    tab = torch.from_numpy(np.float32(P.media_table(_media_buffers())))
    n = 4096
    r = np.random.default_rng(12)
    med = torch.from_numpy(r.integers(0, tab.shape[0] + 1, n)).float()
    t_max = torch.from_numpy(np.float32(
        np.exp(r.uniform(np.log(1e-3), np.log(50.0), n))))
    t_max[:64] = 1e30
    wo = torch.from_numpy(np.float32(r.normal(size=(3, n))))
    wo = (wo / wo.norm(dim=0)).contiguous()
    cos = torch.from_numpy(np.float32(r.uniform(-1.0, 1.0, n)))
    st0 = torch.from_numpy(r.integers(1, 2 ** 32, n, dtype=np.uint64)
                           .astype(np.int64))
    u, st = [], st0
    for _ in range(4):
        ui, st = rng.uniform(st)
        u.append(ui)
    u = torch.stack(u).contiguous()
    out = torch.empty((12, n))
    f = ctypes.c_void_p
    lib.med_lanes.argtypes = [f, ctypes.c_int, f, f, f, f, f, ctypes.c_int, f]
    lib.med_lanes(tab.data_ptr(), tab.shape[0], med.data_ptr(),
                  t_max.data_ptr(), u.data_ptr(), wo.data_ptr(),
                  cos.data_ptr(), n, out.data_ptr())
    sampled, t, w, st1 = MD.med_sample(tab, med, t_max, st0)
    d = MD.med_sample_p(tab, med, *wo, st1)[:3]
    ref = torch.stack([sampled.float(), t, *w, *MD.med_tr(tab, med, t_max),
                       MD.med_phase(tab, med, cos), *d])
    ok = out[0] == ref[0]
    assert ok.double().mean() >= 0.999
    torch.testing.assert_close(out[1:9, ok], ref[1:9, ok], rtol=1e-5,
                               atol=1e-30)
    torch.testing.assert_close(out[9:], ref[9:], rtol=0, atol=1e-4)
    assert (out[0] > 0).double().mean() > 0.1
    assert (out[8] == 0).double().mean() > 0.1   # vacuum lanes


@pytest.fixture(scope="module")
def vol_lib(tmp_path_factory):
    lib = _gxx(tmp_path_factory, "host_volpath", VOL_HARNESS)
    lib.mega_path_launch.argtypes = kernels.ARGTYPES
    lib.mega_path_launch.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("name", ["fog", "fog_env", "fog_mesh"])
def test_cuda_volpath_lane_code_matches_plain_version(vol_lib, tmp_path,
                                                      name):
    """csrc/mega_lane.cuh's trace_lane<MESH, true> (csrc/volpath.cuh:
    media, Henyey-Greenstein NEE, the transmittance march through None
    faces, the interface switch, no Russian roulette) and
    csrc/medium.cuh against vol_lanes_ref at
    64x32 x 4 spp: immediates, env-map light sampling with an emitter, and
    the small fog mesh at maxdepth 8."""
    from rene_tpu_torch.integrators import volpath as V
    bn, cfg = _fog_buffers(name, tmp_path, 64, 32)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    assert tabs["volpath"] and tabs["has_accel"] == (name == "fog_mesh")
    seed, spp = 99, 4
    out = torch.empty((P.OUT_ROWS, 64 * 32), dtype=torch.float32)
    args = kernels.launch_args(tabs, seed, spp, False, out)
    assert vol_lib.mega_path_launch(*args, None) == 0
    ref = V.vol_lanes_ref(tabs, seed, spp).numpy()
    out = out.numpy()
    a = checks.agreement(out, ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.995, a
    assert a["mean_rel"] <= 1e-4, a
    assert out[9].sum() == ref[9].sum()

# the lane loop at full depth: (scene, maxdepth, sampler, pack); the small
# fog mesh at its own maxdepth 64, the nested boundaries at 16, 1 and 2
# (each depth with both samplers and both packs)
FULL_DEPTH = [("fog_mesh", 64, s, k) for s in ("independent", "sobol")
              for k in (1, 4)] + [
    ("nested", 16, "independent", 4), ("nested", 16, "sobol", 1),
    ("nested", 1, "independent", 1), ("nested", 1, "sobol", 4),
    ("nested", 2, "independent", 4), ("nested", 2, "sobol", 1)]


@pytest.mark.parametrize("name,depth,sampler,pack", FULL_DEPTH)
def test_cuda_volpath_lane_loop_matches_plain_version_at_full_depth(
        vol_lib, tmp_path, name, depth, sampler, pack):
    """trace_lane<MESH, true, SOBOL>, the volpath lane loop's one-cast
    state machine, against vol_lanes_ref at 16x8 x 2 spp (at pack 4, four
    slots of 1 sample): the small fog
    mesh at its full maxdepth 64, and scenes.nested_fog_scene (three
    nested None boundaries between four media, two distant lights and an
    emitter, so a march passes three surfaces and a scatter point queues
    three marches, the emitter's last) at maxdepth 16, 1 and 2, where the
    last bounce's marches must still count. By the per-pixel rule of the
    lanes above, ray totals within 0.1%."""
    from rene_tpu_torch.integrators import volpath as V
    from rene_tpu_torch.ops import intersect as X
    w, h, spp = 16, 8, (2 if pack == 1 else 1)
    src = (scenes.fog_mesh_scene(w, h, maxdepth=depth, small=True)
           if name == "fog_mesh" else scenes.nested_fog_scene(w, h, depth))
    if sampler == "sobol":
        src = scenes.with_sampler(src)
    bn, cfg = build_device_scene(create_scene(parse_pbrt(src), str(tmp_path)))
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    assert tabs["volpath"] and tabs["block_seed"]
    assert tabs["max_depth"] == depth and tabs["sobol"] == (sampler == "sobol")
    if name == "nested":
        # from the centre, a march toward either light passes the three
        # boundaries and misses: four casts per lane
        assert tabs["lights"].shape[0] == 2 and tabs["n_emit"] > 0
        for k in X.casts:
            X.casts[k] = 0
        o = torch.tensor([0.0, 0.0, 1.8])
        for ldx, ldy, ldz, *_ in tabs["lights_f"]:
            tr = X.tr_march(tabs, *o[:, None], *torch.tensor(
                [[ldx], [ldy], [ldz]]), torch.tensor([3.0]), False)
            assert 0.0 < float(tr[0][0]) < 1.0
        assert X.casts["march"] == 8, X.casts
    out = torch.empty((P.OUT_ROWS, w * h * pack), dtype=torch.float32)
    assert vol_lib.mega_path_launch(*kernels.launch_args(
        tabs, 99, spp, False, out, pack), None) == 0
    ref = V.vol_lanes_ref(tabs, 99, spp, pack=pack).numpy()
    out = out.numpy()
    a = checks.agreement(out, ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.995, a
    assert a["mean_rel"] <= 1e-4, a
    assert abs(out[9].sum() - ref[9].sum()) <= 1e-3 * ref[9].sum()


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
static inline uint32_t __float_as_uint(float f) {
  uint32_t u; memcpy(&u, &f, 4); return u;
}
#include "wave.cuh"
// the lanes, and the slices, run one after another, K2's lanes in the
// order that wave_lane_order set (0 .. n_run - 1 where it set none): the
// path bounce, or the volpath lane loop where the includer defines
// WAVE_VOL true; the Sobol instances where the parameters ask for them
#ifndef WAVE_VOL
#define WAVE_VOL false
#endif
static const int* lane_order = nullptr;
extern "C" void wave_lane_order(const int* order) { lane_order = order; }
template <bool SOBOL>
static void run_all(const WaveParams& p) {
  for (int i = 0; i < p.n_run; ++i) {
    const int lane = lane_order ? lane_order[i] : i;
    if (WAVE_VOL) {
      if (p.has_accel) wave_vol_lane<true, SOBOL>(p, lane);
      else wave_vol_lane<false, SOBOL>(p, lane);
    } else {
      if (p.has_accel) wave_lane<true, SOBOL>(p, lane);
      else wave_lane<false, SOBOL>(p, lane);
    }
  }
}
static int run_wave(const WaveParams& p, void*) {
  if (p.sobol) run_all<true>(p);
  else run_all<false>(p);
  return 0;
}
static int run_genesis(const GenesisParams& g, void*) {
  for (int lane = 0; lane < g.n_pad; ++lane) {
    if (g.sobol) genesis_lane<true>(g, lane);
    else genesis_lane<false>(g, lane);
  }
  return 0;
}
static int run_probe(const int* in, int n, int* out, void*) {
  for (int i = 0; i < n; ++i) probe_lane(in, n, i, out);
  return 0;
}
static int run_permute(const float* in, const int* perm, int n_pad,
                       float* out, void*) {
  for (int j = 0; j < n_pad / W_SLICE; ++j)
    for (int t = 0; t < 32; ++t)
      permute_slice(in, perm[j], (size_t)n_pad, j, t, 0, W_NROWS, out);
  return 0;
}
#include "wave_launch.cuh"
"""


@pytest.fixture(scope="module")
def wave_lib(tmp_path_factory):
    """csrc/wave.cuh's per-lane code behind csrc/wave_launch.cuh's entry
    points, compiled with g++."""
    return kernels.bind(_gxx(tmp_path_factory, "host_wave", WAVE_HARNESS),
                        "wave.cu")


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
            pxf.shape[0], seed, base, rem, int(tabs["sobol"]),
            state.data_ptr(), None) == 0
        return state

    def path(tabs, state, seed, launch, k, n_run, kb, base, rem,
             beckmann=False, stream="mixed"):
        assert stream == "mixed"
        assert lib.wave_path_launch(
            *kernels.scene_args(tabs, beckmann, state.device), seed, launch,
            k, n_run, state.shape[1], base, rem, *kb, state.data_ptr(),
            None) == 0
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
    s_p = plain.init_state(21, 2)
    assert torch.equal(s_h[WV.WROW_ALIVE:], s_p[WV.WROW_ALIVE:])
    torch.testing.assert_close(s_h, s_p, rtol=0, atol=1e-6)
    perm = torch.from_numpy(
        np.random.default_rng(1).permutation(n_pad // WV.W_SLICE)
        .astype(np.int32))
    assert torch.equal(permute(s_p, perm), WV.permute_ref(s_p, perm))
    o_h = path(tabs, s_p.clone(), 21, 1, 2, n_pad, kb, 1, 0)
    o_p = WV.wave_step_ref(tabs, s_p.clone(), 21, 1, 2, n_pad, kb, 1, 0)
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



@pytest.fixture(scope="module")
def wave_vol_lib(tmp_path_factory):
    """The wave kernels with the volpath bounce (wave_lane<MESH, true>),
    compiled with g++."""
    return kernels.bind(_gxx(tmp_path_factory, "host_wave_vol",
                             "#define WAVE_VOL true\n" + WAVE_HARNESS),
                        "wave.cu")


@pytest.mark.parametrize("name", ["fog", "fog_env", "fog_mesh"])
def test_cuda_volpath_wave_code_matches_plain_version(wave_vol_lib,
                                                      monkeypatch, name,
                                                      tmp_path):
    """K2's volpath bounce (csrc/wave.cuh wave_bounce<MESH, true>) against
    wave_step_ref on volpath tables: K3 leaves the medium row at vacuum;
    one K2 launch lane by lane (>= 99.5% of lanes on every row, the
    medium row among them, the key row bit for bit); whole 32x32 waves at
    spw 2 sorted by `gather` and by `dma` through the g++ kernels against
    the plain runner (the per-pixel rule, equal ray totals)."""
    from rene_tpu_torch.integrators import wave as WV
    bn, cfg = _fog_buffers(name, tmp_path, 32, 32)
    genesis, path, permute = _host_wave_kernels(wave_vol_lib)
    plain = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2)
    tabs, n_pad, kb = plain.tabs, plain.n_pad, plain.key_bounds
    assert tabs["volpath"]
    s_h = genesis(tabs, plain.pxf, plain.pyf, plain.n_real, 21, 1, 0)
    s_p = plain.init_state(21, 2)
    assert torch.equal(s_h[WV.WROW_ALIVE:], s_p[WV.WROW_ALIVE:])
    assert not s_h[WV.WROW_MED].any()
    o_h = path(tabs, s_p.clone(), 21, 1, 2, n_pad, kb, 1, 0)
    o_p = WV.wave_step_ref(tabs, s_p.clone(), 21, 1, 2, n_pad, kb, 1, 0)
    assert o_p[WV.WROW_MED].any()
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
        a = checks.agreement(*[np.concatenate(
            [np.asarray(o[k]).T for k in ("radiance", "normal", "albedo")])
            for o in (out, ref)])
        assert a["rad_frac"] >= 0.995, (mode, a)
        assert a["aov_frac"] >= 0.995, (mode, a)
        assert a["mean_rel"] <= 1e-4, (mode, a)
        assert out["rays"] == ref["rays"], mode

# K2's volpath lane loop at depth: (scene, maxdepth, sampler, k); the small
# fog mesh at its own maxdepth 64 and the nested boundaries at 16, one
# launch of k bounces from a fresh wave of two samples per lane (spw 2,
# base 2), so that lanes end paths, regenerate and park inside it
K2_LOOP = [(name, depth, s, k) for name, depth in (("fog_mesh", 64),
                                                   ("nested", 16))
           for s in ("independent", "sobol") for k in (1, 2, 4, 16)]


def _k2_loop_wave(name, depth, sampler, directory):
    """The plain runner of a 16x8 volpath wave at spw 2 of `name`."""
    from rene_tpu_torch.integrators import wave as WV
    src = (scenes.fog_mesh_scene(16, 8, maxdepth=depth, small=True)
           if name == "fog_mesh" else scenes.nested_fog_scene(16, 8, depth))
    if sampler == "sobol":
        src = scenes.with_sampler(src)
    bn, cfg = build_device_scene(create_scene(parse_pbrt(src),
                                             str(directory)))
    plain = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2)
    assert plain.tabs["volpath"] and plain.tabs["max_depth"] == depth
    assert plain.tabs["sobol"] == (sampler == "sobol")
    return plain


@pytest.mark.parametrize("name,depth,sampler,k", K2_LOOP)
def test_cuda_volpath_wave_lane_loop_matches_plain_version(
        wave_vol_lib, tmp_path, name, depth, sampler, k):
    """K2's volpath lanes (csrc/wave.cuh wave_vol_lane: vol_loop.cuh's
    one-cast state machine for k bounces, then wave_tail's depth cut,
    key, regeneration or parking) with g++ against wave_step_ref: one
    launch of k = 1, 2, 4 and 16 bounces over a fresh 16x8 wave of 4
    samples per pixel at spw 2 (two paths per lane), the small fog mesh
    at maxdepth 64 and scenes.nested_fog_scene at 16, both samplers.
    Every state row by the per-pixel rule, the key and medium rows bit
    for bit, on >= 99.5% of the lanes; the launch moves the medium row,
    regenerates lanes (k >= 4) and parks some (k = 16)."""
    from rene_tpu_torch.integrators import wave as WV
    plain = _k2_loop_wave(name, depth, sampler, tmp_path)
    _, path, _ = _host_wave_kernels(wave_vol_lib)
    s0 = plain.init_state(21, 4)
    kb, n_pad = plain.key_bounds, plain.n_pad
    o_h = path(plain.tabs, s0.clone(), 21, 1, k, n_pad, kb, 2, 0)
    o_p = WV.wave_step_ref(plain.tabs, s0.clone(), 21, 1, k, n_pad, kb, 2,
                           0)
    ok = ((o_h - o_p).abs() <= checks.RAD_ATOL
          + checks.RAD_RTOL * o_p.abs()).all(0)
    for row in (WV.WROW_KEY, WV.WROW_MED):
        ok &= o_h[row].view(torch.int32) == o_p[row].view(torch.int32)
    assert ok.double().mean() >= 0.995, ok.double().mean()
    assert (o_p[WV.WROW_MED] != s0[WV.WROW_MED]).any()
    if k >= 4:
        assert (o_p[WV.WROW_SMP] > 0).any()   # regenerated
    if k == 16:
        alive = s0[WV.WROW_ALIVE] > 0.5
        assert (alive & (o_p[WV.WROW_ALIVE] < 0.5)).any()   # parked


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
@pytest.mark.parametrize("sampler", ["independent", "sobol"])
def test_volpath_wave_lanes_in_any_order_are_bit_for_bit_the_same(
        wave_vol_lib, tmp_path, order, sampler):
    """A K2 launch's lanes run in reversed or shuffled order leave every
    lane's rows bit for bit as in lane order: a lane's result depends on
    its rows, its id, the wave seed and the launch index alone, so any
    thread may run any lane, in any order. The small fog mesh at
    maxdepth 64, a k = 4 launch after one launch and a sort, with parked
    lanes in its range."""
    from rene_tpu_torch.integrators import wave as WV
    plain = _k2_loop_wave("fog_mesh", 64, sampler, tmp_path)
    _, path, _ = _host_wave_kernels(wave_vol_lib)
    kb, n_pad = plain.key_bounds, plain.n_pad
    s0 = path(plain.tabs, plain.init_state(21, 2), 21, 0, 2, n_pad, kb, 1, 0)
    s0 = plain.sort_prefix(s0, n_pad)
    assert (s0[WV.WROW_ALIVE] < 0.5).any() and (s0[WV.WROW_ALIVE] > 0.5).any()
    lanes = torch.arange(n_pad, dtype=torch.int32)
    perm = (lanes.flip(0) if order == "reversed" else lanes[torch.from_numpy(
        np.random.default_rng(5).permutation(n_pad))]).contiguous()
    ref = path(plain.tabs, s0.clone(), 21, 1, 4, n_pad, kb, 1, 0)
    wave_vol_lib.wave_lane_order(ctypes.c_void_p(perm.data_ptr()))
    try:
        out = path(plain.tabs, s0.clone(), 21, 1, 4, n_pad, kb, 1, 0)
    finally:
        wave_vol_lib.wave_lane_order(None)
    assert not torch.equal(ref, s0)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


# -- the Sobol instances (K-sobol) --------------------------------------------
def _sobol_buffers(name, directory, w, h):
    """`Sampler "sobol"` forms of the inline scenes: the eight materials,
    the mesh materials (the BVH walk, 32x32-block seeds), the env map
    with an emitter (the upick pair), the fog scene and the small fog
    mesh at maxdepth 8 (volpath)."""
    src = {"materials": lambda: scenes.materials_scene(w, h),
           "mesh_materials": lambda: scenes.mesh_materials_scene(w, h, 8, 6),
           "env_emitter": lambda: scenes.textured("env_emitter", directory,
                                                  w, h),
           "fog": lambda: scenes.fog_scene(w, h),
           "fog_mesh": lambda: scenes.fog_mesh_scene(w, h, maxdepth=8,
                                                     small=True)}[name]()
    return build_device_scene(create_scene(
        parse_pbrt(scenes.with_sampler(src)), str(directory)))


@pytest.mark.parametrize("name", ["materials", "mesh_materials",
                                  "env_emitter", "fog", "fog_mesh"])
def test_cuda_sobol_lane_code_matches_plain_version(host_lib, vol_lib,
                                                    tmp_path, name):
    """trace_lane<MESH, VOL, true> (the Sobol pairs of csrc/sobol.cuh, the
    camera pair after the finished path is counted, the volpath bounce's
    stream draws) against path_lanes_ref on Sobol tables at 64x32 x 4
    spp, by the rule of the independent instances; the independent
    instance of the same tables traces other paths."""
    bn, cfg = _sobol_buffers(name, tmp_path, 64, 32)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    assert tabs["sobol"] and tabs["volpath"] == name.startswith("fog")
    lib = vol_lib if tabs["volpath"] else host_lib
    seed, spp = 99, 4
    out = torch.empty((P.OUT_ROWS, 64 * 32), dtype=torch.float32)
    assert lib.mega_path_launch(*kernels.launch_args(tabs, seed, spp, False,
                                                     out), None) == 0
    ref = M.path_lanes_ref(tabs, seed, spp).numpy()
    out = out.numpy()
    a = checks.agreement(out, ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.995, a
    assert a["mean_rel"] <= 1e-4, a
    assert out[9].sum() == ref[9].sum()
    ind = torch.empty((P.OUT_ROWS, 64 * 32), dtype=torch.float32)
    assert lib.mega_path_launch(*kernels.launch_args(
        dict(tabs, sobol=False), seed, spp, False, ind), None) == 0
    assert checks.agreement(ind.numpy(), ref)["rad_frac"] < 0.9


@pytest.mark.parametrize("name", ["materials", "mesh_materials", "fog"])
def test_cuda_sobol_wave_code_matches_plain_version(wave_lib, wave_vol_lib,
                                                    monkeypatch, tmp_path,
                                                    name):
    """The Sobol instances of K3 and K2 (csrc/wave.cuh) against the plain
    versions: K3 of a partial wave (3 samples of spw 4: base 0, rem 3) on
    the lane rows bit for bit and the camera rays within 1e-6; one K2
    launch of it lane by lane (>= 99.5% of lanes on every row, the key
    row bit for bit); then whole 32x32 waves at spw 2 sorted by `gather`
    and by `dma` through the g++ kernels against the plain runner."""
    from rene_tpu_torch.integrators import wave as WV
    bn, cfg = _sobol_buffers(name, tmp_path, 32, 32)
    lib = wave_vol_lib if name == "fog" else wave_lib
    genesis, path, permute = _host_wave_kernels(lib)
    plain = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=4)
    tabs, n_pad, kb = plain.tabs, plain.n_pad, plain.key_bounds
    assert tabs["sobol"]
    s_h = genesis(tabs, plain.pxf, plain.pyf, plain.n_real, 21, 0, 3)
    s_p = plain.init_state(21, 3)
    assert torch.equal(s_h[WV.WROW_ALIVE:], s_p[WV.WROW_ALIVE:])
    torch.testing.assert_close(s_h, s_p, rtol=0, atol=1e-6)
    o_h = path(tabs, s_p.clone(), 21, 1, 2, n_pad, kb, 0, 3)
    o_p = WV.wave_step_ref(tabs, s_p.clone(), 21, 1, 2, n_pad, kb, 0, 3)
    ok = ((o_h - o_p).abs() <= checks.RAD_ATOL
          + checks.RAD_RTOL * o_p.abs()).all(0)
    ok &= o_h[WV.WROW_KEY].view(torch.int32) == o_p[WV.WROW_KEY].view(
        torch.int32)
    assert ok.double().mean() >= 0.995, ok.double().mean()

    ref = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2)(21, 2)
    for mode in ("gather", "dma"):
        monkeypatch.setattr(kernels, "wave_genesis", genesis)
        monkeypatch.setattr(kernels, "wave_path", path)
        monkeypatch.setattr(kernels, "wave_permute", permute)
        out = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2,
                              sort_mode=mode)(21, 2)
        monkeypatch.undo()
        a = checks.agreement(*[np.concatenate(
            [np.asarray(o[k]).T for k in ("radiance", "normal", "albedo")])
            for o in (out, ref)])
        assert a["rad_frac"] >= 0.995, (mode, a)
        assert a["aov_frac"] >= 0.995, (mode, a)
        assert a["mean_rel"] <= 1e-4, (mode, a)
        assert out["rays"] == ref["rays"], mode


@pytest.mark.parametrize("sobol", [False, True], ids=["independent",
                                                      "sobol"])
def test_cuda_k2_lanes_past_2_24_match_plain_version(wave_lib, sobol):
    """K2 (csrc/wave.cuh, g++) on lanes 2^24 .. 2^24 + 2048 of a wave of
    the 32x32 materials scene: the lane row's exact ids seed the streams
    and, under Sobol, the sample indices (slot q = 16384); one launch of
    two bounces lane by lane against wave_step_ref (>= 99.5% of lanes on
    every row), and no two lanes trace the same path."""
    from rene_tpu_torch.integrators import wave as WV
    bn, cfg = _sobol_buffers("materials", "/tmp", 32, 32)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    tabs["sobol"] = sobol
    _, path, _ = _host_wave_kernels(wave_lib)
    npix = 32 * 32
    lanes = torch.arange(1 << 24, (1 << 24) + 2048)
    pix = lanes % npix
    pxf, pyf = (pix % 32).float(), (pix // 32).float()
    state = WV.genesis_ref(tabs["cam_f"], pxf, pyf, 32, npix,
                           (1 << 24) + 4096, 21, 1, 0, sobol=sobol,
                           lanes=lanes)
    assert torch.equal(WV.lane_ids(state), lanes)
    kb = WV.key_bounds(*WV.scene_bounds(bn, cfg))
    o_h = path(tabs, state.clone(), 21, 1, 2, 2048, kb, 1, 0)
    o_p = WV.wave_step_ref(tabs, state.clone(), 21, 1, 2, 2048, kb, 1, 0)
    ok = ((o_h - o_p).abs() <= checks.RAD_ATOL
          + checks.RAD_RTOL * o_p.abs()).all(0)
    assert ok.double().mean() >= 0.995, ok.double().mean()
    # the two lanes of each pixel (q 16384 and 16385) draw other paths
    d = o_p[WV.WROW_D:WV.WROW_D + 3]
    assert ((d[:, :1024] - d[:, 1024:]).abs().amax(0) > 0).double().mean() \
        > 0.9


def test_cuda_sobol_probe_matches_plain_version(wave_lib):
    """The Sobol probe (csrc/wave.cuh probe_lane) with g++ against
    ops/sobol.py `probe_ref`, bit for bit, on 2^16 int32 words."""
    from rene_tpu_torch.ops import sobol as SB
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -2 ** 31, 2 ** 31, 1 << 16, dtype=np.int64).astype(np.int32))
    out = torch.empty((7, x.numel()), dtype=torch.int32)
    assert wave_lib.sobol_probe_launch(x.data_ptr(), x.numel(),
                                       out.data_ptr(), None) == 0
    assert torch.equal(out, SB.probe_ref(x))


# -- sample-in-tile packing (K1f) ---------------------------------------------
@pytest.mark.parametrize("width,height", [(72, 40), (1280, 720)])
def test_cuda_lane_start_matches_plain_version(host_lib, width, height):
    """mega_lane.cuh `lane_start` (g++) against mega_path.lane_start bit
    for bit at every pack: the pixel and slot of a lane id, the block
    edge's grid step (partial edge blocks at 72x40), the stream seeded by
    the lane id and the slot-mixed Sobol key, on 4096 lane ids up to
    npix * 256 (past 2^24) and the last lane."""
    from rene_tpu_torch.ops import rng
    npix = width * height
    fn = host_lib.lane_start_all
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = None
    g = np.random.default_rng(width)
    for blocks in (True, False):
        for pack in rng.PACKS:
            n_lanes = npix * pack
            lanes = np.append(g.integers(0, n_lanes, 4096), n_lanes - 1)
            lanes = torch.from_numpy(lanes.astype(np.int32))
            seed = int(g.integers(0, 2 ** 31))
            out = torch.empty((lanes.numel(), 3), dtype=torch.int32)
            fn(lanes.data_ptr(), lanes.numel(), npix, width, int(blocks),
               rng.block_edge(pack), seed, out.data_ptr())
            tabs = {"width": width, "height": height, "block_seed": blocks}
            pix, _, st, key = M.lane_start(tabs, lanes, seed, pack)
            want = torch.stack([pix, st, key], 1)
            assert torch.equal(out.long() & rng.MASK, want), (blocks, pack)


@pytest.mark.parametrize("name,pack", [("mesh_materials", 4),
                                       ("instanced", 16), ("sobol", 4),
                                       ("fog_mesh", 4), ("sobol_fog_mesh", 4)])
def test_cuda_packed_lane_code_matches_plain_version(host_lib, vol_lib,
                                                     tmp_path, name, pack):
    """trace_lane over npix * pack lanes (g++), pixel lane % npix at slot
    lane / npix, against path_lanes_ref at the same pack, lane by lane,
    by the rule of the unpacked lanes; 32x32 x 2 spp (the small fog mesh
    at maxdepth 8, 1 spp)."""
    if name == "instanced":
        bn, cfg = mesh_buffers(name, 32, 32)
    else:
        bn, cfg = _sobol_buffers({"sobol": "mesh_materials",
                                  "sobol_fog_mesh": "fog_mesh"}.get(name, name),
                                 tmp_path, 32, 32)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    tabs["sobol"] = name.startswith("sobol")
    assert tabs["block_seed"]
    lib = vol_lib if tabs["volpath"] else host_lib
    seed, spp = 99, 1 if tabs["volpath"] else 2
    out = torch.empty((P.OUT_ROWS, 32 * 32 * pack), dtype=torch.float32)
    assert lib.mega_path_launch(*kernels.launch_args(
        tabs, seed, spp, False, out, pack), None) == 0
    ref = M.path_lanes_ref(tabs, seed, spp, pack=pack).numpy()
    out = out.numpy()
    a = checks.agreement(out, ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.995, a
    assert a["mean_rel"] <= 1e-4, a
    assert out[9].sum() == ref[9].sum()
    # the slots of a pixel trace other paths
    rad = ref[0].reshape(pack, -1)
    assert (rad[0] != rad[1]).mean() > 0.5


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
