"""K2's path lane loop and K4's warp copy, checked on the CPU with g++.

The mesh variant of csrc/wave.cuh `wave_lane` runs csrc/path_loop.cuh's
step machine: one ray cast per step from one call site, the path ray or
the next queued shadow ray, for the launch's k bounces (the immediates
variant keeps the two-cast bounce). Compiled with g++ (no FMA
contraction), it must leave every state row of every lane bit for bit as
the two-cast bounce does (a closest cast, then a shadow cast per distant
light inside the bounce), transcribed below as TWO_CAST for both
variants: at k = 1, 2, 4 and 16, from a fresh wave and from a wave after
three launches and sorts, in lane order, reversed and shuffled. Against
the plain version (wave_step_ref) both meet the per-pixel rule of
rene_tpu_torch.checks and keep the key row bit for bit; the lanes they do
not meet bit for bit differ by libm against torch's vectorized sin, cos
and log. csrc/wave.cuh `permute_slice` (K4, 16-byte words, 8 slice-rows
of loads in flight per thread) must equal permute_ref bit for bit.
"""
import ctypes
import functools
import re

import numpy as np
import pytest
import torch

from rene_tpu_torch import checks, kernels, scenes
from rene_tpu_torch.integrators import wave as WV
from rene_tpu_torch.scene import build_device_scene, load_scene
from rene_tpu_torch.scene import pack as P
from .test_torch_kernel_source import WAVE_HARNESS, _gxx, _host_wave_kernels

torch.set_num_threads(2)

# the earlier K2 path bounce, two walk call sites per bounce: the reference
# the step machine must equal bit for bit
TWO_CAST = r"""
template <bool MESH, bool SOBOL>
static void bounce_two_cast(const WaveParams& p, WaveLane& L, WaveDraw& w) {
  const Scene& s = p.s;
  const bool beck = p.beckmann != 0;
  const int E = s.n_eo;
  L.rays = L.rays + (1.f + (float)s.n_lights + (E > 0 ? 1.f : 0.f));
  V3 hp = L.o, w_ = L.d;
  float nthr[3] = {L.c[0], L.c[1], L.c[2]};
  const SobolAt at = {w.scum + (uint32_t)L.smp, w.pixkey, (uint32_t)L.dep};
  const Draws u = draw_bounce_as<SOBOL>(s, p.use_rr != 0, w.st, at);
  Hit h = trace_closest<MESH>(s, L.o, L.d, TMIN);
  bool alive = h.t < BIG;
  if (!alive) {
    float bg[3];
    background(s.cam, s.atlas, bg_kind(s), L.d, bg);
    for (int c = 0; c < 3; ++c) L.r[c] = L.r[c] + L.c[c] * bg[c];
  } else {
    Mat m = hit_material(s, h);
    hp = v3(L.o.x + h.t * L.d.x, L.o.y + h.t * L.d.y, L.o.z + h.t * L.d.z);
    V3 n = normalize3(h.n);
    V3 wo = neg(L.d);
    Frame f = onb_from_w(n);
    if ((h.e[0] != 0.f || h.e[1] != 0.f || h.e[2] != 0.f)
        && dot3(wo, n) > 0.f)
      for (int c = 0; c < 3; ++c) L.r[c] = L.r[c] + L.c[c] * h.e[c];
    if (L.dep == 0.f) {
      L.an[0] = L.an[0] + n.x;
      L.an[1] = L.an[1] + n.y;
      L.an[2] = L.an[2] + n.z;
      for (int c = 0; c < 3; ++c) L.aa[c] = L.aa[c] + m.ab[c];
    }
    V3 lo = to_local(f, wo);
    for (int li = 0; li < s.n_lights; ++li) {
      const float* Lt = s.lights + li * LIGHT_W;
      V3 ld = load3(Lt + LIGHT_DIR);
      if (shadow_any<MESH>(s, li, hp, ld, TMIN, 1e5f)) continue;
      BsdfVal fe = bsdf_eval(m, lo, to_local(f, ld), beck);
      float cosl = fabsf(ld.x * n.x + ld.y * n.y + ld.z * n.z);
      for (int c = 0; c < 3; ++c)
        L.r[c] = L.r[c]
            + L.c[c] * fe.f[c] * cosl * __ldg(Lt + LIGHT_COLOR + c);
    }
    alive = bsdf_step(s, m, f, n, lo, hp, u, beck, L.c, w_, nthr);
    alive = alive
        && maxn(nthr[0], maxn(nthr[1], nthr[2])) >= FLT_MIN_NORMAL;
    if (p.use_rr) {
      float p_cont = clampn(maxn(nthr[0], maxn(nthr[1], nthr[2])), 0.f,
                            1.f);
      bool do_rr = L.dep > (float)RR_START;
      alive = alive && (!do_rr || u.rrv <= p_cont);
      if (do_rr && alive) {
        float inv_p = 1.f / clamp_min(p_cont, 1e-20f);
        for (int c = 0; c < 3; ++c) nthr[c] = nthr[c] * inv_p;
      }
    }
  }
  wave_tail<SOBOL>(p, L, alive, hp, w_, nthr, L.med, u.cj1, u.cj2, w);
}

template <bool MESH, bool SOBOL>
static void lane_two_cast(const WaveParams& p, int lane) {
  WaveLane L;
  if (!wave_load<false>(p, lane, L)) return;
  WaveDraw w = wave_draw<SOBOL>(p, L);
  for (int b = 0; b < p.k && L.alive > 0.5f; ++b)
    bounce_two_cast<MESH, SOBOL>(p, L, w);
  wave_store<false>(p, lane, L);
}
"""
REF_HARNESS = WAVE_HARNESS.replace(
    '#include "wave.cuh"\n', '#include "wave.cuh"\n' + TWO_CAST).replace(
    "if (p.has_accel) wave_lane<true, SOBOL>(p, lane);\n"
    "      else wave_lane<false, SOBOL>(p, lane);",
    "if (p.has_accel) lane_two_cast<true, SOBOL>(p, lane);\n"
    "      else lane_two_cast<false, SOBOL>(p, lane);")
assert REF_HARNESS.count("lane_two_cast<") == 2

# (name, scene text of a directory for its images): the mesh main path's
# scene at its deep maxdepth (vase, instances, sphere table, a distant
# light), every material with the immediates and emitters (the immediates
# variant), every material on meshes, the textured mesh, and 24 distant
# lights on the sphere table (past PATH_MAX_LIGHTS)
SCENES = {
    "big_mesh": lambda d: scenes.big_mesh_scene(32, 18, maxdepth=50),
    "materials": lambda d: scenes.materials_scene(32, 16),
    "mesh_materials": lambda d: scenes.mesh_materials_scene(24, 12, nu=8,
                                                            nv=6),
    "textured_mesh": lambda d: scenes.textured_mesh_scene(d, 24, 12),
    "many_lights": lambda d: scenes.sphere_light_scene(16, 8, n_spheres=70,
                                                       maxdepth=8),
}
SAMPLERS = ("independent", "sobol")
KS = (1, 2, 4, 16)
WANT = 4   # samples per pixel of a wave at spw 2: two paths per lane


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The g++ builds of the step machine and of the two-cast bounce."""
    return tuple(kernels.bind(_gxx(tmp_path_factory, name, harness),
                              "wave.cu")
                 for name, harness in (("host_path_lane", WAVE_HARNESS),
                                       ("host_two_cast", REF_HARNESS)))


@pytest.fixture(scope="module")
def waves(tmp_path_factory):
    """The plain runner of each scene and sampler's 2-spw wave, made once."""
    directory = tmp_path_factory.mktemp("path_lane_scenes")
    text = functools.lru_cache(maxsize=None)(
        lambda name: SCENES[name](str(directory)))   # images written once

    @functools.lru_cache(maxsize=None)
    def wave(name, sampler):
        src = text(name)
        if sampler == "sobol":
            src = scenes.with_sampler(src)
        path = directory / f"{name}_{sampler}.pbrt"
        path.write_text(src)
        bn, cfg = build_device_scene(load_scene(str(path)))
        run = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2)
        assert run.tabs["sobol"] == (sampler == "sobol")
        assert not run.tabs["volpath"]
        return run
    return wave


def _starts(run, path):
    """A fresh wave of WANT samples per pixel, and the same wave after
    three launches of k = 1 (the schedule's first) and their sorts."""
    kb, n_pad = run.key_bounds, run.n_pad
    fresh = run.init_state(21, WANT)
    s = fresh.clone()
    for launch in range(3):
        s = path(run.tabs, s, 21, launch, WV.SCHEDULE[launch], n_pad, kb, 2,
                 0)
        s = run.sort_prefix(s, n_pad)
    return {"fresh": fresh, "after three launches": s}


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_path_lane_loop_matches_two_cast_bounce_bit_for_bit(
        libs, waves, name, sampler):
    """The step machine (g++) leaves every row of every lane bit for bit
    as the two-cast bounce does, at k = 1, 2, 4 and 16 from a fresh wave
    and from one after three launches and sorts; launches of k >= 4
    regenerate lanes and k = 16 parks some."""
    run = waves(name, sampler)
    _, path, _ = _host_wave_kernels(libs[0])
    _, ref, _ = _host_wave_kernels(libs[1])
    kb, n_pad = run.key_bounds, run.n_pad
    for start, s0 in _starts(run, ref).items():
        for k in KS:
            out = path(run.tabs, s0.clone(), 21, 3, k, n_pad, kb, 2, 0)
            exp = ref(run.tabs, s0.clone(), 21, 3, k, n_pad, kb, 2, 0)
            same = (_bits(out) == _bits(exp)).all(0)
            assert bool(same.all()), (start, k, int((~same).sum()))
            assert not torch.equal(exp, s0), (start, k)
            if start == "fresh" and k >= 4:
                assert (exp[WV.WROW_SMP] > 0).any()   # regenerated
            if start == "fresh" and k == 16:
                alive = s0[WV.WROW_ALIVE] > 0.5
                assert (alive & (exp[WV.WROW_ALIVE] < 0.5)).any()   # parked


@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_path_lane_loop_meets_plain_version(libs, waves, name, sampler):
    """The step machine (g++) against wave_step_ref: a k = 16 launch from
    a fresh wave and a k = 4 launch after three launches and sorts; every
    state row by the per-pixel rule and the key row bit for bit, on >=
    99.5% of the lanes."""
    run = waves(name, sampler)
    _, path, _ = _host_wave_kernels(libs[0])
    kb, n_pad = run.key_bounds, run.n_pad
    starts = _starts(run, path)
    for start, k in (("fresh", 16), ("after three launches", 4)):
        s0 = starts[start]
        out = path(run.tabs, s0.clone(), 21, 3, k, n_pad, kb, 2, 0)
        exp = WV.wave_step_ref(run.tabs, s0.clone(), 21, 3, k, n_pad, kb, 2,
                               0)
        ok = ((out - exp).abs() <= checks.RAD_ATOL
              + checks.RAD_RTOL * exp.abs()).all(0)
        ok &= _bits(out[WV.WROW_KEY]) == _bits(exp[WV.WROW_KEY])
        assert ok.double().mean() >= 0.995, (start, k, ok.double().mean())


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
@pytest.mark.parametrize("name,sampler", [("big_mesh", "independent"),
                                          ("big_mesh", "sobol"),
                                          ("many_lights", "independent"),
                                          ("mesh_materials", "sobol")])
def test_path_lanes_in_any_order_are_bit_for_bit_the_same(
        libs, waves, name, sampler, order):
    """A K2 launch's lanes run in reversed or shuffled order leave every
    lane's rows bit for bit as in lane order: a lane's result depends on
    its rows, its id, the wave seed and the launch index alone, and
    nothing of one lane's loop leaks into the next. A k = 4 launch after
    three launches and sorts, with parked lanes in its range."""
    run = waves(name, sampler)
    lib = libs[0]
    _, path, _ = _host_wave_kernels(lib)
    kb, n_pad = run.key_bounds, run.n_pad
    s0 = _starts(run, path)["after three launches"]
    assert (s0[WV.WROW_ALIVE] < 0.5).any() and (s0[WV.WROW_ALIVE] > 0.5).any()
    lanes = torch.arange(n_pad, dtype=torch.int32)
    perm = (lanes.flip(0) if order == "reversed" else lanes[torch.from_numpy(
        np.random.default_rng(5).permutation(n_pad))]).contiguous()
    ref = path(run.tabs, s0.clone(), 21, 3, 4, n_pad, kb, 2, 0)
    lib.wave_lane_order(ctypes.c_void_p(perm.data_ptr()))
    try:
        out = path(run.tabs, s0.clone(), 21, 3, 4, n_pad, kb, 2, 0)
    finally:
        lib.wave_lane_order(None)
    assert not torch.equal(ref, s0)
    assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("slices", [1, 7])
@pytest.mark.parametrize("kind", ["identity", "reversed", "random"])
def test_permute_slice_matches_plain_version(libs, kind, slices):
    """K4's warp copy (csrc/wave.cuh permute_slice, g++) against
    permute_ref bit for bit: rows [0, W_SORT_PAD) from slice perm[j], the
    AOV rows in place, on states whose words are random bit patterns
    (NaNs among them)."""
    _, _, permute = _host_wave_kernels(libs[0])
    rng = np.random.default_rng(slices)
    n_pad = slices * WV.W_SLICE
    state = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, (WV.W_NROWS, n_pad), dtype=np.int64)
        .astype(np.int32)).view(torch.float32)
    perm = torch.arange(slices, dtype=torch.int32)
    if kind == "reversed":
        perm = perm.flip(0).contiguous()
    elif kind == "random":
        perm = torch.from_numpy(rng.permutation(slices).astype(np.int32))
    out = permute(state, perm)
    assert torch.equal(_bits(out), _bits(WV.permute_ref(state, perm)))
    if slices > 1 and kind != "identity":
        assert not torch.equal(_bits(out[:WV.W_SORT_PAD]),
                               _bits(state[:WV.W_SORT_PAD]))


def test_path_loop_constants_match_the_host():
    """path_loop.cuh's queue holds the immediates' light cap, and its
    counts are LOOP_KEYS, in their order."""
    src = (kernels.CSRC / "path_loop.cuh").read_text()
    assert int(re.search(r"#define PATH_MAX_LIGHTS (\d+)", src)
               .group(1)) == P.MAX_LIGHTS
    assert int(re.search(r"#define N_LOOP_COUNTS (\d+)", src)
               .group(1)) == len(kernels.LOOP_KEYS)
    assert kernels.PATH_WAVE_COUNT in kernels.BUILDS
    assert "-DMEGA_COUNT=1" in kernels.BUILDS[kernels.PATH_WAVE_COUNT]


@pytest.mark.cuda
def test_path_lane_and_permute_on_the_card_match_plain(tmp_path):
    """On the card: K2's path lanes (the mesh variant, the big mesh at
    64x32 and maxdepth 50, a fresh wave's k = 4 launch) by the card's
    per-pixel rule on the state rows and K4 bit for bit, each against its
    plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    path = tmp_path / "deep.pbrt"
    path.write_text(scenes.big_mesh_scene(64, 32, maxdepth=50))
    bn, cfg = build_device_scene(load_scene(str(path)))
    run = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=2)
    s0 = run.init_state(21, WANT)
    out = kernels.wave_path(run.tabs, s0.clone(), 21, 0, 4, run.n_pad,
                            run.key_bounds, 2, 0)
    exp = WV.wave_step_ref(run.tabs, s0.clone(), 21, 0, 4, run.n_pad,
                           run.key_bounds, 2, 0)
    ok = ((out - exp).abs() <= checks.RAD_ATOL
          + checks.RAD_RTOL * exp.abs()).all(0)
    assert ok.double().mean() >= checks.CARD_FRAC, ok.double().mean()
    perm = torch.randperm(run.n_pad // WV.W_SLICE, device=dev).to(
        torch.int32)
    assert torch.equal(kernels.wave_permute(out, perm),
                       WV.permute_ref(out, perm))
