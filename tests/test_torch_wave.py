"""The wavefront engine (slices K2, K3, K4) against the JAX wave engine.

The plain versions in rene_tpu_torch/integrators/wave.py (`genesis_ref`,
`wave_step_ref`, `permute_ref`) and the runner `make_wave_fn` against
rene_tpu's `make_pallas_wave_fn(..., interpret=True, init_mode="kernel")`
on the CPU. Each lane's stream is seeded from its lane id, the wave seed
and the launch index in both, so a lane traces the same path in both
engines wherever the sorts put it, and films compare per pixel. What
separates the two sides is float32 rounding (XLA contracts some
multiply-adds and has its own sin/cos/exp; the camera rays of a fresh
wave differ in the last ulp), and a rare lane that then crosses a branch
the other way and follows another path. Limits, all from
rene_tpu_torch.checks' per-pixel rule:

* K3: rows 12-19 (alive, rays, lane, px, py, smp, dep, want) bit-exact;
  ray rows within 1e-5 (measured 2.4e-7); the key row bit-exact except
  where a direction component rounds across 0 (measured: no lane);
  rows 21-31 zero.
* K2, one launch on the same input state: >= 99% of lanes agree on every
  row (measured 100% on the 24x16 scene, 99.78-99.90% on the materials
  at two seeds), the key row bit-exact on >= 99% (a hit point rounding
  across a Morton cell moves it; measured 100%).
* Whole waves: >= 99.5% of pixels' radiance and >= 99% of their normal
  and albedo sums agree, image means within 1e-3 relative, ray totals
  within 0.1%. The wave films hold no duplicate edge lanes, so rays
  compare on any film. Measured: radiance >= 99.90%, AOV >= 99.56%,
  means within 2.4e-6, ray totals within 0.011%.

A path whose throughput falls below float32's normal range ends in
both: XLA and the TPU flush such values to zero, so the port's wave
shared bounce (the megakernel's too) tests against the least normal
float; without that, the port traced ~0.06% more rays on the materials
scene.

The JAX side runs its default schedule (1, 1, 1, 2, 4) on the 24x16
scene and (1, 2) on the larger ones: every distinct k is one more
interpret-mode compile. jax and rene_tpu are imported inside the parity
tests, so the `cuda` tests collect where there is no jax.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rene_tpu_torch import checks, kernels, scenes
from rene_tpu_torch.integrators import wave as WV
from rene_tpu_torch.scene import build_device_scene, create_scene
from rene_tpu_torch.pbrt import parse_pbrt

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
# switches of the JAX kernels and wave runner, pinned to their defaults
JAX_ENV_OFF = ("RENE_MF_DIST", "RENE_MEGA_PACK", "RENE_MESH_TEST",
               "RENE_CONST_DIR", "RENE_SPH_ANY", "RENE_SUB_TRIS",
               "RENE_SUB_GATE", "RENE_CLUSTER_ORDER", "RENE_WAVE_GRAN",
               "RENE_WAVE_INIT", "RENE_WAVE_SORT", "RENE_WAVE_SUB_GATE",
               "RENE_WAVE_DMA_FULL", "RENE_WAVE_PROFILE")
INT_ROWS = slice(WV.WROW_ALIVE, WV.WROW_KEY)   # rows 12-19
FLOAT_ROWS = list(range(0, WV.WROW_ALIVE)) + list(range(WV.WROW_AN,
                                                        WV.WROW_AA + 3))


def _small_src():
    """tests/test_wave.py's 24x16 immediates scene (maxdepth 5)."""
    from .test_wave import SRC
    return SRC


SCENES = {
    "immediates": (_small_src, None),
    "odd": (lambda: _small_src().replace("[24]", "[23]")
            .replace("[16]", "[13]"), None),
    "materials": (lambda: scenes.materials_scene(64, 32), (1, 2)),
    "mesh": (lambda: scenes.mesh_materials_scene(64, 32, 8, 6), (1, 2)),
}


def _buffers(name):
    return build_device_scene(create_scene(parse_pbrt(SCENES[name][0]()),
                                           "/tmp"))


def _jax_env(mp):
    from rene_tpu.integrators import pallas_path as pp
    mp.setattr(pp, "CLUSTER", 16)
    mp.setattr(pp, "SPH_BLOCK", 16)
    mp.setenv("RENE_QUAD_FUSE", "0")
    for k in JAX_ENV_OFF:
        mp.delenv(k, raising=False)
    return pp


@pytest.fixture(scope="module")
def jax_wave():
    """jax_wave(name, spw) -> (buffers, config, the JAX runner), built
    once per scene and compiled at its first call."""
    runs = {}

    def get(name, spw=2):
        from rene_tpu.integrators.pallas_wave import make_pallas_wave_fn
        if (name, spw) not in runs:
            with pytest.MonkeyPatch.context() as mp:
                _jax_env(mp)
                bn, cfg = _buffers(name)
                runs[name, spw] = (bn, cfg, make_pallas_wave_fn(
                    bn, cfg, interpret=True, samples_per_wave=spw,
                    init_mode="kernel", sort_mode="gather", sort_gran=1,
                    k_schedule=SCENES[name][1]))
        return runs[name, spw]
    return get


def _port(bn, cfg, spw, **kw):
    return WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=spw, **kw)


def _film(out):
    return np.concatenate([np.asarray(out[k]).T
                           for k in ("radiance", "normal", "albedo")])


def _lane_row_as_jax(state):
    """A port state with its lane-id row as the JAX kernels hold it, float
    values (the port keeps the ids' int32 bits, exact past 2^24 lanes)."""
    out = np.array(state, copy=True)
    out[WV.WROW_LANE] = out[WV.WROW_LANE].view(np.int32).astype(np.float32)
    return out


def _lane_row_as_port(state):
    """A JAX wave state with its lane-id row as the port holds it."""
    out = np.array(state, copy=True)
    out[WV.WROW_LANE] = out[WV.WROW_LANE].astype(np.int32).view(np.float32)
    return out


def test_state_layout_matches_jax():
    """The state rows of wave.py and csrc/layout.cuh are JAX's
    (pallas_path.py:148-181), so state rows compare one to one."""
    from rene_tpu.integrators import pallas_path as pp
    names = [n for n in vars(WV) if n.startswith(("WROW_", "W_SORT",
                                                  "W_NROWS"))]
    assert {"WROW_O", "WROW_KEY", "W_SORT_ROWS", "W_SORT_PAD",
            "W_NROWS", "WROW_AA"} <= set(names)
    for n in names:
        assert getattr(WV, n) == getattr(pp, n), n
    assert WV.DEAD_ORIGIN == pp.DEAD_ORIGIN
    assert WV.W_TILE == pp.MESH_TILE_SUB * 128
    text = (REPO / "rene_tpu_torch" / "csrc" / "layout.cuh").read_text()
    defs = dict(re.findall(r"#define (W\w+) (\d+)\s*$", text, re.M))
    assert set(defs) >= set(names)
    for n, v in defs.items():
        assert int(v) == getattr(WV, n), n
    assert "#define DEAD_ORIGIN 1e30f" in text


def test_auto_spw_matches_jax():
    """The lane count per pixel at a given spp is the reference's on
    hardware (its TPU cap of 96 included)."""
    from rene_tpu.integrators.pallas_wave import auto_spw
    for npix in (24 * 16, 320 * 180, 1280 * 720, 1920 * 1080, 4096 * 4096):
        for hint in (0, 1, 2, 4, 16, 64, 4096):
            assert WV.auto_spw(npix, hint) == auto_spw(npix, spp_hint=hint)
    assert WV.auto_spw(1280 * 720, 16) == 16


@pytest.mark.parametrize("name,spw,want", [("immediates", 2, 2),
                                           ("immediates", 2, 1),
                                           ("odd", 3, 2)])
def test_genesis_matches_jax(jax_wave, monkeypatch, name, spw, want):
    """K3's plain version against JAX `init_state` (init_mode "kernel")
    on the same seed: the 24x16 film (one 1024-lane tile at spw 2, half
    its lanes wanting no sample at want 1) and a 23x13 film at spw 3
    (897 real lanes and 127 pad lanes)."""
    import jax.numpy as jnp
    bn, cfg, jrun = jax_wave(name, spw)
    _jax_env(monkeypatch)
    seed = 9
    ref = np.asarray(jrun.init_state(jnp.int32(seed), jnp.int32(want))[0])
    port = _port(bn, cfg, spw, stream="jax")
    assert port.n_pad == jrun.n_pad
    state = port.init_state(seed, want)
    assert WV.lane_ids(state).tolist() == list(range(port.n_pad))
    state = _lane_row_as_jax(state.numpy())
    assert state.shape == ref.shape == (WV.W_NROWS, port.n_pad)
    np.testing.assert_array_equal(state[INT_ROWS], ref[INT_ROWS])
    alive = ref[WV.WROW_ALIVE] > 0.5
    assert 0 < alive.sum() <= port.n_real
    np.testing.assert_allclose(state[:WV.WROW_ALIVE], ref[:WV.WROW_ALIVE],
                               rtol=0, atol=1e-5)
    key, key_ref = (state[WV.WROW_KEY].view(np.int32),
                    ref[WV.WROW_KEY].view(np.int32))
    d = ref[WV.WROW_D:WV.WROW_D + 3]
    near0 = (np.abs(d) < 1e-6).any(0)
    assert ((key != key_ref) & ~near0).sum() == 0
    assert (key_ref[~alive] == (WV.W_KEY_DEAD | WV.W_KEY_BIT)).all()
    assert not state[WV.W_SORT_ROWS:].any()


@pytest.mark.parametrize("name", ["immediates", "materials"])
def test_wave_step_matches_jax(jax_wave, monkeypatch, name):
    """One K2 launch of two bounces (launch 1 of the wave's streams)
    from the same genesis state, lane by lane: the 24x16 scene and the
    eight materials at 64x32."""
    import jax.numpy as jnp
    bn, cfg, jrun = jax_wave(name)
    _jax_env(monkeypatch)
    seed = 9
    state0 = np.asarray(jrun.init_state(jnp.int32(seed), jnp.int32(2))[0])
    ref, n_alive = jrun.kernel_step(2, jnp.asarray(state0), jnp.int32(seed),
                                    jnp.int32(1), jnp.int32(jrun.n_tiles),
                                    jnp.int32(2))
    ref = np.asarray(ref)
    port = _port(bn, cfg, 2)
    out = WV.wave_step_ref(port.tabs,
                           torch.from_numpy(_lane_row_as_port(state0)), seed,
                           1, 2, port.n_pad, port.key_bounds, 1, 0,
                           stream="jax")
    out = _lane_row_as_jax(out.numpy())
    d = np.abs(out[FLOAT_ROWS].astype(np.float64) - ref[FLOAT_ROWS])
    lane_ok = (d <= checks.RAD_ATOL + checks.RAD_RTOL
               * np.abs(ref[FLOAT_ROWS])).all(0)
    lane_ok &= (out[INT_ROWS] == ref[INT_ROWS]).all(0)
    assert lane_ok.mean() >= 0.99, lane_ok.mean()
    key_eq = out[WV.WROW_KEY].view(np.int32) == ref[WV.WROW_KEY].view(
        np.int32)
    assert key_eq.mean() >= 0.99, key_eq.mean()
    assert (out[WV.WROW_ALIVE] > 0.5).sum() == int(n_alive)
    # lanes dead before the launch keep their state
    dead = state0[WV.WROW_ALIVE] < 0.5
    np.testing.assert_array_equal(out[:, dead], state0[:, dead])


@pytest.mark.parametrize("name,seeds", [("immediates", (9, 10)),
                                        ("materials", (7, 1234567)),
                                        ("mesh", (7,))])
def test_wave_matches_jax(jax_wave, monkeypatch, name, seeds):
    """Whole waves, K3 then K2 steps with sorts, per pixel: the 24x16
    immediates scene (default schedule), the eight materials at 64x32
    (maxdepth 16, Russian roulette) and a 2,310-triangle mesh at 64x32
    (the BVH walk against JAX's cluster march)."""
    bn, cfg, jrun = jax_wave(name)
    _jax_env(monkeypatch)
    port = _port(bn, cfg, 2, k_schedule=SCENES[name][1], stream="jax")
    assert port.tabs["has_accel"] == (name == "mesh")
    for seed in seeds:
        ref = jrun(seed, 2)
        out = port(seed, 2)
        a = checks.agreement(_film(out), _film(ref))
        assert a["rad_frac"] >= 0.995, (seed, a)
        assert a["aov_frac"] >= 0.99, (seed, a)
        assert a["mean_rel"] <= 1e-3, (seed, a)
        assert abs(out["rays"] - ref["rays"]) <= 1e-3 * ref["rays"], \
            (seed, out["rays"], ref["rays"])


@pytest.mark.parametrize("seed", [11, 12])
def test_mixed_stream_matches_megakernel(seed):
    """The default lane streams ("mixed") trace as many rays per path as
    the megakernel on the Cornell box (32x32 x 96 spp, maxdepth 50 with
    Russian roulette from depth 12): within 1%, where one sample's paths
    read 5.0 rays. The "jax" streams read 4.51-5.23 over four seeds: a
    lane's draws in two launches differ by a bit mask the same for every
    lane, so the whole film errs together."""
    from rene_tpu_torch.integrators.mega_path import make_mega_batch_fn
    bn, cfg = build_device_scene(create_scene(parse_pbrt(
        scenes.cornell_box(32, 32)), "/tmp"))
    wave = _port(bn, cfg, 96)(seed, 96)
    mega = make_mega_batch_fn(bn, cfg, "cpu")(seed, 96)
    n = 32 * 32 * 96
    assert abs(wave["rays"] / float(mega["rays"]) - 1.0) <= 0.01, \
        (wave["rays"] / n, float(mega["rays"]) / n)


def test_sort_modes_agree():
    """Sorted (`gather`), unsorted and `dma` waves of the port trace the
    same lanes: their films agree to summation order, their ray totals
    exactly."""
    bn, cfg = _buffers("materials")
    outs = [_port(bn, cfg, 4, **kw)(5, 4) for kw in (
        {}, {"sort_rays": False}, {"sort_mode": "dma"})]
    for o in outs[1:]:
        np.testing.assert_allclose(_film(o), _film(outs[0]), rtol=1e-5,
                                   atol=1e-6)
        assert o["rays"] == outs[0]["rays"]
    assert outs[0]["rays"] > 0


def test_partial_wave_and_run_dev():
    """A wave of fewer samples than lanes per pixel (want 3 of spw 4:
    the slot-3 lanes draw nothing) and two waves summed on the device
    by `run_dev`, read back once."""
    bn, cfg = _buffers("immediates")
    port = _port(bn, cfg, 4)
    one = port(3, 3)
    assert np.isfinite(_film(one)).all()
    acc = port.run_dev(3, 3)
    acc = port.run_dev(4, 4, acc)
    two = port.read_back(acc)
    four = port(4, 4)
    np.testing.assert_allclose(_film(two), _film(one) + _film(four),
                               rtol=1e-6, atol=1e-6)
    assert two["rays"] == one["rays"] + four["rays"]
    # albedo sums count one first hit per sample at most
    assert (one["albedo"] <= 3 + 1e-5).all()


def test_gather_finish_order_is_exact_past_2_24_lanes():
    """The `gather` finish puts each column back at the lane id that the
    sorts carried with it in row WROW_LANE (`lane_ids`, `unsort_lanes`),
    exact at any wave size: past 2**24 lanes, where `auto_spw` can reach
    at 1280x720 and 19 spp, a float32 id would round neighbouring ids to
    one value; the row's int32 bits do not."""
    n = (1 << 24) + 4 * WV.W_TILE
    src = torch.randperm(n, generator=torch.Generator().manual_seed(5))
    assert torch.unique(src.float()).numel() < n
    state = torch.zeros((WV.WROW_LANE + 1, n))
    state[WV.WROW_LANE] = src.int().view(torch.float32)
    lane = WV.lane_ids(state)
    assert torch.equal(lane, src)
    rows = torch.stack([src.int(), -src.int()])
    back = torch.arange(n, dtype=torch.int32)
    assert torch.equal(WV.unsort_lanes(rows, lane),
                       torch.stack([back, -back]))


def test_permute_ref_moves_slices():
    """K4's plain version: rows [0, 24) of slice j come from slice
    perm[j]; the AOV rows stay; the inverse permutation restores."""
    g = np.random.default_rng(0)
    state = torch.from_numpy(g.normal(size=(WV.W_NROWS, 8 * WV.W_SLICE))
                             .astype(np.float32))
    perm = torch.from_numpy(g.permutation(8).astype(np.int32))
    out = WV.permute_ref(state, perm)
    s3 = state.view(WV.W_NROWS, 8, WV.W_SLICE)
    o3 = out.view(WV.W_NROWS, 8, WV.W_SLICE)
    for j in range(8):
        assert torch.equal(o3[:WV.W_SORT_PAD, j],
                           s3[:WV.W_SORT_PAD, int(perm[j])])
    assert torch.equal(out[WV.W_SORT_PAD:], state[WV.W_SORT_PAD:])
    back = WV.permute_ref(out, torch.argsort(perm).to(torch.int32))
    assert torch.equal(back, state)


def test_wrappers_run_plain_versions_on_cpu():
    """CPU tensors take the plain versions and count no launch; other
    devices raise."""
    bn, cfg = _buffers("immediates")
    port = _port(bn, cfg, 2)
    before = dict(kernels.launches)
    s1 = port.init_state(4, 2)
    s2 = WV.genesis_ref(port.tabs["cam_f"], port.pxf, port.pyf,
                        cfg.film.xresolution,
                        cfg.film.xresolution * cfg.film.yresolution,
                        port.n_real, 4, 1, 0)
    assert torch.equal(s1, s2)
    s3 = WV.genesis_ref(port.tabs["cam_f"], port.pxf, port.pyf,
                        cfg.film.xresolution,
                        cfg.film.xresolution * cfg.film.yresolution,
                        port.n_real, 4, 1, 0, stream="jax")
    assert not torch.equal(s1[WV.WROW_D], s3[WV.WROW_D])
    with pytest.raises(ValueError, match="stream"):
        _port(bn, cfg, 2, stream="philox")
    a = kernels.wave_path(port.tabs, s1.clone(), 4, 0, 1, port.n_pad,
                          port.key_bounds, 1, 0)
    b = WV.wave_step_ref(port.tabs, s1.clone(), 4, 0, 1, port.n_pad,
                         port.key_bounds, 1, 0)
    assert torch.equal(a, b)
    perm = torch.arange(port.n_pad // WV.W_SLICE, dtype=torch.int32)
    assert torch.equal(kernels.wave_permute(a, perm), a)
    assert kernels.launches == before
    with pytest.raises(ValueError, match="needs CUDA or CPU tensors"):
        kernels.wave_permute(a.to("meta"), perm.to("meta"))
    with pytest.raises(ValueError, match="sort_mode"):
        _port(bn, cfg, 2, sort_mode="bucket")


def test_render_engines():
    """render(engine=...): "wave" is the wave runner's waves averaged,
    "xla" is the XLA engine, and "auto" stays on the megakernel for a
    scene the kernels take."""
    from rene_tpu_torch.render import render
    scene = create_scene(parse_pbrt(_small_src()), "/tmp")
    out = render(scene, spp=3, seed=5, device="cpu", engine="wave")
    assert out["engine"] == "wave" and out["color"].shape == (16, 24, 3)
    assert np.isfinite(out["color"]).all() and out["total_rays"] > 0
    seed = int(np.random.default_rng(5).integers(0, 2 ** 31,
                                                 dtype=np.int32))
    bn, cfg = build_device_scene(scene)
    direct = _port(bn, cfg, WV.auto_spw(24 * 16, 3))(seed, 3)
    img = direct["radiance"].reshape(16, 24, 3)[::-1] / 3
    np.testing.assert_allclose(out["color"], img, rtol=1e-6, atol=1e-7)
    assert render(scene, spp=1, device="cpu")["engine"] == "pallas"
    assert render(scene, spp=1, device="cpu", engine="xla")["engine"] \
        == "xla"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["materials", "mesh_materials",
                                  "instanced"])
def test_wave_kernels_on_card_match_plain_version(name):
    """On a CUDA card: K3, one K2 launch and K4 against their plain
    versions, then whole waves of the kernels against the plain runner
    at 128x64 x spw 4, at the card's limits (chip_smoke.py phase 10 runs
    the same check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    src = getattr(scenes, name + "_scene")(128, 64)
    bn, cfg = build_device_scene(create_scene(parse_pbrt(src), "/tmp"))
    card = WV.make_wave_fn(bn, cfg, "cuda", samples_per_wave=4)
    plain = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=4)
    s_k = card.init_state(11, 4)
    s_p = plain.init_state(11, 4)
    torch.testing.assert_close(s_k[INT_ROWS].cpu(), s_p[INT_ROWS])
    torch.testing.assert_close(s_k.cpu(), s_p, rtol=0, atol=1e-5)
    before = dict(kernels.launches)
    card.kernel_step(1, s_k, 11, 0, card.n_pad // WV.W_TILE, 4)
    plain.kernel_step(1, s_p, 11, 0, plain.n_pad // WV.W_TILE, 4)
    torch.cuda.synchronize()
    variant = kernels.variant(card.tabs, "wave_path")
    assert kernels.launches[variant] == before[variant] + 1
    agree = (s_k[WV.WROW_ALIVE:WV.W_SORT_ROWS].cpu()
             == s_p[WV.WROW_ALIVE:WV.W_SORT_ROWS]).all(0)
    assert agree.double().mean() >= checks.CARD_FRAC
    perm = torch.randperm(card.n_pad // WV.W_SLICE).to(torch.int32)
    assert torch.equal(kernels.wave_permute(s_k, perm.cuda()).cpu(),
                       WV.permute_ref(s_k.cpu(), perm))
    # the JAX lane streams exist in the plain versions only
    with pytest.raises(ValueError, match="stream"):
        kernels.wave_path(card.tabs, s_k, 11, 1, 1, card.n_pad,
                          card.key_bounds, 1, 0, stream="jax")
    with pytest.raises(ValueError, match="stream"):
        kernels.wave_genesis(card.tabs, card.pxf, card.pyf, card.n_real, 11,
                             1, 0, stream="jax")
    a = checks.agreement(_film(card(11, 4)), _film(plain(11, 4)))
    checks.check_card(a, f"{name} 128x64 x spw 4 wave")
