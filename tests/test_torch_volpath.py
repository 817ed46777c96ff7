"""The volpath megakernel (slice K1e) against the JAX megakernel.

`vol_lanes_ref` (rene_tpu_torch/integrators/volpath.py through
mega_path.path_lanes_ref) against rene_tpu's megakernel running its
volpath body in interpret mode (`make_pallas_batch_fn(...,
interpret=True)`), per pixel, on the three fog scenes: `fog_scene`
(immediates, 32x16), `fog_env_scene` (an env map with env-map light
sampling and one emitter, 32x32) and the small `fog_mesh_scene` (a world
mesh with three material slots, shared-BLAS instances, a fog box of
None faces, 32x32), and on `nested_fog_scene` (three nested None
boundaries between four media, two distant lights and an emitter,
16x8, maxdepth 16: medium switches and marches through them), and on
the benchmark's Cornell smoke scene (port_bench/scenes/cornell_smoke.py:
media bounded by None triangles among the immediates, one absorbing and
one scattering, depth 50, 16x16) at a hundredth of the book's size, at
2 spp, with the JAX packer's cluster width cut to 16 as in
test_torch_mesh.py. Both draw the same xorshift32 stream in the
volpath body's order (med_sample, med_sample_p, the scatter point's
emitter draws, the path body's draws without rrv, the camera's), so
every lane traces the same path. Limits as in test_torch_mesh.py:
>= 99.5% of pixels' radiance and >= 99% of their normal and albedo sums
agree (rene_tpu_torch.checks), image means within 1e-3 relative, ray
totals within 0.1%, counted over the JAX runner's own lanes (its padding
lanes repeat pixels, and the port's lane of a pixel traces what they
trace). Measured: radiance >= 99.90%, AOV 100%, means within 5.3e-4,
ray totals within 0.033% (the nested scene: radiance and AOV 100%,
means 3.2e-8 apart, ray totals equal; the smoke scene: radiance and AOV
100%, means 2.5e-8 apart, ray totals equal). At the book's own size
(coordinates to 800) the two differ by rounding alone: the camera ray's
world point less the camera's origin cancels digits, XLA contracts FMAs
where torch does not, and ~1% of lanes end 0.1-0.4% apart on the same
paths.

The render loop (`render(device="cpu")`) against `rene_tpu.render.
render(engine="pallas")` on the fog scene, image for image.
"""
import re

import numpy as np
import pytest
import torch

from port_bench.scenes import cornell_smoke
from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.scene.device import build_device_scene
from rene_tpu_torch import checks, kernels, scenes
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.integrators import volpath as V
from rene_tpu_torch.ops import intersect as X
from rene_tpu_torch.scene import pack as P

torch.set_num_threads(2)

SPP = 2
# the JAX kernel's switches, pinned to their defaults
JAX_ENV_OFF = ("RENE_MF_DIST", "RENE_MEGA_PACK", "RENE_MESH_TEST",
               "RENE_CONST_DIR", "RENE_SPH_ANY", "RENE_SUB_TRIS",
               "RENE_SUB_GATE", "RENE_CLUSTER_ORDER", "RENE_ENV_NEE")


def smoke_scene(width, height):
    """The Cornell smoke scene at a hundredth of the book's size: the
    camera and the world scaled by 0.01, the media's density by 100, the
    boxes' lift above the floor kept at 0.01."""
    src = cornell_smoke.scene(width, height)
    src = src.replace("LookAt 278 278 -800  278 278 0",
                      "LookAt 2.78 2.78 -8  2.78 2.78 0")
    src = src.replace("WorldBegin", "WorldBegin\nScale .01 .01 .01")
    src = src.replace("[ 0.01 0.01 0.01 ]", "[ 1 1 1 ]")
    return re.sub(r"Translate (\S+) 0\.01 (\S+)", r"Translate \1 1 \2", src)


# (width, height, directory) -> pbrt text; a directory for the images
SCENES = {
    "fog": ((32, 16), lambda w, h, d: scenes.fog_scene(w, h)),
    "fog_env": ((32, 32), lambda w, h, d: scenes.fog_env_scene(d, w, h)),
    "fog_mesh": ((32, 32), lambda w, h, d: scenes.fog_mesh_scene(
        w, h, small=True)),
    "nested": ((16, 8), lambda w, h, d: scenes.nested_fog_scene(w, h)),
    "smoke": ((16, 16), lambda w, h, d: smoke_scene(w, h)),
}


def buffers(name, directory, width=0, height=0):
    (w, h), make = SCENES[name]
    src = make(width or w, height or h, directory)
    return build_device_scene(create_scene(parse_pbrt(src), str(directory)))


def _jax_env(mp):
    from rene_tpu.integrators import pallas_path as pp
    mp.setattr(pp, "CLUSTER", 16)
    mp.setattr(pp, "SPH_BLOCK", 16)
    mp.setenv("RENE_QUAD_FUSE", "0")
    for k in JAX_ENV_OFF:
        mp.delenv(k, raising=False)
    return pp


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("fog_scenes")


@pytest.mark.parametrize("name,seed", [("fog", 7), ("fog_env", 7),
                                       ("fog_mesh", 7), ("nested", 7),
                                       ("smoke", 7)])
def test_plain_version_matches_interpret_megakernel(scene_dir, name, seed):
    with pytest.MonkeyPatch.context() as mp:
        pp = _jax_env(mp)
        bn, cfg = buffers(name, scene_dir)
        assert cfg.integrator == "volpath" and cfg.has_media
        run = pp.make_pallas_batch_fn(bn, cfg, interpret=True)
        res = run(seed, SPP)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    assert tabs["volpath"] and not tabs["use_rr"]
    assert tabs["has_accel"] == (name in ("fog_mesh", "nested"))
    assert tabs["has_env"] == (name == "fog_env")
    for k in X.casts:
        X.casts[k] = 0
    out = V.vol_lanes_ref(tabs, seed, SPP).numpy()
    assert np.isfinite(out).all()
    # every kind of cast ran: closest hits, marches, emitter pdfs
    assert min(X.casts.values()) > 0, X.casts
    ref = np.concatenate([np.array(res[k]).T for k in
                          ("radiance", "normal", "albedo")])
    a = checks.agreement(out[:9], ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.99, a
    assert a["mean_rel"] <= 1e-3, a
    # the JAX lanes' pixels, its padding and edge-block lanes included
    w = cfg.film.xresolution
    lane_pix = (run.py_host.astype(np.int64) * w
                + run.px_host.astype(np.int64)).reshape(-1)
    rays = float(out[9][lane_pix].sum())
    jax_rays = float(res["rays"])
    assert abs(rays - jax_rays) <= 1e-3 * jax_rays, (rays, jax_rays)


def test_kernel_wrapper_runs_vol_lanes_ref_on_cpu(scene_dir):
    """CPU tables run the plain volpath megakernel and count no launch;
    the variant names the volpath build."""
    tabs = M.device_tables(P.pack_tables(*buffers("fog", scene_dir, 8, 8)),
                           "cpu")
    assert kernels.variant(tabs) == "mega_volpath"
    assert kernels.variant(tabs, "wave_path") == "wave_volpath"
    before = dict(kernels.launches)
    torch.testing.assert_close(kernels.mega_path(tabs, 3, 1),
                               V.vol_lanes_ref(tabs, 3, 1), rtol=0, atol=0)
    assert kernels.launches == before
    with pytest.raises(ValueError, match="integrator is path"):
        V.vol_lanes_ref(dict(tabs, volpath=False), 3, 1)


def test_render_matches_jax_pallas_engine(scene_dir, monkeypatch):
    """render(device="cpu") against the JAX render loop's volpath
    megakernel: the same chunk seeds, image for image (the rule of
    test_torch_render.py)."""
    _jax_env(monkeypatch)
    from rene_tpu.render import render as jax_render
    from rene_tpu_torch.render import render
    src = scenes.fog_scene(32, 16)
    ref = jax_render(create_scene(parse_pbrt(src), "/tmp"), spp=SPP, seed=5,
                     engine="pallas")
    out = render(create_scene(parse_pbrt(src), "/tmp"), spp=SPP, seed=5,
                 device="cpu")
    assert out["engine"] == "pallas" and out["launches"] == 0
    c, rc = out["color"], ref["color"]
    assert c.shape == rc.shape == (16, 32, 3)
    assert np.isclose(c, rc, rtol=1e-3, atol=1e-5).all(-1).mean() >= 0.97
    assert abs(c.mean() - rc.mean()) <= 1e-3 * abs(rc.mean())
    for k in ("normal", "albedo"):
        assert (np.abs(out[k] - ref[k]) <= 1e-4).all(-1).mean() >= 0.99, k


def test_media_and_slots_change_the_image(scene_dir):
    """The medium is in use: with sigma_t zeroed the fog scene's image
    changes, with the slots' interfaces zeroed too (every path stays in
    vacuum)."""
    tabs = M.device_tables(P.pack_tables(*buffers("fog", scene_dir, 16, 8)),
                           "cpu")
    ref = V.vol_lanes_ref(tabs, 5, 2)
    clear = dict(tabs, media=torch.zeros_like(tabs["media"]))
    mats = tabs["mats"].clone()
    mats[:, P.MAT_IMED] = 0.0
    mats[:, P.MAT_EMED] = 0.0
    vacuum = dict(tabs, mats=mats)
    for other in (clear, vacuum):
        a = checks.agreement(V.vol_lanes_ref(other, 5, 2), ref)
        assert a["rad_frac"] < 0.5, a


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_on_card_matches_plain_version(tmp_path, name):
    """On a CUDA card: the volpath variant against its plain version at
    128x64 x 4 spp, at the card's limits (chip_smoke.py phase 16 runs the
    same check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tabs = M.device_tables(P.pack_tables(*buffers(name, tmp_path, 128, 64)),
                           "cuda")
    before = dict(kernels.launches)
    out = kernels.mega_path(tabs, 1234567, 4)
    ref = V.vol_lanes_ref(dict(tabs), 1234567, 4)
    torch.cuda.synchronize()
    variant = kernels.variant(tabs)
    assert variant.startswith("mega_volpath")
    assert kernels.launches[variant] == before[variant] + 1
    checks.check_card(checks.agreement(out.cpu(), ref.cpu()),
                      f"{name} 128x64 x 4 spp")


def test_counting_build_takes_card_volpath_mesh_tables_only(scene_dir,
                                                           tmp_path):
    """The counting build (kernels.COUNT, -DMEGA_COUNT=1) is a library of
    its own with its own launch count, which no render path's variant
    names and the variants' build leaves out; its wrapper refuses CPU
    tables and tables of another variant. A csrc copy with other contents
    builds to another library, as the probe's --compare needs."""
    assert "-DMEGA_COUNT=1" in kernels.BUILDS[kernels.COUNT]
    assert kernels.COUNT not in kernels.VARIANTS
    assert kernels.launches[kernels.COUNT] == 0
    tabs = M.device_tables(P.pack_tables(*buffers("fog_mesh", scene_dir, 8,
                                                  8)), "cpu")
    assert kernels.variant(tabs) == "mega_volpath_mesh" != kernels.COUNT
    for t in (tabs, dict(tabs, sobol=True)):
        with pytest.raises(ValueError, match="mega_volpath_counts"):
            kernels.mega_volpath_counts(t, 3, 1)
    copy = tmp_path / "csrc"
    copy.mkdir()
    for f in kernels.CSRC.glob("*.cu*"):
        (copy / f.name).write_bytes(f.read_bytes())
    assert kernels.library_path("mega_volpath", copy) \
        == kernels.library_path("mega_volpath")
    (copy / "mega_path.cu").write_text(
        (copy / "mega_path.cu").read_text() + "\n// another floor\n")
    assert kernels.library_path("mega_volpath", copy) \
        != kernels.library_path("mega_volpath")


def test_wave_counting_build_takes_card_volpath_mesh_tables_only(scene_dir):
    """K2's counting build (kernels.WAVE_COUNT: wave_volpath_mesh with
    -DMEGA_COUNT=1) is a library of its own with its own launch count and
    the counts' entry point, which the variants' build leaves out; its
    wrapper refuses CPU states and the tables of another instance."""
    from rene_tpu_torch.integrators import wave as WV
    assert kernels.BUILDS[kernels.WAVE_COUNT] \
        == kernels.VARIANTS["wave_volpath_mesh"] + ("-DMEGA_COUNT=1",)
    assert kernels.WAVE_COUNT not in kernels.VARIANTS
    assert kernels.launches[kernels.WAVE_COUNT] == 0
    assert set(kernels._ENTRY_POINTS[kernels.WAVE_COUNT]) \
        == {"wave_path_launch", "step_counts"}
    bn, cfg = buffers("fog_mesh", scene_dir, 8, 8)
    run = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2)
    state = run.init_state(3, 2)
    for t in (run.tabs, dict(run.tabs, sobol=True),
              dict(run.tabs, has_accel=False)):
        with pytest.raises(ValueError, match="wave_volpath_counts"):
            kernels.wave_volpath_counts(t, state, 3, 0, 1, run.n_pad,
                                        run.key_bounds, 1, 0)


@pytest.mark.cuda
def test_wave_counting_build_on_card_counts_and_matches(tmp_path):
    """On a CUDA card: a K2 launch of k 2 through the counting build on
    the small fog mesh at 128x64 x spw 2 leaves the state the volpath
    mesh K2 leaves (the launch's lanes agree on every row), runs each
    alive lane once, casts one path ray per lane-bounce and at most 32
    lanes active per warp step."""
    from rene_tpu_torch.integrators import wave as WV
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    bn, cfg = buffers("fog_mesh", tmp_path, 128, 64)
    run = WV.make_wave_fn(bn, cfg, "cuda", samples_per_wave=2)
    s0 = run.init_state(7, 2)
    before = kernels.launches[kernels.WAVE_COUNT]
    out, c = kernels.wave_volpath_counts(run.tabs, s0.clone(), 7, 0, 2,
                                         run.n_pad, run.key_bounds, 1, 0)
    ref = kernels.wave_path(run.tabs, s0.clone(), 7, 0, 2, run.n_pad,
                            run.key_bounds, 1, 0)
    torch.cuda.synchronize()
    assert kernels.launches[kernels.WAVE_COUNT] == before + 1
    ok = ((out - ref).abs() <= checks.RAD_ATOL
          + checks.RAD_RTOL * ref.abs()).all(0)
    assert ok.double().mean() >= checks.CARD_FRAC
    assert c["lanes"] == run.n_real
    bounces = float((ref[WV.WROW_RAYS] - s0[WV.WROW_RAYS]).sum()) \
        / M.ray_increment(run.tabs)
    assert c["lane_steps"] - c["march_steps"] == bounces
    assert c["warp_steps"] <= c["active_lanes"] <= 32 * c["warp_steps"]


@pytest.mark.cuda
def test_counting_build_on_card_counts_and_matches(tmp_path):
    """On a CUDA card: the counting build's launch on the small fog mesh
    at 128x64 x 2 spp traces what the volpath mesh build traces (the
    card's limits), with one lane per pixel, at least one step per path,
    march steps among them and at most 32 lanes active per warp step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tabs = M.device_tables(P.pack_tables(*buffers("fog_mesh", tmp_path, 128,
                                                  64)), "cuda")
    before = kernels.launches[kernels.COUNT]
    out, c = kernels.mega_volpath_counts(tabs, 7, 2)
    ref = kernels.mega_path(tabs, 7, 2)
    torch.cuda.synchronize()
    assert kernels.launches[kernels.COUNT] == before + 1
    checks.check_card(checks.agreement(out.cpu(), ref.cpu()),
                      "counting build, fog mesh 128x64 x 2 spp")
    assert c["lanes"] == 128 * 64
    assert 2 * c["lanes"] <= c["lane_steps"] == c["active_lanes"]
    assert 0 < c["march_steps"] < c["lane_steps"]
    assert c["warp_steps"] <= c["active_lanes"] <= 32 * c["warp_steps"]


def test_immediates_counting_build_takes_card_volpath_tables_only(
        scene_dir, monkeypatch):
    """The immediates volpath megakernel's counting build
    (kernels.IMM_COUNT: mega_volpath with -DMEGA_COUNT=1) is a library of
    its own with its own launch count and the counts' entry point, which
    the variants' build leaves out; `mega_volpath_counts` refuses CPU
    tables, and on a card Sobol tables and path tables."""
    assert kernels.IMM_COUNT == "mega_volpath_count"
    assert kernels.BUILDS[kernels.IMM_COUNT] \
        == kernels.VARIANTS["mega_volpath"] + ("-DMEGA_COUNT=1",)
    assert kernels.IMM_COUNT not in kernels.VARIANTS
    assert kernels.launches[kernels.IMM_COUNT] == 0
    assert set(kernels._ENTRY_POINTS[kernels.IMM_COUNT]) \
        == {"mega_path_launch", "step_counts"}
    tabs = M.device_tables(P.pack_tables(*buffers("fog", scene_dir, 8, 8)),
                           "cpu")
    assert kernels.variant(tabs) == "mega_volpath"
    with pytest.raises(ValueError, match="mega_volpath_counts"):
        kernels.mega_volpath_counts(tabs, 3, 1)
    # the variant's refusals, as on a card
    monkeypatch.setattr(kernels, "_cuda", lambda device, what: True)
    for t in (dict(tabs, sobol=True), dict(tabs, volpath=False)):
        with pytest.raises(ValueError, match="mega_volpath_counts"):
            kernels.mega_volpath_counts(t, 3, 1)
    assert kernels.launches[kernels.IMM_COUNT] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fog", "smoke"])
def test_immediates_counting_build_on_card_counts_and_matches(tmp_path,
                                                              name):
    """On a CUDA card: the immediates counting build's launch on the fog
    scene (its marches inline) and on the Cornell smoke scene (through the
    block's march queue, csrc/vol_queue.cuh) at 128x64 x 2 spp traces what
    the immediates volpath build traces (the card's limits), with one lane
    per pixel, at least one step per path, march steps among them, at most
    32 lanes active per warp step, and the march steps from the queue."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tabs = M.device_tables(P.pack_tables(*buffers(name, tmp_path, 128,
                                                  64)), "cuda")
    assert kernels.variant(tabs) == "mega_volpath"
    before = dict(kernels.launches)
    out, c = kernels.mega_volpath_counts(tabs, 7, 2)
    ref = kernels.mega_path(tabs, 7, 2)
    torch.cuda.synchronize()
    assert kernels.launches[kernels.IMM_COUNT] \
        == before[kernels.IMM_COUNT] + 1
    assert kernels.launches[kernels.COUNT] == before[kernels.COUNT]
    checks.check_card(checks.agreement(out.cpu(), ref.cpu()),
                      f"immediates counting build, {name} 128x64 x 2 spp")
    assert c["lanes"] == 128 * 64
    assert 2 * c["lanes"] <= c["lane_steps"]
    assert 0 < c["march_steps"] < c["lane_steps"]
    assert c["warp_steps"] <= c["active_lanes"] <= 32 * c["warp_steps"]
    if name == "smoke":
        assert 0 < c["queued_steps"] <= c["march_steps"]
    else:
        assert c["queued_steps"] == 0


@pytest.mark.cuda
def test_queued_kernel_on_card_is_the_same_run_to_run(tmp_path):
    """On a CUDA card: the immediates volpath megakernel on the Cornell
    smoke scene, whose marches run from the block's queue
    (csrc/vol_queue.cuh) on whichever warp takes them, gives the same sums
    bit for bit in two launches of one seed at 128x64 x 4 spp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tabs = M.device_tables(P.pack_tables(*buffers("smoke", tmp_path, 128,
                                                  64)), "cuda")
    assert kernels.variant(tabs) == "mega_volpath"
    assert tabs["lights"].shape[0] == 0
    a = kernels.mega_path(tabs, 4100000123, 4)
    b = kernels.mega_path(tabs, 4100000123, 4)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert float(a[9].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smoke", "fog_env"])
def test_queued_sobol_kernel_on_card_matches_plain_version(tmp_path, name):
    """On a CUDA card: the Sobol instances of the immediates volpath
    megakernel that march through the block's queue (the Cornell smoke
    scene without texture code, the env-lit fog scene with it: neither
    has a distant light) against their plain version at 128x64 x 4 spp,
    at the card's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    (_, make) = SCENES[name]
    src = scenes.with_sampler(make(128, 64, tmp_path))
    tabs = M.device_tables(P.pack_tables(*build_device_scene(create_scene(
        parse_pbrt(src), str(tmp_path)))), "cuda")
    assert kernels.variant(tabs) == "mega_volpath" + kernels.SOBOL
    assert tabs["lights"].shape[0] == 0
    out = kernels.mega_path(tabs, 1234567, 4)
    ref = V.vol_lanes_ref(dict(tabs), 1234567, 4)
    torch.cuda.synchronize()
    checks.check_card(checks.agreement(out.cpu(), ref.cpu()),
                      f"{name} 128x64 x 4 spp, Sobol")
