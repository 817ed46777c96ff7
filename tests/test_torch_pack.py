"""Sample-in-tile packing (K1f): `pack` sample slots per pixel.

* `path_lanes_ref` (and `vol_lanes_ref`) at pack 4 and 16 against
  rene_tpu's megakernel in interpret mode at the same pack
  (`make_pallas_batch_fn(..., interpret=True, pack=...)`), per pixel
  after `finish` sums the slots: the mesh materials at 64x64 (whole 16x16
  blocks) and at 72x40 (partial edge blocks, radiance only), the
  instanced scene at pack 16, a `Sampler "sobol"` scene and the small fog
  mesh at maxdepth 8 (volpath). Both seed each lane's stream by its lane
  id pix + slot * npix and its pixel block, and mix the slot into the
  Sobol key, so every lane traces the same paths; the JAX kernel keeps a
  pixel's slots inside its tile, the port slot-major, which changes no
  lane. The pinning and limits are tests/test_torch_mesh.py's: >= 99.5%
  of pixels' radiance and >= 99% of their normal and albedo sums agree,
  image means within 1e-3 relative, ray totals within 0.1% on films of
  whole blocks. Measured: radiance >= 99.90%, AOV 100%, means within
  2.1e-7, ray totals equal.
* The port's (pixel, slot) -> tile map against the JAX runner's lane
  layout (`px_host`/`py_host`), and `finish` summing exactly `pack` slots.
* `make_mega_batch_fn`'s pack: `spp_mult`, RENE_MEGA_PACK, `auto`, pack 1
  on scenes outside cluster mode, the refusals; the render loop's divide
  by the samples delivered.
"""
import numpy as np
import pytest
import torch

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.scene.device import build_device_scene
from rene_tpu_torch import checks, kernels, scenes
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.ops import rng
from rene_tpu_torch.scene import pack as P
from .test_torch_mesh import _jax_env

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_beckmann_switch(monkeypatch):
    """tests/test_scene.py leaves RENE_MF_DIST=beckmann in os.environ; the
    runners read it where the plain calls here pass beckmann=False, so
    every test of this file runs without it."""
    monkeypatch.delenv("RENE_MF_DIST", raising=False)

SCENES = {
    "mesh_materials": lambda w, h: scenes.mesh_materials_scene(w, h, 8, 6),
    "instanced": lambda w, h: scenes.instanced_scene(w, h),
    "sobol_mesh": lambda w, h: scenes.with_sampler(
        scenes.mesh_materials_scene(w, h, 8, 6)),
    "fog_mesh": lambda w, h: scenes.fog_mesh_scene(w, h, maxdepth=8,
                                                   small=True),
    "sobol_fog_mesh": lambda w, h: scenes.with_sampler(
        scenes.fog_mesh_scene(w, h, maxdepth=8, small=True)),
    "materials": lambda w, h: scenes.materials_scene(w, h),
}


def buffers(name, width, height):
    src = SCENES[name](width, height)
    return build_device_scene(create_scene(parse_pbrt(src), "/tmp"))


def _port_film(out):
    return np.concatenate([out[k].numpy().T
                           for k in ("radiance", "normal", "albedo")])


@pytest.mark.parametrize("name,width,height,pack,spp", [
    ("mesh_materials", 64, 64, 4, 1), ("mesh_materials", 72, 40, 4, 1),
    ("instanced", 64, 32, 16, 1), ("sobol_mesh", 32, 32, 4, 2),
    ("fog_mesh", 32, 32, 4, 1)])
def test_packed_plain_version_matches_interpret_megakernel(
        name, width, height, pack, spp):
    seed = 7
    with pytest.MonkeyPatch.context() as mp:
        pp = _jax_env(mp)
        bn, cfg = buffers(name, width, height)
        run = pp.make_pallas_batch_fn(bn, cfg, interpret=True, pack=pack)
        assert run.spp_mult == pack
        res = run(seed, spp)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    assert tabs["block_seed"]
    assert tabs["sobol"] == (name == "sobol_mesh")
    assert tabs["volpath"] == (name == "fog_mesh")
    lanes = M.path_lanes_ref(tabs, seed, spp, pack=pack)
    assert lanes.shape == (P.OUT_ROWS, width * height * pack)
    assert torch.isfinite(lanes).all()
    out = M.finish(lanes, pack)
    ref = np.concatenate([np.array(res[k]).T for k in
                          ("radiance", "normal", "albedo")])
    bs = rng.block_edge(pack)
    if width % bs or height % bs:
        # partial edge blocks: radiance only, no ray totals
        a = checks.agreement(_port_film(out)[:3], ref[:3])
        assert a["rad_frac"] >= 0.995, a
        assert a["mean_rel"] <= 1e-3, a
        return
    a = checks.agreement(_port_film(out), ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.99, a
    assert a["mean_rel"] <= 1e-3, a
    jax_rays = float(res["rays"])
    assert abs(float(out["rays"]) - jax_rays) <= 1e-3 * jax_rays


@pytest.mark.parametrize("pack", [4, 16])
def test_pack_layout_and_finish(monkeypatch, pack):
    """Every lane of the JAX runner's packed layout (tile l // 1024,
    pixel px_host + py_host * W, slot (l % 1024) // ppb) is the port's
    lane pix + slot * npix in the same grid step, and the real lanes of
    each tile (not the clamped copies of partial edge blocks) are each of
    the port's npix * pack lanes once; `finish` sums exactly `pack` slots
    per pixel."""
    _jax_env(monkeypatch)
    from rene_tpu.integrators import pallas_path as pp
    w, h = 72, 40
    bn, cfg = buffers("mesh_materials", w, h)
    run = pp.make_pallas_batch_fn(bn, cfg, interpret=True, pack=pack)
    bs = rng.block_edge(pack)
    ppb = bs * bs
    px = run.px_host.reshape(-1).astype(np.int64)
    py = run.py_host.reshape(-1).astype(np.int64)
    j = np.arange(px.size)
    step, slot = j // 1024, (j % 1024) // ppb
    pix = py * w + px
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    lane = torch.from_numpy(pix + slot * w * h)
    mine, tile, _, _ = M.lane_start(tabs, lane, 0, pack)
    np.testing.assert_array_equal(mine.numpy(), pix)
    np.testing.assert_array_equal(tile.numpy(), step)
    bw = -(-w // bs)
    assert run.n_tiles == bw * -(-h // bs)
    # the real (unclamped) lanes cover every port lane once
    jp = j % ppb
    real = ((step % bw) * bs + jp % bs < w) & ((step // bw) * bs + jp // bs
                                                < h)
    covered = np.sort((pix + slot * w * h)[real])
    np.testing.assert_array_equal(covered, np.arange(w * h * pack))
    # finish: lane value = the lane's pixel id, summed over the slots
    lanes = torch.arange(w * h * pack, dtype=torch.float32) % (w * h)
    out = M.finish(lanes.expand(P.OUT_ROWS, -1).contiguous(), pack)
    np.testing.assert_array_equal(out["radiance"][:, 0].numpy(),
                                  np.arange(w * h, dtype=np.float32) * pack)


def test_lane_start_at_pack_1_is_the_pixel_stream():
    """At pack 1 a lane is its pixel: the stream and the Sobol key are the
    ones the unpacked kernels drew (rng.seed_state, sobol.pixkey of the
    32x32-block seed)."""
    from rene_tpu_torch.ops import sobol as SB
    tabs = M.device_tables(P.pack_tables(*buffers("mesh_materials", 72, 40)),
                           "cpu")
    lanes = torch.arange(72 * 40)
    pix, tile, st, key = M.lane_start(tabs, lanes, 99)
    assert torch.equal(pix, lanes)
    assert torch.equal(tile, rng.tile_of(lanes, 72, True))
    assert torch.equal(st, rng.seed_state(lanes, 99, tile))
    assert torch.equal(key, SB.pixkey(lanes, (99 + tile * 65537) & rng.MASK))


@pytest.mark.parametrize("name", ["sobol_mesh", "fog_mesh"])
def test_plain_version_walks_several_packs_at_once(name):
    """path_lanes_ref on the lanes of launches at packs 1, 4 and 16 at
    once (each lane's pack a tensor) gives each lane what the walk at its
    own pack gives it, bit for bit."""
    tabs = M.device_tables(P.pack_tables(*buffers(name, 32, 16)), "cpu")
    tabs["max_depth"] = 3
    npix = 32 * 16
    g = torch.Generator().manual_seed(3)
    sets = [(p, torch.randperm(npix * p, generator=g)[:96])
            for p in (1, 4, 16)]
    lanes = torch.cat([l for _, l in sets])
    packs = torch.cat([torch.full_like(l, p) for p, l in sets])
    both = M.path_lanes_ref(tabs, 11, 1, lanes=lanes, pack=packs)
    want = torch.cat([M.path_lanes_ref(tabs, 11, 1, lanes=l, pack=p)
                      for p, l in sets], 1)
    assert torch.equal(both, want)
    with pytest.raises(ValueError, match="pack must be one of"):
        M.path_lanes_ref(tabs, 11, 1, lanes=lanes, pack=packs * 2)


def test_batch_fn_pack(monkeypatch):
    """spp_mult is the pack; RENE_MEGA_PACK is read once per runner and
    `auto` is 1 on the CPU; a scene outside cluster mode runs pack 1; a
    pack outside (1, 4, 16, 64, 256) and a lane count reaching 2^31 are
    refused."""
    monkeypatch.delenv("RENE_MEGA_PACK", raising=False)
    bn, cfg = buffers("mesh_materials", 32, 32)
    run = M.make_mega_batch_fn(bn, cfg, "cpu", pack=4)
    assert run.spp_mult == 4
    out = run(3, 1)
    assert out["radiance"].shape == (32 * 32, 3)
    ref = M.finish(M.path_lanes_ref(
        M.device_tables(P.pack_tables(bn, cfg), "cpu"), 3, 1, pack=4), 4)
    assert torch.equal(out["radiance"], ref["radiance"])
    assert M.make_mega_batch_fn(bn, cfg, "cpu").spp_mult == 1
    monkeypatch.setenv("RENE_MEGA_PACK", "auto")
    assert M.make_mega_batch_fn(bn, cfg, "cpu", spp_hint=64).spp_mult == 1
    monkeypatch.setenv("RENE_MEGA_PACK", "16")
    run = M.make_mega_batch_fn(bn, cfg, "cpu")
    monkeypatch.setenv("RENE_MEGA_PACK", "4")
    assert run.spp_mult == 16
    # an explicit pack wins over the environment
    assert M.make_mega_batch_fn(bn, cfg, "cpu", pack=1).spp_mult == 1
    # immediates scenes do not pack (:5895-5896)
    bn_i, cfg_i = buffers("materials", 32, 16)
    assert M.make_mega_batch_fn(bn_i, cfg_i, "cpu", pack=16).spp_mult == 1
    tabs_i = M.device_tables(P.pack_tables(bn_i, cfg_i), "cpu")
    with pytest.raises(ValueError, match="only cluster-mode"):
        M.path_lanes_ref(tabs_i, 0, 1, pack=4)
    for bad in (2, 8, 512):
        with pytest.raises(ValueError, match="pack must be one of"):
            M.make_mega_batch_fn(bn, cfg, "cpu", pack=bad)
    monkeypatch.setenv("RENE_MEGA_PACK", "3")
    with pytest.raises(ValueError, match="pack must be one of"):
        M.make_mega_batch_fn(bn, cfg, "cpu")
    # 4096 x 2160 x 256 lanes pass int32
    bn_b, cfg_b = buffers("mesh_materials", 4096, 2160)
    with pytest.raises(ValueError, match="2\\^31"):
        M.make_mega_batch_fn(bn_b, cfg_b, "cpu", pack=256)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    out = torch.empty((P.OUT_ROWS, 32 * 32), dtype=torch.float32)
    with pytest.raises(ValueError, match="out: shape"):
        kernels.launch_args(tabs, 0, 1, False, out, 4)


def test_auto_pack_rule():
    """`auto` on the card: among the packs that divide the render's spp,
    the smallest whose lanes reach AUTO_FILL resident sets of threads,
    else the largest."""
    fill = M.AUTO_FILL * M.RESIDENT_LANES
    assert M.auto_pack(int(fill) + 1, 64) == 1
    assert M.auto_pack(160 * 90, 1) == 1
    for npix in (160 * 90, 320 * 180, 640 * 360):
        p = M.auto_pack(npix, 256)
        assert npix * p >= fill
        assert p == 1 or npix * (p // 4) < fill
    assert M.auto_pack(160 * 90, 8) == 4
    assert M.auto_pack(16, 1024) == 256
    # the films of the sweep: 1280x720 stays unpacked, the small ones
    # reach 13.6 resident sets within 16 and 64 spp
    assert M.auto_pack(1280 * 720, 64) == 1
    assert M.auto_pack(640 * 360, 16) == 4
    assert M.auto_pack(320 * 180, 16) == 16
    assert M.auto_pack(160 * 90, 16) == 16
    assert M.auto_pack(160 * 90, 64) == 64
    # only a pack that divides spp: the render delivers exactly spp
    assert M.auto_pack(320 * 180, 20) == 4
    assert M.auto_pack(160 * 90, 12) == 4
    assert M.auto_pack(160 * 90, 17) == 1


def test_render_divides_by_delivered_samples(monkeypatch, tmp_path):
    """render() at RENE_MEGA_PACK=4 runs one chunk of one per-lane sample
    for 4 spp and divides the slot sums by the 4 samples delivered."""
    from rene_tpu_torch.render import render
    from rene_tpu_torch.scene import load_scene
    from rene_tpu_torch.utils.film import rays_to_image
    path = tmp_path / "scene.pbrt"
    with open(path, "w") as f:
        f.write(SCENES["mesh_materials"](32, 16))
    monkeypatch.setenv("RENE_MEGA_PACK", "4")
    res = render(load_scene(str(path)), spp=4, seed=5, device="cpu")
    bn, cfg = buffers("mesh_materials", 32, 16)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    chunk_seed = int(np.random.default_rng(5).integers(0, 2 ** 31,
                                                       dtype=np.int32))
    out = M.finish(M.path_lanes_ref(tabs, chunk_seed, 1, pack=4), 4)
    np.testing.assert_array_equal(
        res["color"], rays_to_image(out["radiance"].numpy() / 4, 32, 16))
    assert res["total_rays"] == float(out["rays"])


@pytest.mark.cuda
@pytest.mark.parametrize("name,pack", [("mesh_materials", 4),
                                       ("instanced", 16), ("sobol_mesh", 16),
                                       ("fog_mesh", 4),
                                       ("sobol_fog_mesh", 4)])
def test_packed_kernel_on_card_matches_plain_version(name, pack):
    """On a CUDA card: the packed launch of the mesh builds (path and
    volpath, independent and Sobol) against its plain version, lane by
    lane, at the card's limits (chip_smoke.py phase 25 runs the same
    check at full shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    bn, cfg = buffers(name, 64, 32)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cuda")
    variant = kernels.variant(tabs)
    before = dict(kernels.launches)
    out = kernels.mega_path(tabs, 1234567, 2, pack=pack)
    ref = M.path_lanes_ref(tabs, 1234567, 2, pack=pack)
    torch.cuda.synchronize()
    assert kernels.launches[variant] == before[variant] + 1
    assert out.shape == (P.OUT_ROWS, 64 * 32 * pack)
    a = checks.agreement(out, ref)
    checks.check_card(a, f"{name} pack {pack}")
