"""The Sobol megakernel (K-sobol in K1a-K1e) against the JAX megakernel.

`path_lanes_ref` (rene_tpu_torch/integrators/mega_path.py, with
volpath.py's bounce for `fog_scene`) on `Sampler "sobol"` scenes against
rene_tpu's megakernel in interpret mode (`make_pallas_batch_fn(...,
interpret=True)`), per pixel: the eight materials (immediates, Russian
roulette), the small mesh-materials scene (the BVH walk; grid steps are
32x32 blocks, so each block's pixels take their own Sobol seed) and the
fog scene (volpath: the medium, phase and scatter-point emitter draws
stay on the lane stream). Both draw the same Sobol pairs (ops/sobol.py
against rene_tpu/ops/sobol.py) and stream draws, so every lane traces the
same path. The rule is test_torch_volpath.py's: >= 99.5% of pixels'
radiance and >= 99% of their normal and albedo sums agree
(rene_tpu_torch.checks), image means within 1e-3 relative, ray totals
within 0.1% over the JAX runner's own lanes.

Then the reference's own claim for its sampler (tests/test_pallas.py:
615-667) on the port: on the reference's Sobol test scene at 16x16, the
Sobol render at 32 spp is closer to a 512-spp independent render than
the independent render at 32 spp, err_s < 0.85 err_i; and the two agree
in the mean (no bias).
"""
import numpy as np
import pytest
import torch

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.scene.device import build_device_scene
from rene_tpu_torch import checks, kernels, scenes
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.scene import pack as P
from .test_torch_volpath import JAX_ENV_OFF

torch.set_num_threads(2)

SPP = 2
SCENES = {
    "materials": lambda: scenes.materials_scene(32, 16),
    "mesh": lambda: scenes.mesh_materials_scene(32, 32, 8, 6),
    "fog": lambda: scenes.fog_scene(32, 16),
}


def _jax_env(mp):
    from rene_tpu.integrators import pallas_path as pp
    mp.setattr(pp, "CLUSTER", 16)
    mp.setattr(pp, "SPH_BLOCK", 16)
    mp.setenv("RENE_QUAD_FUSE", "0")
    for k in JAX_ENV_OFF:
        mp.delenv(k, raising=False)
    return pp


def _buffers(src):
    return build_device_scene(create_scene(parse_pbrt(src), "/tmp"))


@pytest.mark.parametrize("name,seed", [("materials", 7), ("mesh", 7),
                                       ("fog", 7)])
def test_plain_sobol_matches_interpret_megakernel(name, seed):
    with pytest.MonkeyPatch.context() as mp:
        pp = _jax_env(mp)
        bn, cfg = _buffers(scenes.with_sampler(SCENES[name]()))
        assert cfg.sampler == "sobol"
        run = pp.make_pallas_batch_fn(bn, cfg, interpret=True)
        res = run(seed, SPP)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    assert tabs["sobol"] and tabs["volpath"] == (name == "fog")
    assert tabs["has_accel"] == (name == "mesh")
    out = M.path_lanes_ref(tabs, seed, SPP).numpy()
    assert np.isfinite(out).all()
    ref = np.concatenate([np.array(res[k]).T for k in
                          ("radiance", "normal", "albedo")])
    a = checks.agreement(out[:9], ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.99, a
    assert a["mean_rel"] <= 1e-3, a
    w = cfg.film.xresolution
    lane_pix = (run.py_host.astype(np.int64) * w
                + run.px_host.astype(np.int64)).reshape(-1)
    rays = float(out[9][lane_pix].sum())
    jax_rays = float(res["rays"])
    assert abs(rays - jax_rays) <= 1e-3 * jax_rays, (rays, jax_rays)
    # the independent sampler traces other paths from the same seed
    ind = M.path_lanes_ref(dict(tabs, sobol=False), seed, SPP).numpy()
    assert checks.agreement(ind[:9], ref)["rad_frac"] < 0.9


def test_sobol_render_beats_independent():
    """The reference's Sobol claim on its own scene at 16x16: mean
    absolute pixel error against a 512-spp independent render, Sobol at
    32 spp below 0.85x independent at 32 spp; image means within 5% of
    each other. Through the kernel wrapper on the CPU (the plain
    version), which counts no launch."""
    bn, cfg = _buffers(scenes.sobol_test_scene(16, 16))
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    ind_tabs = dict(tabs, sobol=False)
    before = dict(kernels.launches)
    ref = kernels.mega_path(ind_tabs, 11, 512)[0:3] / 512
    sob = kernels.mega_path(tabs, 5, 32)[0:3] / 32
    ind = kernels.mega_path(ind_tabs, 5, 32)[0:3] / 32
    assert kernels.launches == before
    err_s = float((sob - ref).abs().mean())
    err_i = float((ind - ref).abs().mean())
    assert err_s < 0.85 * err_i, (err_s, err_i)
    assert abs(float(sob.mean()) / float(ref.mean()) - 1.0) < 0.05


def test_cli_sampler_flag(tmp_path):
    """`--sampler sobol` turns an independent scene's render into the
    Sobol render of the same scene with `Sampler "sobol"`, on the CPU and
    through both engines; `--sampler independent` turns it back."""
    from rene_tpu_torch import cli
    from rene_tpu_torch.utils.film import read_png
    plain = tmp_path / "plain.pbrt"
    plain.write_text(scenes.cornell_box(16, 8))
    sob = tmp_path / "sob.pbrt"
    sob.write_text(scenes.with_sampler(scenes.cornell_box(16, 8)))
    imgs = {}
    for engine in ("pallas", "wave"):
        for tag, path, flag in (("flag", plain, "sobol"),
                                ("scene", sob, "auto"),
                                ("off", sob, "independent"),
                                ("ind", plain, "auto")):
            out = tmp_path / f"{engine}_{tag}.png"
            assert cli.main([str(path), "--device", "cpu", "--spp", "2",
                             "--engine", engine, "--sampler", flag,
                             "--output", str(out)]) == 0
            imgs[engine, tag] = read_png(str(out))
        assert np.array_equal(imgs[engine, "flag"], imgs[engine, "scene"])
        assert np.array_equal(imgs[engine, "off"], imgs[engine, "ind"])
        assert not np.array_equal(imgs[engine, "flag"], imgs[engine, "ind"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["materials_scene", "mesh_materials_scene",
                                  "fog_scene"])
def test_sobol_kernel_on_card_matches_plain_version(name):
    """On a CUDA card: the Sobol instance of the scene's megakernel
    variant against its plain version at 128x64 x 4 spp, at the card's
    limits (chip_smoke.py runs the same check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    src = scenes.with_sampler(getattr(scenes, name)(128, 64))
    tabs = M.device_tables(P.pack_tables(*_buffers(src)), "cuda")
    before = dict(kernels.launches)
    out = kernels.mega_path(tabs, 1234567, 4)
    ref = M.path_lanes_ref(dict(tabs), 1234567, 4)
    torch.cuda.synchronize()
    variant = kernels.variant(tabs)
    assert variant.endswith("_sobol")
    assert kernels.launches[variant] == before[variant] + 1
    checks.check_card(checks.agreement(out.cpu(), ref.cpu()),
                      f"{name} sobol 128x64 x 4 spp")
