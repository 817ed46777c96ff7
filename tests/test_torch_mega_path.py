"""The path megakernel's plain version against the JAX megakernel.

`path_lanes_ref` vs rene_tpu's megakernel run in interpret mode
(`make_pallas_batch_fn(..., interpret=True)`, parallelogram fusion off as
the port never fuses), per pixel, on 128x64 films (exactly one 8192-lane
TPU tile, so the ray counts compare without padding lanes) and a 256x64
film (two full tiles: the per-tile seed term and the lane layout past
the first tile). Both draw the same xorshift32 stream, so every lane
traces the same paths; the two backends' float32 math differs in the
last ulp (XLA contracts some multiply-adds, its sin/cos/exp are its
own), and a rare lane crosses a
branch the other way (a grazing sphere hit, a Russian-roulette draw at
the threshold) and then follows another path. Per-pixel rule as in
rene_tpu_torch.checks; limits: >= 99.5% of pixels' radiance and >= 99%
of their normal and albedo sums agree, image means within 1e-3 relative,
ray totals within 0.1%. Measured over the six cases: radiance >= 99.90%,
AOV >= 99.66%, image means within 3.1e-4.
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

torch.set_num_threads(2)

SPP = 2


def _lights_only(w, h):
    """No area lights (so no emitter MIS draws) and maxdepth 5 (so no
    Russian roulette): the other branch of both stream-contract switches."""
    return scenes.materials_scene(w, h).replace(
        '"integer maxdepth" [ 16 ]', '"integer maxdepth" [ 5 ]').replace(
        'AreaLightSource', '# AreaLightSource')


def _buffers(name, width=128):
    src = (_lights_only if name == "lights_only"
           else getattr(scenes, name))(width, 64)
    return build_device_scene(create_scene(parse_pbrt(src), "/tmp"))


@pytest.fixture(scope="module")
def jax_runs():
    """Interpret-mode megakernel runners, one per (scene, film width),
    each compiled at its first call."""
    from rene_tpu.integrators.pallas_path import make_pallas_batch_fn
    runs = {}

    def get(name, width):
        if (name, width) not in runs:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("RENE_QUAD_FUSE", "0")
                bn, cfg = _buffers(name, width)
                runs[name, width] = (bn, cfg, make_pallas_batch_fn(
                    bn, cfg, interpret=True))
        return runs[name, width]
    return get


@pytest.mark.parametrize("name,width,seed", [
    ("cornell_box", 128, 7), ("cornell_box", 128, 1234567),
    ("materials_scene", 128, 7), ("materials_scene", 128, 1234567),
    ("lights_only", 128, 7), ("materials_scene", 256, 7)])
def test_plain_version_matches_interpret_megakernel(jax_runs, name, width,
                                                    seed, monkeypatch):
    # the JAX kernel reads the microfacet switch when it traces, at its
    # first call; pin it to GGX whatever an earlier test left in os.environ
    monkeypatch.delenv("RENE_MF_DIST", raising=False)
    bn, cfg, run = jax_runs(name, width)
    res = run(seed, SPP)
    ref = np.concatenate([np.asarray(res[k]).T for k in
                          ("radiance", "normal", "albedo")])
    assert ref.shape == (9, width * 64)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    out = M.path_lanes_ref(tabs, seed, SPP).numpy()
    a = checks.agreement(out[:9], ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.99, a
    assert a["mean_rel"] <= 1e-3, a
    jax_rays = float(res["rays"])
    assert abs(out[9].sum() - jax_rays) <= 1e-3 * jax_rays
    assert np.isfinite(out).all()


@pytest.mark.cuda
def test_kernel_on_card_matches_plain_version():
    """On a CUDA card: the kernel against its plain version, materials
    scene, 4 spp, at the card's limits (chip_smoke.py phase 3 runs the same
    check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    bn, cfg = _buffers("materials_scene")
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cuda")
    out = kernels.mega_path(tabs, 1234567, 4)
    ref = M.path_lanes_ref(tabs, 1234567, 4)
    torch.cuda.synchronize()
    a = checks.agreement(out.cpu(), ref.cpu())
    checks.check_card(a, "materials 128x64 x 4 spp")
