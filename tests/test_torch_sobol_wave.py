"""Sobol waves (K-sobol in K2 and K3) against the JAX wave engine.

The plain wave engine (rene_tpu_torch/integrators/wave.py) on `Sampler
"sobol"` scenes against rene_tpu's `make_pallas_wave_fn(...,
interpret=True, init_mode="kernel")`, per pixel, by the rule of
test_torch_wave.py (>= 99.5% of pixels' radiance, >= 99% of their normal
and albedo sums, image means within 1e-3, ray totals within 0.1%):

* the eight materials at 32x16, a whole wave (spw 2) and a partial one
  (2 samples of spw 3: the slot-2 lanes want none, and the sample index
  scum + smp of each lane follows base 0, rem 2). A path Sobol lane draws
  nothing from its stream, so the port's default "mixed" streams agree
  with the JAX interpret-mode streams here;
* `fog_scene` at 16x16 (volpath): the medium, phase and scatter-point
  emitter draws stay on the stream, so the port runs the JAX streams
  ("jax").

Then, on the port alone: sorted (`gather`, `dma`) and unsorted Sobol
waves give the same film bit for bit; and a path Sobol wave traces the
megakernel's paths (the same pairs at the same sample indices, where the
film lies in the megakernel's first grid step and both take one seed).
The JAX side runs the schedule (2,): one interpret-mode compile.
"""
import numpy as np
import pytest
import torch

from rene_tpu_torch import checks, kernels, scenes
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.integrators import wave as WV
from rene_tpu_torch.pbrt import parse_pbrt
from rene_tpu_torch.scene import build_device_scene, create_scene
from .test_torch_wave import JAX_ENV_OFF, _film

torch.set_num_threads(2)

SCENES = {
    "materials": lambda: scenes.materials_scene(32, 16),
    "fog": lambda: scenes.fog_scene(16, 16),
}
SCHEDULE = (2,)


def _buffers(name):
    return build_device_scene(create_scene(parse_pbrt(
        scenes.with_sampler(SCENES[name]())), "/tmp"))


def _jax_env(mp):
    from rene_tpu.integrators import pallas_path as pp
    mp.setattr(pp, "CLUSTER", 16)
    mp.setattr(pp, "SPH_BLOCK", 16)
    mp.setenv("RENE_QUAD_FUSE", "0")
    for k in JAX_ENV_OFF:
        mp.delenv(k, raising=False)


@pytest.mark.parametrize("name,spw,want,stream", [
    ("materials", 2, 2, "mixed"), ("materials", 3, 2, "mixed"),
    ("fog", 2, 2, "jax")], ids=["path", "path_partial", "volpath"])
def test_sobol_wave_matches_jax(monkeypatch, name, spw, want, stream):
    from rene_tpu.integrators.pallas_wave import make_pallas_wave_fn
    _jax_env(monkeypatch)
    bn, cfg = _buffers(name)
    assert cfg.sampler == "sobol"
    jrun = make_pallas_wave_fn(bn, cfg, interpret=True, samples_per_wave=spw,
                               init_mode="kernel", sort_mode="gather",
                               sort_gran=1, k_schedule=SCHEDULE)
    port = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=spw,
                           k_schedule=SCHEDULE, stream=stream)
    assert port.tabs["sobol"]
    ref = jrun(7, want)
    out = port(7, want)
    a = checks.agreement(_film(out), _film(ref))
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.99, a
    assert a["mean_rel"] <= 1e-3, a
    assert abs(out["rays"] - ref["rays"]) <= 1e-3 * ref["rays"], \
        (out["rays"], ref["rays"])


@pytest.mark.parametrize("name", list(SCENES))
def test_sobol_sorts_move_lanes_only(name):
    """Sorted (`gather` and `dma`) and unsorted Sobol waves: equal films
    bit for bit, equal ray totals."""
    bn, cfg = _buffers(name)
    outs = [WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2, **kw)(5, 2)
            for kw in ({}, {"sort_rays": False}, {"sort_mode": "dma"})]
    for o in outs[1:]:
        np.testing.assert_array_equal(_film(o), _film(outs[0]))
        assert o["rays"] == outs[0]["rays"] > 0


def test_path_sobol_wave_traces_the_megakernel_paths():
    """A Sobol path wave of `want` samples draws each pixel's samples 0 ..
    want - 1 under the wave seed's pixel keys: on a film inside the
    megakernel's first grid step (seed + 0 * 65537), the megakernel's
    chunk of the same seed traces the same paths, per pixel to float
    summation order, with the same ray total."""
    bn, cfg = _buffers("materials")
    wave = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=3)(9, 3)
    mega = M.make_mega_batch_fn(bn, cfg, "cpu")(9, 3)
    a = checks.agreement(_film(wave), _film(mega))
    assert a["rad_frac"] == 1.0 and a["aov_frac"] == 1.0, a
    assert wave["rays"] == float(mega["rays"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_sobol_wave_kernels_on_card_match_plain_version(name):
    """On a CUDA card: the Sobol instances of K3 and of the scene's K2
    variant against their plain versions, then whole waves at spw 4 and
    a partial wave (3 of spw 4) against the plain runner, at the card's
    limits (chip_smoke.py runs the same check at 128x64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    bn, cfg = _buffers(name)
    card = WV.make_wave_fn(bn, cfg, "cuda", samples_per_wave=4)
    plain = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=4)
    before = dict(kernels.launches)
    s_k = card.init_state(11, 3)
    s_p = plain.init_state(11, 3)
    torch.testing.assert_close(s_k.cpu(), s_p, rtol=0, atol=1e-5)
    card.kernel_step(2, s_k, 11, 0, card.n_pad // WV.W_TILE, 3)
    plain.kernel_step(2, s_p, 11, 0, plain.n_pad // WV.W_TILE, 3)
    torch.cuda.synchronize()
    variant = kernels.variant(card.tabs, "wave_path")
    assert variant.endswith("_sobol")
    assert kernels.launches[variant] == before[variant] + 1
    assert kernels.launches["wave_genesis_sobol"] \
        == before["wave_genesis_sobol"] + 1
    ok = ((s_k.cpu() - s_p).abs() <= checks.RAD_ATOL
          + checks.RAD_RTOL * s_p.abs()).all(0)
    assert ok.double().mean() >= checks.CARD_FRAC
    for want in (4, 3):
        a = checks.agreement(_film(card(11, want)), _film(plain(11, want)))
        checks.check_card(a, f"{name} sobol wave {want} of spw 4")
