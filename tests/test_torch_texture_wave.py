"""The wave engine on textured scenes (slice K1b in K2).

`make_wave_fn` on the CPU (the plain `wave_step_ref`, whose bounce is the
megakernel's) against rene_tpu's `make_pallas_wave_fn(interpret=True,
init_mode="kernel")`, whole waves per pixel, on a textured scene with an
env-map background and an emitter (the `upick` branch of the light
sampling), the env scene without emitters and the small textured mesh, at
64x32 x spw 2 with the schedule (2,): one interpret-mode compile of the
wave kernel per scene. Limits as in test_torch_wave.py: >= 99.5% of
pixels' radiance, >= 99% of their normal and albedo sums, image means
within 1e-3, ray totals within 0.1%. Measured: radiance >= 99.95%, AOV >=
99.75% (the mesh; 100% on the other two), means within 8.2e-7, equal ray
totals.

jax and rene_tpu are imported inside the parity test, and the scenes go
through the port's own frontend, so that the `cuda` tests collect where
there is no jax: on a card they hold the megakernel and one K2 launch on
every textured scene to their plain versions, at the card's limits.
"""
import numpy as np
import pytest
import torch

from rene_tpu_torch import checks, kernels, scenes
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.integrators import wave as WV
from rene_tpu_torch.pbrt import parse_pbrt
from rene_tpu_torch.scene import build_device_scene, create_scene
from rene_tpu_torch.scene import pack as P

torch.set_num_threads(2)

JAX_ENV_OFF = ("RENE_MF_DIST", "RENE_MEGA_PACK", "RENE_MESH_TEST",
               "RENE_CONST_DIR", "RENE_SPH_ANY", "RENE_SUB_TRIS",
               "RENE_SUB_GATE", "RENE_CLUSTER_ORDER", "RENE_WAVE_GRAN",
               "RENE_WAVE_INIT", "RENE_WAVE_SORT", "RENE_WAVE_SUB_GATE",
               "RENE_WAVE_DMA_FULL", "RENE_WAVE_PROFILE", "RENE_IMG_PACK",
               "RENE_ENV_NEE", "RENE_ATTR_ELIDE", "RENE_MEGA_ABLATE")


def _buffers(name, directory, width=0, height=0):
    src = scenes.textured(name, directory, width, height)
    return build_device_scene(create_scene(parse_pbrt(src), str(directory)))


def _film(out):
    return np.concatenate([np.asarray(out[k]).T
                           for k in ("radiance", "normal", "albedo")])


@pytest.mark.parametrize("name", ["tex_image", "env", "textured_mesh"])
def test_wave_matches_jax(name, tmp_path, monkeypatch):
    from rene_tpu.integrators import pallas_path as pp
    from rene_tpu.integrators.pallas_wave import make_pallas_wave_fn
    monkeypatch.setattr(pp, "CLUSTER", 16)
    monkeypatch.setattr(pp, "SPH_BLOCK", 16)
    monkeypatch.setenv("RENE_QUAD_FUSE", "0")
    for k in JAX_ENV_OFF:
        monkeypatch.delenv(k, raising=False)
    bn, cfg = _buffers(name, tmp_path, 64, 32)
    jrun = make_pallas_wave_fn(bn, cfg, interpret=True, samples_per_wave=2,
                               init_mode="kernel", sort_mode="gather",
                               sort_gran=1, k_schedule=(2,))
    port = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2,
                           k_schedule=(2,), stream="jax")
    assert port.tabs["has_env"]
    assert port.tabs["has_accel"] == (name == "textured_mesh")
    ref = jrun(7, 2)
    out = port(7, 2)
    a = checks.agreement(_film(out), _film(ref))
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.99, a
    assert a["mean_rel"] <= 1e-3, a
    assert abs(out["rays"] - ref["rays"]) <= 1e-3 * ref["rays"], \
        (out["rays"], ref["rays"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(scenes.TEXTURED))
def test_kernels_on_card_match_plain_versions(name, tmp_path):
    """On a CUDA card: the megakernel (4 spp) and one K2 launch of two
    bounces on a textured scene against their plain versions
    (chip_smoke.py phase 13 runs whole waves too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    bn, cfg = _buffers(name, tmp_path)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cuda")
    before = dict(kernels.launches)
    out = kernels.mega_path(tabs, 1234567, 4)
    ref = M.path_lanes_ref(tabs, 1234567, 4)
    torch.cuda.synchronize()
    variant = kernels.variant(tabs)
    assert kernels.launches[variant] == before[variant] + 1
    checks.check_card(checks.agreement(out.cpu(), ref.cpu()),
                      f"{name} x 4 spp")
    run = WV.make_wave_fn(bn, cfg, "cuda", samples_per_wave=2)
    s0 = run.init_state(5, 2)
    s_k = kernels.wave_path(run.tabs, s0.clone(), 5, 0, 2, run.n_pad,
                            run.key_bounds, 1, 0)
    s_p = WV.wave_step_ref(run.tabs, s0.clone(), 5, 0, 2, run.n_pad,
                           run.key_bounds, 1, 0)
    ok = ((s_k - s_p).abs() <= checks.RAD_ATOL
          + checks.RAD_RTOL * s_p.abs()).all(0)
    ok &= s_k[WV.WROW_KEY].view(torch.int32) == s_p[WV.WROW_KEY].view(
        torch.int32)
    assert ok.double().mean() >= checks.CARD_FRAC, ok.double().mean()
