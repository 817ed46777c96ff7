"""Volpath waves (K2's volpath bounce, slice K1e) against the JAX wave
engine.

The plain wave runner (`integrators/wave.py make_wave_fn` on volpath
tables: `wave_step_ref` running volpath.bounce_vol, the medium in state
row WROW_MED) against rene_tpu's `make_pallas_wave_fn(...,
interpret=True, init_mode="kernel")` on its volpath waves
(`wave_bounce_vol`, pallas_path.py:5277-5565), with the JAX
interpret-mode lane streams ("jax"), per pixel: `fog_scene` at 16x16 and
the small `fog_mesh_scene` at 32x32 cut to maxdepth 8 (its depth 64 runs
in tests/test_torch_volpath.py), spw 2, schedule (2,) on both sides
(each distinct k is one more interpret-mode compile). Limits as in
test_torch_wave.py: >= 99.5% of pixels' radiance and >= 99% of their
normal and albedo sums agree, image means within 1e-3 relative, ray
totals within 0.1%. Measured: 100% / 100%, means within 1.0e-7, equal
ray totals.

Sorting only moves lanes: a volpath wave sorted by `gather` (which moves
the medium row with rows [0, 21)) and by `dma` (through K4's plain
version, `permute_ref`) equals the unsorted wave bit for bit, as
tests/test_wave.py:262 holds the JAX engine's.
"""
import numpy as np
import pytest
import torch

from rene_tpu_torch import checks, kernels, scenes
from rene_tpu_torch.integrators import wave as WV
from rene_tpu_torch.pbrt import parse_pbrt
from rene_tpu_torch.scene import build_device_scene, create_scene

torch.set_num_threads(2)

SCHEDULE = (2,)
JAX_ENV_OFF = ("RENE_MF_DIST", "RENE_MEGA_PACK", "RENE_MESH_TEST",
               "RENE_CONST_DIR", "RENE_SPH_ANY", "RENE_SUB_TRIS",
               "RENE_SUB_GATE", "RENE_CLUSTER_ORDER", "RENE_WAVE_GRAN",
               "RENE_WAVE_INIT", "RENE_WAVE_SORT", "RENE_WAVE_SUB_GATE",
               "RENE_WAVE_DMA_FULL", "RENE_WAVE_PROFILE", "RENE_ENV_NEE")
SCENES = {"fog": lambda: scenes.fog_scene(16, 16),
          "fog_mesh": lambda: scenes.fog_mesh_scene(32, 32, maxdepth=8,
                                                    small=True)}


def _buffers(name):
    return build_device_scene(create_scene(parse_pbrt(SCENES[name]()),
                                           "/tmp"))


def _film(out):
    return np.concatenate([np.asarray(out[k]).T
                           for k in ("radiance", "normal", "albedo")])


@pytest.mark.parametrize("name", list(SCENES))
def test_volpath_wave_matches_jax(monkeypatch, name):
    from rene_tpu.integrators import pallas_path as pp
    from rene_tpu.integrators.pallas_wave import make_pallas_wave_fn
    monkeypatch.setattr(pp, "CLUSTER", 16)
    monkeypatch.setattr(pp, "SPH_BLOCK", 16)
    monkeypatch.setenv("RENE_QUAD_FUSE", "0")
    for k in JAX_ENV_OFF:
        monkeypatch.delenv(k, raising=False)
    bn, cfg = _buffers(name)
    jrun = make_pallas_wave_fn(bn, cfg, interpret=True, samples_per_wave=2,
                               init_mode="kernel", sort_mode="gather",
                               sort_gran=1, k_schedule=SCHEDULE)
    port = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2,
                           k_schedule=SCHEDULE, stream="jax")
    assert port.tabs["volpath"] and port.n_pad == jrun.n_pad
    seed = 7
    ref = jrun(seed, 2)
    out = port(seed, 2)
    a = checks.agreement(_film(out), _film(ref))
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.99, a
    assert a["mean_rel"] <= 1e-3, a
    assert abs(out["rays"] - float(ref["rays"])) \
        <= 1e-3 * float(ref["rays"]), (out["rays"], float(ref["rays"]))


@pytest.mark.parametrize("name", list(SCENES))
def test_sorted_volpath_waves_equal_unsorted(name):
    """`gather` and `dma` sorts of a volpath wave against the unsorted
    wave: films and ray totals equal bit for bit; the medium row follows
    its lane (a lane left in the wrong medium would trace another
    path)."""
    bn, cfg = _buffers(name)
    for mode in ("gather", "dma"):
        outs = [WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2,
                                sort_mode=mode, sort_rays=s)(5, 2)
                for s in (True, False)]
        np.testing.assert_array_equal(_film(outs[0]), _film(outs[1]))
        assert outs[0]["rays"] == outs[1]["rays"] > 0


def test_medium_row_starts_in_vacuum_and_moves():
    """K3's plain version starts every lane in vacuum (row WROW_MED is
    0); after a launch some lanes are in the fog (medium 1); a `gather`
    sort moves the row with its lane, as it moves the lane ids."""
    bn, cfg = _buffers("fog")
    run = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=2)
    state = run.init_state(3, 2)
    assert not state[WV.WROW_MED].any()
    run.kernel_step(2, state, 3, 0, run.n_pad // WV.W_TILE, 2)
    med = state[WV.WROW_MED].clone()
    assert set(med.unique().tolist()) == {0.0, 1.0}
    lane = WV.lane_ids(state)
    assert torch.equal(lane, torch.arange(run.n_pad))
    state = run.sort_prefix(state, run.n_pad)
    moved = WV.lane_ids(state)
    assert not torch.equal(moved, lane)
    assert torch.equal(moved.sort().values, lane)
    assert torch.equal(state[WV.WROW_MED], med[moved])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_volpath_wave_kernels_on_card_match_plain_version(name):
    """On a CUDA card: one K2 launch of the volpath variant against its
    plain version lane for lane, then whole waves at spw 4 against the
    plain runner, at the card's limits (chip_smoke.py phase 16 runs the
    same check at 128x64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    bn, cfg = _buffers(name)
    card = WV.make_wave_fn(bn, cfg, "cuda", samples_per_wave=4)
    plain = WV.make_wave_fn(bn, cfg, "cpu", samples_per_wave=4)
    s_k = card.init_state(11, 4)
    s_p = plain.init_state(11, 4)
    before = dict(kernels.launches)
    card.kernel_step(2, s_k, 11, 0, card.n_pad // WV.W_TILE, 4)
    plain.kernel_step(2, s_p, 11, 0, plain.n_pad // WV.W_TILE, 4)
    torch.cuda.synchronize()
    variant = kernels.variant(card.tabs, "wave_path")
    assert variant.startswith("wave_volpath")
    assert kernels.launches[variant] == before[variant] + 1
    ok = ((s_k.cpu() - s_p).abs() <= checks.RAD_ATOL
          + checks.RAD_RTOL * s_p.abs()).all(0)
    assert ok.double().mean() >= checks.CARD_FRAC
    a = checks.agreement(_film(card(11, 4)), _film(plain(11, 4)))
    checks.check_card(a, f"{name} volpath wave spw 4")
