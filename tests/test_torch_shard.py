"""Multi-device renders of the port (rene_tpu_torch/parallel/shard.py) on
CPU ranks over gloo, against rene_tpu.parallel.shard on meshes of the
same size drawn from the virtual CPU devices of tests/conftest.py, on the
scenes of tests/test_parallel.py.

* The XLA engine in samples mode (spp 5 on two ranks gives 6) and in
  tiles mode on the ragged 31x21 film, and the megakernel in samples mode
  against the reference's interpret-mode megakernel (on a film of one
  whole 8192-lane tile, since its rays count the tile's lanes past the
  film), per pixel by
  `checks.agreement`'s rule: radiance on >= 99.5% of the pixels, normal
  and albedo on >= 99%, image means within 1e-3, ray totals within 0.1%,
  equal `effective_spp`. The reference scales the rays of a ragged tile
  batch's padding away (shard.py:262); the port counts its pixels'.
* Tiles mode equals the single-device render of the same seed bit for
  bit, `varmean` included.
* The wave engine in samples mode: bit for bit the sum of the single-rank
  runs at the shifted seeds (`rank_chunks`), `varmean` the one formed on
  the host from them; its mean within rtol 0.1 of the XLA engine's, the
  reference's own check (the CUDA waves' "mixed" streams are not JAX's).
* The seed arithmetic, int32 and uint32 wraps at 8 ranks, against the
  reference's expressions in jax.numpy; the ranks' runners pass them.
* The CLI: every flag of the reference's passed on or refused under
  `--devices > 1` (`--bvh`, `--tile-rays`, `--mf-dist`, `--denoiser`,
  `--sampler`, `--scene-overrides` and `--tungsten-compat` reach the
  ranks; `--checkpoint`, `--resume` and `--engine wave
  --multichip-mode tiles` are refused with a message), both modes write
  their PNGs, `--devices 2 --device cuda` without cards and
  `--dump-module` on the CPU or for an XLA-engine scene exit 1.

Each render spawns its ranks (a few seconds each), so the renders are
module fixtures that several tests read. `pytest -s` prints each
agreement; PERF.md quotes them.
"""
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rene_tpu.parallel import shard as RS
from rene_tpu.pbrt import parse_pbrt as r_parse
from rene_tpu.scene import create_scene as r_create
from rene_tpu_torch import checks, cli, kernels, scenes
from rene_tpu_torch import render as PR
from rene_tpu_torch.parallel import shard as S
from rene_tpu_torch.pbrt import parse_pbrt
from rene_tpu_torch.scene import create_scene, load_scene
from rene_tpu_torch.scene import overrides as OV
from rene_tpu_torch.utils.film import read_png

from .test_parallel import MAXD_SRC, SRC

torch.set_num_threads(2)

WORLD = 2
RAGGED_SRC = SRC.replace("[32]", "[31]").replace("[24]", "[21]")
# the JAX megakernel's rays count the lanes of its 8192-lane tiles past the
# film's end: its film is one whole tile
TILED_SRC = MAXD_SRC.replace("[32]", "[128]").replace("[24]", "[64]")
RAD_FRAC, AOV_FRAC, MEAN_REL, RAYS_REL = 0.995, 0.99, 1e-3, 1e-3


def port_scene(src):
    return create_scene(parse_pbrt(src), "/tmp")


def ref_scene(src):
    return r_create(r_parse(src), "/tmp")


def cpu_mesh():
    return S.make_mesh(["cpu"] * WORLD)


def ref_mesh():
    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} virtual devices")
    return RS.make_mesh(jax.devices()[:WORLD])


def rows(out):
    """(9, N) per-pixel sums of a render's averaged images."""
    n = out["effective_spp"]
    return np.concatenate([(np.asarray(out[k]).reshape(-1, 3) * n).T
                           for k in ("color", "normal", "albedo")])


def assert_agree(got, want, what):
    a = checks.agreement(rows(got), rows(want))
    print(f"{what}: radiance {a['rad_frac']:.5f}, AOV {a['aov_frac']:.5f}, "
          f"mean_rel {a['mean_rel']:.3g}, rays {got['total_rays']:.0f} / "
          f"{want['total_rays']:.0f}, effective spp "
          f"{got['effective_spp']} / {want['effective_spp']}")
    assert got["effective_spp"] == want["effective_spp"], what
    assert a["rad_frac"] >= RAD_FRAC, (what, a)
    assert a["aov_frac"] >= AOV_FRAC, (what, a)
    assert a["mean_rel"] <= MEAN_REL, (what, a)
    assert abs(got["total_rays"] - want["total_rays"]) \
        <= RAYS_REL * want["total_rays"], what


@pytest.fixture(scope="module")
def xla_samples():
    kw = dict(spp=5, seed=0, mode="samples", engine="xla")
    return (S.render_multichip(port_scene(SRC), mesh=cpu_mesh(), **kw),
            RS.render_multichip(ref_scene(SRC), mesh=ref_mesh(), **kw))


@pytest.fixture(scope="module")
def xla_tiles():
    kw = dict(spp=2, seed=3, mode="tiles", engine="xla")
    return (S.render_multichip(port_scene(RAGGED_SRC), mesh=cpu_mesh(),
                               **kw),
            RS.render_multichip(ref_scene(RAGGED_SRC), mesh=ref_mesh(),
                                **kw))


@pytest.fixture(scope="module")
def mega_samples():
    kw = dict(spp=4, seed=0, mode="samples", engine="pallas")
    return (S.render_multichip(port_scene(TILED_SRC), mesh=cpu_mesh(),
                               **kw),
            RS.render_multichip(ref_scene(TILED_SRC), mesh=ref_mesh(),
                                **kw))


@pytest.fixture(scope="module")
def mega_tiles():
    kw = dict(spp=4, seed=5, engine="pallas", want_var=True)
    return (S.render_multichip(port_scene(MAXD_SRC), mesh=cpu_mesh(),
                               mode="tiles", **kw),
            PR.render(port_scene(MAXD_SRC), device="cpu", **kw))


@pytest.fixture(scope="module")
def wave_samples():
    return S.render_multichip(port_scene(MAXD_SRC), spp=5, seed=1,
                              mesh=cpu_mesh(), mode="samples",
                              engine="wave", want_var=True)


def test_xla_samples_match_reference(xla_samples):
    got, want = xla_samples
    assert got["engine"] == "xla" and got["effective_spp"] == 6
    assert got["backend"] == "gloo" and got["launches"] == 0
    assert got["color"].shape == want["color"].shape == (24, 32, 3)
    assert_agree(got, want, "xla samples")


def test_xla_tiles_ragged_match_reference(xla_tiles):
    got, want = xla_tiles
    assert got["color"].shape == (21, 31, 3) and got["effective_spp"] == 2
    assert [r["pixels"] for r in got["ranks"]] == [[0, 326], [326, 651]]
    assert_agree(got, want, "xla tiles, 31x21")


def test_mega_samples_match_reference(mega_samples):
    got, want = mega_samples
    assert got["engine"] == "pallas" and got["effective_spp"] == 4
    assert [r["done"] for r in got["ranks"]] == [2, 2]
    assert_agree(got, want, "megakernel samples")


def test_mega_tiles_equal_single_device(mega_tiles):
    got, single = mega_tiles
    for k in ("color", "normal", "albedo", "varmean"):
        assert np.array_equal(got[k], single[k]), k
    assert got["total_rays"] == single["total_rays"]
    assert got["effective_spp"] == 4 and np.isfinite(got["varmean"]).all()
    print(f"megakernel tiles: equal to the single-device render bit for "
          f"bit, {got['total_rays']:.0f} rays")


def test_wave_samples_sum_of_single_rank_runs(wave_samples):
    """The film is the host's sum of each rank's run at its shifted seeds
    over the samples of all ranks, bit for bit, `varmean` from every
    rank's chunks; its mean within rtol 0.1 of the XLA engine's."""
    got = wave_samples
    config = got["config"]
    bn, cfg = S.build_device_scene(port_scene(MAXD_SRC))
    parts = [S.rank_chunks(bn, cfg, "cpu", "wave", 5, 1, "samples", r,
                           WORLD, want_var=True)[0] for r in range(WORLD)]
    host = {k: sum(p.accum[k] for p in parts).numpy()
            for k in parts[0].accum}
    sq = sum(p.sq_sum for p in parts).numpy()
    done = sum(p.done for p in parts)
    want = PR.film_result(config, host, sq, done,
                          sum(p.seeds for p in parts))
    assert got["effective_spp"] == done == 6
    for k in ("color", "normal", "albedo", "varmean"):
        assert np.array_equal(got[k], want[k]), k
    assert got["total_rays"] == sum(p.total_rays for p in parts)
    xla = PR.render(port_scene(MAXD_SRC), spp=16, seed=2, device="cpu",
                    engine="xla")
    np.testing.assert_allclose(got["color"].mean(axis=(0, 1)),
                               xla["color"].mean(axis=(0, 1)), rtol=0.1)


@pytest.mark.parametrize("runner", ["xla", "pallas", "wave"])
def test_seed_arithmetic_matches_reference(runner):
    """device_seed at 8 ranks against the reference's expressions (uint32
    for the XLA engine, int32 for the kernels) on seeds that wrap."""
    seeds = [0, 1, 12345, 2 ** 31 - 1, 2 ** 31 - 5]
    if runner == "xla":
        seeds += [2 ** 31, 2 ** 32 - 1]
    for s in seeds:
        for idx in range(8):
            if runner == "xla":
                i = jnp.uint32(idx)
                ref = jnp.uint32(s) ^ (i * jnp.uint32(0x9E3779B9)
                                       + jnp.uint32(1))
            else:
                mul = 0x3779B1 if runner == "pallas" else 1000003
                ref = jnp.int32(s) + jnp.int32(idx) * jnp.int32(mul)
            assert S.device_seed({"pallas": "megakernel"}.get(runner, runner),
                                 s, idx) == int(ref), (s, idx)


def test_rank_runners_pass_shifted_seeds(monkeypatch):
    """Rank 7 of 8 runs device_seed of every chunk seed (the megakernel's
    wraps negative), and a wrapped seed renders as its uint32 value; the
    pixel shares cover the film once."""
    bn, cfg = S.build_device_scene(port_scene(MAXD_SRC))
    seen = []
    real = kernels.mega_path

    def spy(tabs, seed, *a, **k):
        seen.append(seed)
        return real(tabs, seed, *a, **k)
    monkeypatch.setattr(kernels, "mega_path", spy)
    run, spp_r = S.rank_runner(bn, cfg, "cpu", "megakernel", 9, "samples",
                               7, 8)
    assert spp_r == 2       # ceil(9 / 8) samples a rank
    s = 2 ** 31 - 5
    a = run(s, 1)
    assert seen == [int(jnp.int32(s) + jnp.int32(7) * jnp.int32(0x3779B1))]
    assert seen[0] < 0
    from rene_tpu_torch.integrators.mega_path import make_mega_batch_fn
    b = make_mega_batch_fn(bn, cfg, "cpu")(seen[0] + 2 ** 32, 1)
    for k in ("radiance", "normal", "albedo"):
        assert torch.equal(a[k], b[k]), k
    shares = S.pixel_shares(31 * 21, 8)
    assert shares[0][0] == 0 and shares[-1][1] == 31 * 21
    assert all(x[1] == y[0] for x, y in zip(shares, shares[1:]))


@pytest.fixture
def box(tmp_path):
    p = tmp_path / "box.pbrt"
    p.write_text(scenes.cornell_box(16, 12))
    return p


@pytest.fixture
def multichip(monkeypatch):
    """The results of every render_multichip the CLI starts."""
    calls = []
    real = S.render_multichip

    def spy(scene, **kw):
        out = real(scene, **kw)
        calls.append((kw, out))
        return out
    monkeypatch.setattr(S, "render_multichip", spy)
    return calls


def test_cli_tiles_pass_bvh_tile_rays_mf_dist(box, tmp_path, multichip,
                                              monkeypatch):
    monkeypatch.delenv("RENE_MF_DIST", raising=False)
    png = tmp_path / "t.png"
    rc = cli.main([str(box), "--device", "cpu", "--devices", "2",
                   "--multichip-mode", "tiles", "--engine", "xla",
                   "--bvh", "on", "--tile-rays", "40", "--spp", "2",
                   "--mf-dist", "beckmann", "--output", str(png),
                   "--aov-normal", str(tmp_path / "n.png"),
                   "--aov-albedo", str(tmp_path / "a.png")])
    assert rc == 0
    (kw, out), = multichip
    assert kw["mode"] == "tiles" and kw["use_bvh"] is True
    assert kw["tile_rays"] == 40 and kw["mesh"].size == 2
    for r in out["ranks"]:
        lo, hi = r["pixels"]
        assert r["bvh"] is True and r["tiles"] == -(-(hi - lo) // 40)
        assert r["mf_dist"] == "beckmann"
    for p in ("t.png", "n.png", "a.png"):
        assert read_png(str(tmp_path / p)).shape == (12, 16, 3)


@pytest.mark.parametrize("flag", ["--scene-overrides", "--tungsten-compat"])
def test_cli_tiles_pass_sampler_and_overrides(box, tmp_path, multichip,
                                              monkeypatch, flag):
    """--sampler and an override file (given, or found by
    --tungsten-compat) reach the ranks: the tiles film equals the
    single-device render of the scene they make, and not the scene's
    own."""
    spec = {"settings": {"max_depth": 2},
            "instances": [{"index": 0, "matte_kd": [0.2, 0.7, 0.2]}]}
    cal = tmp_path / "cal"
    cal.mkdir()
    ov = cal / "box_tungsten_png.json"
    ov.write_text(json.dumps(spec))
    monkeypatch.setattr(OV, "_OVERRIDES_DIR", str(cal))
    args = [flag] + ([str(ov)] if flag == "--scene-overrides" else [])
    rc = cli.main([str(box), "--device", "cpu", "--devices", "2",
                   "--multichip-mode", "tiles", "--engine", "pallas",
                   "--sampler", "sobol", "--spp", "2", "--seed", "4",
                   "--output", str(tmp_path / "o.png"), *args])
    assert rc == 0
    (kw, out), = multichip
    assert out["config"].sampler == "sobol" and out["engine"] == "pallas"
    scene = load_scene(str(box))
    plain = PR.render(scene, spp=2, seed=4, device="cpu", engine="pallas")
    scene.sampler = "sobol"
    OV.apply_overrides(scene, str(ov))
    want = PR.render(scene, spp=2, seed=4, device="cpu", engine="pallas")
    for k in ("color", "normal", "albedo"):
        assert np.array_equal(out[k], want[k]), k
    assert not np.array_equal(out["color"], plain["color"])


def test_cli_samples_pass_denoiser(box, tmp_path, multichip):
    png = tmp_path / "s.png"
    rc = cli.main([str(box), "--device", "cpu", "--devices", "2",
                   "--engine", "wave", "--spp", "4", "--seed", "3",
                   "--denoiser", "atrous", "--output", str(png)])
    assert rc == 0
    (kw, out), = multichip
    assert kw["want_var"] is True and kw["mode"] == "samples"
    assert kw["seed"] == 3 and out["engine"] == "wave"
    assert np.isfinite(out["varmean"]).all()
    assert out["effective_spp"] == 4
    assert read_png(str(png)).shape == (12, 16, 3)


@pytest.mark.parametrize("flags,message", [
    (["--checkpoint", "c.npz"], "keeps no checkpoint"),
    (["--checkpoint", "c.npz", "--resume"], "keeps no checkpoint"),
    (["--engine", "wave", "--multichip-mode", "tiles"],
     "samples only"),
    (["--devices", "0"], "at least 1")])
def test_cli_refuses_flags_it_cannot_pass(box, caplog, flags, message):
    argv = [str(box), "--device", "cpu", "--spp", "1"]
    if "--devices" not in flags:
        argv += ["--devices", "2"]
    with caplog.at_level(logging.ERROR, "rene_tpu_torch"):
        assert cli.main(argv + flags) == 1
    assert any(message in r.getMessage() for r in caplog.records)


def test_render_multichip_refuses(box):
    scene = load_scene(str(box))
    with pytest.raises(ValueError, match="samples mode only"):
        S.render_multichip(scene, 1, mesh=cpu_mesh(), mode="tiles",
                           engine="wave")
    with pytest.raises(ValueError, match="multichip mode"):
        S.render_multichip(scene, 1, mesh=cpu_mesh(), mode="rows")


def test_cli_cuda_devices_without_cards(box, caplog):
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are present")
    with caplog.at_level(logging.ERROR, "rene_tpu_torch"):
        assert cli.main([str(box), "--devices", "2", "--spp", "1"]) == 1
    assert any(r.getMessage() == f"--devices 2 requested but only "
               f"{torch.cuda.device_count()} present"
               for r in caplog.records)


def test_make_mesh_backends():
    assert S.make_mesh(["cpu", "cpu"]).backend == "gloo"
    assert S.make_mesh(["cuda:0", "cuda:1"]).backend == "nccl"
    assert S.make_mesh(["cuda:0", "cuda:0"]).backend == "gloo"
    assert S.make_mesh(["cuda"]).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="mixes"):
        S.make_mesh(["cpu", "cuda:0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.make_mesh()


def test_dump_module_refusals(box, tmp_path, caplog):
    with caplog.at_level(logging.ERROR, "rene_tpu_torch"):
        assert cli.main([str(box), "--dump-module", "--device", "cpu"]) == 1
    assert any("no module" in r.getMessage() for r in caplog.records)
    caplog.clear()
    p = tmp_path / "refused.pbrt"
    p.write_text(scenes.REFUSED["checker_metal"](tmp_path, 8, 4))
    with caplog.at_level(logging.ERROR, "rene_tpu_torch"):
        assert cli.main([str(p), "--dump-module"]) == 1
    assert any("XLA engine" in r.getMessage() for r in caplog.records)
