"""The port's CLI flags of rene_tpu/cli.py: --color-space, --mf-dist,
--scene-overrides, --tungsten-compat, --warm-cache, --checkpoint /
--resume and --denoiser / --unet-weights, on tiny inline scenes on the
CPU."""
import json
import logging
import os
from pathlib import Path

import numpy as np
import pytest

from rene_tpu.scene import load_scene as ref_load_scene
from rene_tpu.scene.device import build_device_scene as ref_build
from rene_tpu_torch import cli, scenes
from rene_tpu_torch import render as PR
from rene_tpu_torch.scene import build_device_scene, load_scene
from rene_tpu_torch.scene import overrides as OV
from rene_tpu_torch.utils.film import read_png

REPO = Path(__file__).resolve().parent.parent
UNET = REPO / "rene_tpu" / "models" / "weights" / "unet.msgpack"


@pytest.fixture
def box(tmp_path):
    p = tmp_path / "box.pbrt"
    p.write_text(scenes.cornell_box(12, 8))
    return p


@pytest.fixture
def seen(monkeypatch):
    """The scene and RENE_MF_DIST of every render the CLI starts."""
    calls = []
    real = PR.render

    def spy(scene, **kw):
        calls.append({"scene": scene, "mf": os.environ.get("RENE_MF_DIST"),
                      "kw": kw})
        return real(scene, **kw)
    monkeypatch.setattr(PR, "render", spy)
    return calls


def run(scene, tmp_path, *flags, out="o.png"):
    return cli.main([str(scene), "--device", "cpu", "--spp", "2",
                     "--output", str(tmp_path / out), *flags])


@pytest.mark.parametrize("space", ["srgb", "srgb-lights"])
def test_color_space(box, tmp_path, seen, space):
    """The device buffers of the reference's load_scene(color_space=)."""
    assert run(box, tmp_path, "--color-space", space) == 0
    got, _ = build_device_scene(seen[0]["scene"])
    want, _ = ref_build(ref_load_scene(str(box), color_space=space))
    linear, _ = ref_build(ref_load_scene(str(box)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any(not np.array_equal(want[k], linear[k]) for k in want)


@pytest.mark.parametrize("before", [None, "ggx"])
def test_mf_dist_is_restored(box, tmp_path, seen, monkeypatch, before):
    """--mf-dist and an override file's mf_dist hold for the render, and
    RENE_MF_DIST is as it was after main returns (fault (d))."""
    if before is None:
        monkeypatch.delenv("RENE_MF_DIST", raising=False)
    else:
        monkeypatch.setenv("RENE_MF_DIST", before)
    ov = tmp_path / "ov.json"
    ov.write_text(json.dumps({"settings": {"mf_dist": "beckmann"}}))
    assert run(box, tmp_path, "--mf-dist", "beckmann") == 0
    assert os.environ.get("RENE_MF_DIST") == before
    assert run(box, tmp_path, "--scene-overrides", str(ov)) == 0
    assert os.environ.get("RENE_MF_DIST") == before
    # the flag beats the file
    assert run(box, tmp_path, "--scene-overrides", str(ov), "--mf-dist",
               "ggx") == 0
    assert os.environ.get("RENE_MF_DIST") == before
    assert [c["mf"] for c in seen] == ["beckmann", "beckmann", "ggx"]


def test_tungsten_compat_requires_denoiser(box, tmp_path, seen, monkeypatch,
                                           caplog):
    """A calibration that declares `requires_denoiser` is skipped for a raw
    render and applied under --denoiser atrous."""
    cal = tmp_path / "cal"
    cal.mkdir()
    (cal / "box_tungsten_png.json").write_text(json.dumps({
        "settings": {"max_depth": 3}, "requires_denoiser": True}))
    monkeypatch.setattr(OV, "_OVERRIDES_DIR", str(cal))
    caplog.set_level(logging.INFO, "rene_tpu_torch")
    assert run(box, tmp_path, "--tungsten-compat") == 0
    assert seen[-1]["scene"].max_depth_hint != 3
    assert any("skipping for this raw render" in r.getMessage()
               for r in caplog.records)
    assert run(box, tmp_path, "--tungsten-compat", "--denoiser",
               "atrous") == 0
    assert seen[-1]["scene"].max_depth_hint == 3
    assert seen[-1]["kw"]["want_var"]
    assert any(r.getMessage().startswith("applied scene overrides")
               for r in caplog.records)


def test_warm_cache_renders_nothing(box, tmp_path, seen, caplog):
    caplog.set_level(logging.INFO, "rene_tpu_torch")
    for engine in ("pallas", "wave"):
        assert run(box, tmp_path, "--warm-cache", "--engine", engine) == 0
    assert not seen and not (tmp_path / "o.png").exists()
    assert any("warmed 0 kernel libraries" in r.getMessage()
               for r in caplog.records)


def test_runner_libraries(box):
    """The libraries a runner launches: the megakernel's instance, or K2's
    and the one of K3 and K4; none for the XLA engine."""
    bn, cfg = build_device_scene(load_scene(str(box)))
    assert PR.runner_libraries(bn, cfg) == ["mega_path"]
    assert PR.runner_libraries(bn, cfg, "pallas") == ["mega_path"]
    assert PR.runner_libraries(bn, cfg, "wave") == ["wave_path"]
    p = box.parent / "fog.pbrt"
    p.write_text(scenes.with_sampler(scenes.fog_mesh_scene(8, 4, 4,
                                                           small=True)))
    bn, cfg = build_device_scene(load_scene(str(p)))
    assert PR.runner_libraries(bn, cfg) == ["mega_volpath_mesh"]
    assert PR.runner_libraries(bn, cfg, "wave") == [
        "wave_path", "wave_volpath_mesh"]
    assert PR.runner_libraries(bn, cfg, "xla") == []


@pytest.mark.parametrize("engine", ["pallas", "wave"])
def test_checkpoint_resume_and_denoisers_end_to_end(box, tmp_path, engine):
    """--checkpoint / --resume and --denoiser atrous / cnn (with the
    reference's weights) write their PNGs; a resumed render of a finished
    checkpoint runs no chunk and writes the same image."""
    ck = str(tmp_path / "ck.npz")
    flags = ("--engine", engine, "--checkpoint", ck, "--resume",
             "--aov-normal", str(tmp_path / "n.png"))
    assert run(box, tmp_path, *flags, "--denoiser", "atrous",
               out="a.png") == 0
    assert os.path.exists(ck)
    assert run(box, tmp_path, *flags, "--denoiser", "cnn", "--unet-weights",
               str(UNET), out="c.png") == 0
    assert run(box, tmp_path, *flags, "--denoiser", "atrous",
               out="a2.png") == 0
    imgs = {k: read_png(str(tmp_path / k))
            for k in ("a.png", "c.png", "a2.png", "n.png")}
    assert all(v.shape == (8, 12, 3) for v in imgs.values())
    np.testing.assert_array_equal(imgs["a.png"], imgs["a2.png"])
    assert imgs["a.png"].mean() > 0
