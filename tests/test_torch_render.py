"""The port's slice as a whole: render loop, film and CLI.

`rene_tpu_torch.render.render(device="cpu")` against
`rene_tpu.render.render(engine="pallas")` (the interpret-mode megakernel
on the CPU, parallelogram fusion off): the same chunk seeds, the same
per-lane streams, so the images agree per pixel. Tolerances and their
reason as in test_torch_mega_path.py: >= 97% of color pixels within rtol
1e-3 (atol 1e-5), >= 99% of normal and albedo pixels within 1e-4, image
means within 1e-3 relative, ray totals within 0.1%.
"""
import numpy as np
import pytest
import torch

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu_torch import checks, cli, scenes
from rene_tpu_torch.render import render
from rene_tpu_torch.utils.film import read_png, save_png

torch.set_num_threads(2)


def _scene(name, w=128, h=64):
    return create_scene(parse_pbrt(getattr(scenes, name)(w, h)), "/tmp")


def _check_images(out, ref):
    c, rc = out["color"], ref["color"]
    assert c.shape == rc.shape == (64, 128, 3)
    assert np.isclose(c, rc, rtol=1e-3, atol=1e-5).all(-1).mean() >= 0.97
    assert abs(c.mean() - rc.mean()) <= 1e-3 * abs(rc.mean())
    for k in ("normal", "albedo"):
        assert (np.abs(out[k] - ref[k]) <= 1e-4).all(-1).mean() >= 0.99, k
    assert abs(out["total_rays"] - ref["total_rays"]) \
        <= 1e-3 * ref["total_rays"]


@pytest.mark.parametrize("name,spp,seed", [("cornell_box", 3, 5),
                                           ("materials_scene", 2, 11)])
def test_render_matches_jax_pallas_engine(name, spp, seed, monkeypatch):
    monkeypatch.setenv("RENE_QUAD_FUSE", "0")
    monkeypatch.delenv("RENE_MF_DIST", raising=False)
    from rene_tpu.render import render as jax_render
    ref = jax_render(_scene(name), spp=spp, seed=seed, engine="pallas")
    out = render(_scene(name), spp=spp, seed=seed, device="cpu")
    _check_images(out, ref)
    assert out["launches"] == 0
    assert np.isfinite(out["color"]).all()


def test_cli_writes_png_and_aovs(tmp_path):
    scene = tmp_path / "cornell.pbrt"
    scene.write_text(scenes.cornell_box(24, 16))
    paths = [tmp_path / n for n in ("c.png", "n.png", "a.png")]
    rc = cli.main([str(scene), "--device", "cpu", "--spp", "2", "--seed",
                   "3", "--output", str(paths[0]), "--aov-normal",
                   str(paths[1]), "--aov-albedo", str(paths[2])])
    assert rc == 0
    imgs = [read_png(p) for p in paths]
    for img in imgs:
        assert img.shape == (16, 24, 3) and img.dtype == np.uint8
    assert imgs[0].mean() > 0 and imgs[2].mean() > 0


def test_png_writer_round_trip(tmp_path):
    from PIL import Image
    img = np.random.default_rng(0).integers(0, 256, (7, 13, 3), np.uint8)
    path = save_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    assert save_png(str(tmp_path / "y.exr"), img).endswith("y.exr.png")


@pytest.mark.cuda
def test_render_on_card_matches_cpu():
    """On a CUDA card: the kernel-driven render against the plain one, at
    the card's image-mean limit (FMA contraction flips rare branches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    out = render(_scene("cornell_box"), spp=3, seed=5, device="cuda")
    ref = render(_scene("cornell_box"), spp=3, seed=5, device="cpu")
    assert out["launches"] == 1
    assert abs(out["color"].mean() - ref["color"].mean()) \
        <= checks.CARD_MEAN_REL * ref["color"].mean()
