"""The Cornell smoke cell (`cornell_smoke.final`) on the CPU, at a tiny film.

The scene of *Ray Tracing: The Next Week* (port_bench/scenes/
cornell_smoke.py) is what the configuration says: 36 immediate triangles
(six wall and light quads, two boxes of 12 None triangles), 2 of them
emissive, and two homogeneous media of density 0.01, one absorbing and
one scattering, which `auto` renders through the immediates volpath
megakernel. At 16x16 the frozen reference's film equals the port's plain
CPU path bit for bit, at depth 50; a whole run is correct, the three
broken runners of test_port_bench_faults.py are not, and the bfloat16
control fails the cell's limits.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from port_bench import check, harness
from port_bench.reference import render as R
from port_bench.scenes import cornell_smoke
from rene_tpu_torch import kernels, render
from rene_tpu_torch.integrators.mega_path import device_tables
from rene_tpu_torch.scene import build_device_scene, load_scene
from rene_tpu_torch.scene import pack as P

from pb_support import run_tiny
from test_port_bench_faults import altered, half_batch, unchanged

CELL = "cornell_smoke.final"
TINY = {"width": 16, "height": 16}
SPP = 4


def tiny_cell(spp: int = SPP) -> harness.Cell:
    """The cell with its scene cut to TINY, `spp` samples an image and 64
    pixels an image checked; its limits as they are."""
    cell = harness.load_cell(CELL)
    cell.config["scene"]["args"] = dict(TINY)
    cell.traffic["spp"] = spp
    cell.check["pixels_per_image"] = 64
    return cell


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("smoke"), "scene.pbrt")
    with open(path, "w") as f:
        f.write(cornell_smoke.scene(**TINY))
    return path


def test_scene_is_the_books(scene_file):
    """36 immediate triangles, 2 emissive, two media of sigma_t 0.01 with
    albedo 0 (black smoke) and 1 (white smoke), the film and depth of the
    configuration, and the immediates volpath megakernel under `auto`."""
    cell = harness.load_cell(CELL)
    assert cell.config["scene"]["args"] == {"width": 600, "height": 600}
    assert cell.traffic["spp"] == 200 and cell.traffic["engine"] == "auto"
    buffers_np, config = build_device_scene(load_scene(scene_file))
    assert config.integrator == "volpath"
    assert render._runner("auto", buffers_np, config) == "megakernel"
    tabs = device_tables(P.pack_tables(buffers_np, config), "cpu")
    assert kernels.variant(tabs) == "mega_volpath"
    assert tabs["max_depth"] == 50 and not tabs["use_rr"]
    assert tabs["tris"].shape[0] == 36 and tabs["spheres"].shape[0] == 0
    assert tabs["emit_tris"].shape[0] == 2
    med = tabs["media"].double()
    assert med[0, P.MED_VAC] == 1.0
    sigma_t = med[1:, P.MED_ST:P.MED_ST + 3]
    torch.testing.assert_close(sigma_t, torch.full_like(sigma_t, 0.01))
    albedo = med[1:, P.MED_SS:P.MED_SS + 3] / sigma_t
    assert albedo[:, 0].tolist() == [0.0, 1.0]
    assert (med[1:, P.MED_G] == 0.0).all()


@pytest.mark.parametrize("brute", [False, True], ids=["walk", "brute"])
def test_reference_equals_port_plain_path(scene_file, brute, monkeypatch):
    if not brute:
        monkeypatch.setattr(R, "brute_walk", contextlib.nullcontext)
    seed = 2 ** 33 + 77
    out = render.render(load_scene(scene_file), spp=SPP, seed=seed,
                        device="cpu")
    tabs = R.load_tables(scene_file, "cpu")
    w, h = tabs["width"], tabs["height"]
    pix = np.array([0, 5, 17, 40, 41, 130, 201, w * h - 1])
    ref = R.film_pixels(tabs, SPP, [(seed, pix)])
    for key in ("color", "normal", "albedo"):
        prog = out[key][h - 1 - pix // w, pix % w]
        np.testing.assert_array_equal(prog, ref[key][0])
    assert ref["rays"] > 0


def test_sound_run_is_correct():
    res = run_tiny(tiny_cell())
    assert res["correct"] is True
    assert res["attempted"] >= 1
    assert all(v["value"] == 0.0 for v in res["checks"].values())


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=["unchanged", "half_batch", "altered"])
def test_fault_is_not_correct(fault):
    res = run_tiny(tiny_cell(), wrap_runner=fault)
    assert res["correct"] is False


def test_control_fails_the_limits(scene_file):
    """The control at the tiny film, with the cell's own limits."""
    tabs = R.load_tables(scene_file, "cpu")
    npix = tabs["width"] * tabs["height"]
    images = check.images_for(5, [0, 1], npix, 64)
    ref, ctl = R.film_pixels(tabs, SPP, images,
                             (torch.float32, torch.bfloat16))
    ctl_kept = [np.concatenate([ctl[k][i] for k in
                                ("color", "normal", "albedo")], 1)
                for i in range(2)]
    values = check.compare(ctl_kept, ref)
    limits = harness.load_cell(CELL).check["limits"]
    assert any(values[k] > limits[k] for k in limits), values
