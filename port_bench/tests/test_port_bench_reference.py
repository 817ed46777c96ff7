"""The benchmark's frozen reference against the port's plain CPU path.

On a tiny film of the benchmark's Cornell box, and of the port's fog
mesh scene (volpath over meshes and instances, which the reference
renders for the cells to come), the reference's film at a set of pixels
(its own frontend and tables, its plain lanes, casting against every
triangle, and with the plain BVH walk in its place) equals the film
that rene_tpu_torch.render.render gives on the CPU, which runs the
kernels' plain versions. Only the tests import both packages.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from port_bench.reference import render as R
from port_bench.scenes import cornell_box
from rene_tpu_torch.render import render
from rene_tpu_torch.scene import load_scene
from rene_tpu_torch.scenes import fog_mesh_scene

CASES = {"cornell": (lambda: cornell_box.scene(16, 12), 130),
         "fog_mesh": (lambda: fog_mesh_scene(12, 8, small=True), 3)}


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    paths = {}
    for name, (make, _) in CASES.items():
        paths[name] = os.path.join(d, f"{name}.pbrt")
        with open(paths[name], "w") as f:
            f.write(make())
    return paths


@pytest.mark.parametrize("brute", [False, True], ids=["walk", "brute"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_equals_port_plain_path(scene_files, name, brute,
                                          monkeypatch):
    if not brute:
        monkeypatch.setattr(R, "brute_walk", contextlib.nullcontext)
    spp = CASES[name][1]
    seed = 2 ** 33 + 77
    out = render(load_scene(scene_files[name]), spp=spp, seed=seed,
                 device="cpu")
    tabs = R.load_tables(scene_files[name], "cpu")
    w, h = tabs["width"], tabs["height"]
    pix = np.array([0, 5, 17, 40, 41, w * h - 1])
    ref = R.film_pixels(tabs, spp, [(seed, pix)])
    for key in ("color", "normal", "albedo"):
        prog = out[key][h - 1 - pix // w, pix % w]
        np.testing.assert_array_equal(prog, ref[key][0])
    assert ref["rays"] > 0


def test_chunk_plan_follows_the_chunk_loop():
    plan = R.chunk_plan(1024, 1, 5)
    assert [n for _, n in plan] == [100] * 10 + [24]
    seeds = np.random.default_rng(5).integers(0, 2 ** 31, 11,
                                              dtype=np.int32)
    assert [s for s, _ in plan] == [int(s) for s in seeds]
    assert [n for _, n in R.chunk_plan(64, 4, 5)] == [16]


def test_count_ops_reads_the_plain_walk(scene_files):
    tabs = R.load_tables(scene_files["fog_mesh"], "cpu")
    work = R.count_ops(tabs, 4, 1, 32)
    assert work["rays"] > 0 and work["ops"] > 0
    assert work["box"] > 0 and work["tri"] > 0 and work["closest"] > 0
    assert work["table_bytes"] > 0


def test_bfloat16_films_differ_from_float32(scene_files):
    tabs = R.load_tables(scene_files["cornell"], "cpu")
    pix = np.arange(0, 192, 3)
    ref, ctl = R.film_pixels(tabs, 8, [(3, pix)],
                             film_dtypes=(torch.float32, torch.bfloat16))
    assert not np.array_equal(ref["color"][0], ctl["color"][0])
