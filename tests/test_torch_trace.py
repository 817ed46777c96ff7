"""The port's spans (rene_tpu_torch/trace.py) on the CPU: off outside a
profiler, on inside one; the chunk loop's spans nested as the benchmark's
readers expect; films and counts the same with the profiler on and off;
the CLI's `--trace PATH`."""
import json

import numpy as np
import pytest
import torch

from rene_tpu_torch import cli, scenes, trace
from rene_tpu_torch import render as R
from rene_tpu_torch.scene import load_scene

SPP = 3     # with want_var, chunks of one sample: three chunks an image


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    p = tmp_path_factory.mktemp("trace") / "box.pbrt"
    p.write_text('Integrator "path" "integer maxdepth" [ 3 ]\n'
                 + scenes.cornell_box(8, 6))
    return p


def spans_of(path):
    """(start, end, name) of the `rene.` spans of a Chrome trace, by start:
    the host's (on a card each also shows on the device's timeline)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("rene."))


def inside(spans, outer, prefix):
    """The spans named `prefix...` that lie within the span `outer`."""
    s, t, _ = outer
    return [x for x in spans if x is not outer and x[2].startswith(prefix)
            and s <= x[0] and x[1] <= t]


def test_span_is_the_shared_no_op_outside_a_profiler():
    assert not trace.active()
    assert trace.span("rene.loop.image") is trace.OFF
    with trace.span("rene.loop.image") as s:
        assert s is None


def test_profiler_check_sees_an_active_profiler():
    """Fails if torch's check of an active profiler stops seeing one (a
    torch upgrade that moves it): the spans would silently vanish."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert trace.active()
        assert isinstance(trace.span("rene.test.on"),
                          torch.profiler.record_function)
        with trace.span("rene.test.on"):
            pass
    assert not trace.active()
    assert [e.name for e in prof.events()].count("rene.test.on") == 1


@pytest.mark.parametrize("engine", ["pallas", "wave", "xla"])
def test_loop_spans_nest_and_films_are_unchanged(box, tmp_path, engine):
    """Each rene.loop.image holds one rene.loop.chunk per chunk, then one
    readback and one film, in that order, and one wait, in the readback:
    with neither `progress` nor `checkpoint` no chunk waits (a chunk
    holds, for the wave, its phases, init first and finish last); the
    films, varmean, ray count and launches are those of the render
    without the profiler, bit for bit."""
    scene = load_scene(str(box))
    kw = dict(spp=SPP, seed=4, device="cpu", want_var=True, engine=engine)
    off = R.render(scene, **kw)
    path = tmp_path / "t.json"
    with trace.profiled(path):
        on = R.render(scene, **kw)
    for k in ("color", "normal", "albedo", "varmean"):
        assert np.array_equal(on[k], off[k]), k
    assert on["total_rays"] == off["total_rays"]
    assert on["launches"] == off["launches"]

    spans = spans_of(path)
    images = [x for x in spans if x[2] == "rene.loop.image"]
    assert len(images) == 1
    parts = [x for x in inside(spans, images[0], "rene.loop.")
             if x[2] != "rene.loop.wait"]
    assert [x[2] for x in parts] == (["rene.loop.chunk"] * SPP
                                     + ["rene.loop.readback",
                                        "rene.loop.film"])
    for a, b in zip(parts, parts[1:]):
        assert a[1] <= b[0]
    waits = inside(spans, images[0], "rene.loop.wait")
    assert len(waits) == 1
    assert inside(spans, parts[SPP], "rene.loop.wait") == waits
    for chunk in parts[:SPP]:
        assert inside(spans, chunk, "rene.loop.") == []
        if engine == "wave":
            phases = [x[2] for x in inside(spans, chunk, "rene.wave.")]
            assert phases[0] == "rene.wave.init"
            assert phases[-1] == "rene.wave.finish"
            assert set(phases[1:-1]) == {"rene.wave.step", "rene.wave.sort"}
        if engine == "xla":
            assert [x[2] for x in inside(spans, chunk, "rene.xla.")] == \
                ["rene.xla.tile"]


def test_cli_trace_writes_the_whole_run(box, tmp_path):
    path = tmp_path / "run.json"
    assert cli.main([str(box), "--device", "cpu", "--spp", "2", "--output",
                     str(tmp_path / "o.png"), "--trace", str(path)]) == 0
    names = {x[2] for x in spans_of(path)}
    assert {"rene.frontend.load", "rene.tables.pack", "rene.tables.bvh",
            "rene.tables.upload", "rene.loop.image", "rene.loop.chunk",
            "rene.loop.readback", "rene.loop.film",
            "rene.post.png"} <= names
    assert (tmp_path / "o.png").exists()


def test_cli_trace_refuses_several_devices(box, tmp_path):
    path = tmp_path / "run.json"
    assert cli.main([str(box), "--device", "cpu", "--spp", "2", "--devices",
                     "2", "--output", str(tmp_path / "o.png"), "--trace",
                     str(path)]) == 1
    assert not path.exists()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_card_launch_spans_and_films_are_unchanged(card, box, tmp_path):
    """On the card: one rene.launch span per kernel launch, and the films
    and counts of the render without the profiler, bit for bit."""
    scene = load_scene(str(box))
    kw = dict(spp=SPP, seed=4, device="cuda", want_var=True)
    off = R.render(scene, **kw)
    path = tmp_path / "t.json"
    with trace.profiled(path):
        on = R.render(scene, **kw)
    for k in ("color", "normal", "albedo", "varmean"):
        assert np.array_equal(on[k], off[k]), k
    assert (on["total_rays"], on["launches"]) == (off["total_rays"],
                                                   off["launches"])
    launches = [x for x in spans_of(path) if x[2].startswith("rene.launch.")]
    assert len(launches) == on["launches"] == SPP


@pytest.mark.cuda
def test_card_wave_split_and_spans_share_their_phases(card, box, tmp_path):
    """The wave's CUDA-event split and its spans come from one helper:
    the same phases, init first and finish last."""
    from rene_tpu_torch.integrators.wave import make_wave_fn
    from rene_tpu_torch.scene import build_device_scene
    bn, cfg = build_device_scene(load_scene(str(box)))
    run = make_wave_fn(bn, cfg, "cuda", spp_hint=4)
    run.run_dev(3, 4)
    split = {}
    path = tmp_path / "t.json"
    with trace.profiled(path):
        run.run_dev(5, 4, split=split)
    phases = [x[2][len("rene.wave."):] for x in spans_of(path)
              if x[2].startswith("rene.wave.")]
    assert set(split) == set(phases) == {"init", "sort", "step", "finish"}
    assert all(ms >= 0.0 for ms in split.values())
    assert phases[0] == "init" and phases[-1] == "finish"
